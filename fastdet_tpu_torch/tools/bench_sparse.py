"""A/B the ingest routes on the card: sparse vs planes vs pixels.

    python -m fastdet_tpu_torch.tools.bench_sparse [--batch 8] [--iters 30]
        [--fixture testdata/scene1.jpg]

The port of the JAX package's ``tools/bench_sparse.py``. One bf16
engine at bucket ``--batch`` on the bench's model (``bench.load_bench_model``
of :data:`ARCH`: ``detect80_full.npz`` for full:80) serves ``--batch``
copies of the fixture through each route: packed sparse rows (kernel
B1), 4:2:0 planes (kernel B2) and host-decoded pixels. It prints the
row bytes each route sends to the card, then each route's batch wall
(dispatch and fetch in lockstep), then the host's staging cost per route
(no card work). ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARCH = ("full", 80)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "bench_sparse")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--fixture",
                    default=os.path.join(REPO, "testdata", "scene1.jpg"))
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.runtime import jpeg, native_jpeg
    from fastdet_tpu_torch.runtime.engine import (DetectionEngine,
                                                  sparse_row_bytes)

    dev = device_mod.resolve(device)
    print(bench.card_line(dev))
    spec, params, _kind = bench.load_bench_model(*ARCH)
    engine = DetectionEngine(spec, params, mode="bf16", buckets=(args.batch,),
                             device=device)
    try:
        engine.warmup()
        engine.wait_warm()   # every route warm, as the JAX warmup leaves it
        with open(args.fixture, "rb") as fp:
            data = fp.read()
        jpegs = [data] * args.batch
        thrs = [0.1] * args.batch

        w, h, hs, vs = native_jpeg.scan_layout(data)
        tier = sparse_tier(engine, jpegs)
        if tier is None:
            print("fixture overflows both sparse tiers (plane path serves "
                  "it); host-sparse staging is skipped")
        caps = engine._sparse_caps((hs, vs), tier or "std")
        row = sparse_row_bytes(caps)
        planes_bytes = h * w + 2 * (h // vs) * (w // hs)
        print(f"layout={hs}{vs} tier={tier} sparse_row={row}B "
              f"planes_row={planes_bytes}B "
              f"pixels_row={h*w*3}B ratio={planes_bytes/row:.2f}x")

        def timed(label, dispatch):
            engine.fetch(dispatch(), args.batch)   # warm
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                res = dispatch()
                engine.fetch(res, args.batch)
                ts.append(time.perf_counter() - t0)
            ts = np.array(ts) * 1000
            per_frame = np.median(ts) / args.batch
            print(f"{label:10s} p50={np.median(ts):7.1f} ms/batch "
                  f"({per_frame:5.2f} ms/frame, {1000/per_frame:6.1f} f/s "
                  f"lockstep)")

        timed("sparse", lambda: engine.detect_async_sparse(jpegs, thrs))
        timed("planes", lambda: engine.detect_async_planes(jpegs, thrs))
        imgs = [jpeg.decode_rgb(d) for d in jpegs]
        timed("pixels", lambda: engine.detect_async(imgs, thrs))

        # host-side staging cost only (no card work)
        host_rows = []
        if tier is not None:
            host_rows.append(
                ("host sparse", lambda: stage_sparse(engine, jpegs, tier)))
        host_rows += [
            ("host planes",
             lambda: [native_jpeg.decode_planes(d) for d in jpegs]),
            ("host pixels", lambda: [jpeg.decode_rgb(d) for d in jpegs]),
        ]
        for label, fn in host_rows:
            fn()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            dt = (time.perf_counter() - t0) / args.iters * 1000
            print(f"{label:12s} {dt:6.2f} ms/batch "
                  f"({dt/args.batch:5.3f} ms/frame)")
    finally:
        engine.close()
    return 0


def sparse_tier(engine, jpegs):
    """The capacity tier these frames ride (std, then dense), or None when
    they overflow both (the plane path would serve them)."""
    from fastdet_tpu_torch import bench

    thr = np.full((len(jpegs),), 0.5, np.float32)
    groups = bench.layout_groups(engine, jpegs)
    for tier in ("std", "dense"):
        _, jobs = engine._stage_sparse(jpegs, thr, groups, tier)
        overflow, _ = engine._run_sparse_jobs(jobs)
        if not overflow:
            return tier
    return None


def stage_sparse(engine, jpegs, tier):
    """The engine's own staging on ``tier``: row allocation, then the
    entropy decode into the packed views. Returns the staged groups."""
    from fastdet_tpu_torch import bench

    thr = np.full((len(jpegs),), 0.5, np.float32)
    staged, jobs = engine._stage_sparse(jpegs, thr,
                                        bench.layout_groups(engine, jpegs),
                                        tier)
    overflow, _ = engine._run_sparse_jobs(jobs)
    if overflow:
        raise RuntimeError(f"the fixture overflows the {tier} tier "
                           f"mid-benchmark")
    return staged


if __name__ == "__main__":
    sys.exit(main(sys.argv))
