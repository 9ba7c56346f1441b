"""Attribute the end-to-end gap: host packing vs the dispatch path.

    python -m fastdet_tpu_torch.tools.probe_hostcpu [--frames 240]
        [--batch 24] [--inflight 3]

The port of the JAX package's ``tools/probe_hostcpu.py``. On one warmed
int8 engine (the bench's model of :data:`ARCH`, buckets (1, batch),
calibrated on the bench frames), ``--inflight`` batches deep:

  full      detect_async_sparse per batch (entropy decode + pack, the
            copy to the card, kernel B1, the net, the fetch)
  prepack   ONE staged batch re-dispatched in a loop (copy + card work +
            fetch, no host pack)
  packonly  entropy decode + pack per batch, nothing dispatched (host CPU)

If prepack >> full and packonly's cadence ~ full's, the host's packing
is the wall, not the card. ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque

import numpy as np

ARCH = ("full", 80)


def build_engine(batch: int, device):
    """The probes' engine: int8, buckets (1, batch), the bench's model
    and calibration frames."""
    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params, _kind = bench.load_bench_model(*ARCH)
    return DetectionEngine(spec, params, mode="int8", buckets=(1, batch),
                           calibration_images=bench.bench_calibration(),
                           device=device)


def stage_prepacked(eng, jpegs, thr_all):
    """``bench.stage_prepacked``, which the frames must fit: (layout,
    idxs, packed rows, thresholds, the engine's sparse program's prefix)."""
    from fastdet_tpu_torch import bench

    staged = bench.stage_prepacked(eng, jpegs, thr_all)
    if staged is None:
        raise RuntimeError("the frames do not ride one std-tier sparse "
                           "group")
    return staged


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "probe_hostcpu")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--inflight", type=int, default=3)
    args = ap.parse_args(argv[1:])
    b = args.batch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod

    print(bench.card_line(device_mod.resolve(device)))
    eng = build_engine(b, device)
    try:
        eng.warmup()
        eng.wait_warm()   # no background warm-up under the timed runs
        jpegs = bench.make_jpegs(b)
        thrs = [0.1] * b
        n_batches = args.frames // b

        def run(tag, submit):
            q = deque()
            eng.fetch(submit(), b)   # warm
            t0 = time.perf_counter()
            for _ in range(n_batches):
                q.append(submit())
                if len(q) >= args.inflight:
                    eng.fetch(q.popleft(), b)
            while q:
                eng.fetch(q.popleft(), b)
            dt = time.perf_counter() - t0
            print(f"{tag:9s} {n_batches * b / dt:7.1f} f/s "
                  f"({dt / n_batches * 1e3:6.1f} ms/batch)", flush=True)

        run("full", lambda: eng.detect_async_sparse(jpegs, thrs))

        # prepack: stage once, re-dispatch the same rows
        thr_all = np.asarray(thrs, np.float32)
        _, idxs, packed, _, fn = stage_prepacked(eng, jpegs, thr_all)
        run("prepack",
            lambda: bench.submit_prepacked(eng, fn, packed, idxs))

        # packonly: host work with nothing dispatched
        groups = bench.layout_groups(eng, jpegs)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            _, jobs = eng._stage_sparse(jpegs, thr_all, groups, "std")
            eng._run_sparse_jobs(jobs)
        dt = time.perf_counter() - t0
        print(f"packonly  {n_batches * b / dt:7.1f} f/s "
              f"({dt / n_batches * 1e3:6.1f} ms/batch)  [host CPU only]")
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
