"""Device time of the serving pipeline by kind, from a torch.profiler trace.

    python -m fastdet_tpu_torch.tools.profile_device [--mode int8]
        [--batch 16] [--iters 8] [--arch full] [--top N] [--json-out F]

The port of the JAX package's ``tools/profile_device.py``.
:func:`profile_engine` traces ``iters`` sparse-path batches with
``utils.profiling.device_trace`` (a Chrome trace) and sums the device
events only (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) into
buckets by name (:func:`_bucket`):

- ``ingest-kernel``: the port's CUDA kernels (B1 ``sparse_tile_kernel``,
  B2 ``plane_ingest_kernel``, D1/D2 ``ingest_stages_kernel`` /
  ``nat_gated_kernel``);
- ``conv/matmul``: cuDNN, CUTLASS and cuBLAS convolutions and GEMMs,
  ``torch._int_mm``'s included;
- ``postprocess``: sort, top-k and radix kernels;
- ``layout/copy``: copies, sets and cuDNN's layout transposes;
- ``other``: everything else (elementwise, reductions, ...).

``total_ms_per_batch`` is the SUM of the device events' durations per
batch. ``busy_ms_per_batch`` is the time in which at least one device
event ran (the union of their intervals): on one stream of one card the
two agree; where streams overlap (a dp engine's shards, the background
warm-up) the sum exceeds it. ``busy_share`` is the busy time over the
traced wall (host clock around the traced batches, each fetched, then a
synchronize), as ``chip_smoke.py``'s profile of one batch reports it;
``launches_per_batch`` counts kernel events.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
INGEST_KERNELS = ("sparse_tile_kernel", "plane_ingest_kernel",
                  "ingest_stages_kernel", "nat_gated_kernel")
_CONV = ("gemm", "fprop", "dgrad", "wgrad", "convolve", "conv2d",
         "cutlass", "xmma", "cudnn")


def _bucket(name: str, category: str = "") -> str:
    """The bucket of one device event, by its name and trace category."""
    n = name.lower()
    if (category in ("gpu_memcpy", "gpu_memset") or "memcpy" in n
            or "memset" in n or "nchwtonhwc" in n or "nhwctonchw" in n):
        return "layout/copy"
    if any(k in n for k in INGEST_KERNELS):
        return "ingest-kernel"
    if "sort" in n or "topk" in n or "radix" in n:
        return "postprocess"
    if any(k in n for k in _CONV):
        return "conv/matmul"
    return "other"


def _load_trace_events(trace_dir: str):
    paths = glob.glob(os.path.join(trace_dir, "*.json"))
    if not paths:
        raise RuntimeError(f"no trace written under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as fp:
        return json.load(fp).get("traceEvents", [])


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy


def profile_engine(eng, jpegs, thrs, iters: int = 8) -> dict:
    """Trace ``iters`` sparse-path batches of ``jpegs`` and bucket the
    device time. Returns {"buckets": {name: ms per batch}, "top_ops",
    "total_ms_per_batch", "device_only_fps", "busy_ms_per_batch",
    "wall_ms_per_batch", "busy_share", "launches_per_batch",
    "trace_dir"} (the caller owns the trace directory)."""
    import torch

    from fastdet_tpu_torch.utils.profiling import device_trace

    batch = len(jpegs)
    cuda = [d for d in eng.devices if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    for _ in range(3):  # warm every program and transfer path
        eng.fetch(eng.detect_async_sparse(jpegs, thrs), batch)
    sync()

    trace_dir = tempfile.mkdtemp(prefix="fastdet_trace_")
    with device_trace(trace_dir):
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.fetch(eng.detect_async_sparse(jpegs, thrs), batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    buckets: dict = {}
    per_op: dict = {}
    spans = []
    total = 0.0
    launches = 0
    for e in _load_trace_events(trace_dir):
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_CATS or "dur" not in e:
            continue
        name = e.get("name", "")
        dur = float(e["dur"])
        b = _bucket(name, cat)
        buckets[b] = buckets.get(b, 0.0) + dur
        per_op.setdefault(name, [0.0, b, 0])
        per_op[name][0] += dur
        per_op[name][2] += 1
        spans.append((float(e["ts"]), float(e["ts"]) + dur))
        total += dur
        launches += cat == "kernel"
    per_batch_ms = total / 1000.0 / iters
    busy_ms = _union_us(spans) / 1000.0 / iters
    return {
        "buckets": {b: round(us / 1000.0 / iters, 3)
                    for b, us in sorted(buckets.items(),
                                        key=lambda kv: -kv[1])},
        "top_ops": [
            {"name": n[:200], "ms": round(v[0] / 1000.0 / iters, 4),
             "bucket": v[1], "count_per_batch": v[2] / iters}
            for n, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:40]
        ],
        "total_ms_per_batch": round(per_batch_ms, 3),
        "device_only_fps": (round(1000.0 * batch / per_batch_ms, 1)
                            if per_batch_ms > 0 else None),
        "busy_ms_per_batch": round(busy_ms, 3),
        "wall_ms_per_batch": round(wall_ms / iters, 3),
        "busy_share": round(busy_ms * iters / wall_ms, 4),
        "launches_per_batch": launches / iters,
        "trace_dir": trace_dir,
    }


def main(argv=None, device="cuda") -> dict:
    """Profile the bench's model on ``device`` (the card by default;
    raises without one) and print the buckets; returns the profile."""
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "profile_device")
    ap.add_argument("--mode", default="int8")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--arch", default="full")
    ap.add_argument("--top", type=int, default=0,
                    help="print the top-N individual kernels")
    ap.add_argument("--json-out", default=None,
                    help="write the whole profile to this path")
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch.bench import (bench_calibration, load_bench_model,
                                         make_jpegs)
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params, kind = load_bench_model(args.arch, 80)
    eng = DetectionEngine(spec, params, mode=args.mode, buckets=(args.batch,),
                          calibration_images=bench_calibration(),
                          device=device)
    try:
        prof = profile_engine(eng, make_jpegs(args.batch),
                              [0.3] * args.batch, args.iters)
    finally:
        eng.close()
    print(f"model={args.arch} mode={args.mode} weights={kind} "
          f"batch={args.batch} iters={args.iters}")
    total = prof["total_ms_per_batch"]
    for b, ms in prof["buckets"].items():
        print(f"  {b:16s} {ms:8.3f} ms/batch "
              f"({100 * ms / max(total, 1e-9):5.1f}%)")
    print(f"  device total     {total:8.3f} ms/batch -> "
          f"{prof['device_only_fps']} f/s device-only; busy "
          f"{prof['busy_ms_per_batch']} of {prof['wall_ms_per_batch']} ms "
          f"wall ({100 * prof['busy_share']:.1f} %), "
          f"{prof['launches_per_batch']:.0f} launches per batch")
    for op in prof["top_ops"][:args.top]:
        print(f"  {op['ms']:8.4f} ms  [{op['bucket']:>14s}] "
              f"{op['name'][:110]}")
    if args.json_out:
        with open(args.json_out, "w") as fp:
            json.dump(prof, fp, indent=1)
    print(f"trace: {prof['trace_dir']}")
    return prof


if __name__ == "__main__":
    main(sys.argv)
