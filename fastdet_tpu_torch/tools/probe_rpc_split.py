"""Split the prepack wall (copy + card + fetch) into put / exec / fetch.

    python -m fastdet_tpu_torch.tools.probe_rpc_split [--iters 6] [--sync]
        [--batch 24]

The port of the JAX package's ``tools/probe_rpc_split.py``, on the
engine's own sparse program for one staged int8 batch
(``probe_hostcpu.stage_prepacked``). Launches on the card return at
once, so every blocked leg (``--sync``) ends in
``torch.cuda.synchronize``:

  put      the engine's copy to the card (``DetectionEngine._to_device``:
           a fresh pinned host copy, then a non-blocking copy), of the
           packed rows and of the thresholds
  exec     the program on rows already on the card
  fetch    the (packed, wire) result back to the host
  chain    put + exec + fetch in one

The pipelined probes (always run) issue 24 operations and synchronize
once: the sustained cost of each. Every leg runs under
``torch.inference_mode()``, as the engine's transfer worker does.
``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

from fastdet_tpu_torch.bench import _sync

PIPE_ITERS = 24   # operations of each pipelined probe


def timeit(tag, f, iters):
    f()   # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        f()
    dt = (time.perf_counter() - t0) / iters
    print(f"{tag:28s} {dt * 1e3:7.2f} ms/iter", flush=True)
    return dt


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "probe_rpc_split")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--sync", action="store_true",
                    help="run the sync legs too")
    ap.add_argument("--batch", type=int, default=24)
    args = ap.parse_args(argv[1:])
    b = args.batch

    import torch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.tools import probe_hostcpu

    print(bench.card_line(device_mod.resolve(device)))
    # no warmup(): only the one b-bucket sparse program is needed, and
    # each leg warms its own callable before timing
    eng = probe_hostcpu.build_engine(b, device)
    try:
        jpegs = bench.make_jpegs(b)
        thr_all = np.asarray([0.1] * b, np.float32)
        _, _, packed, thr, prefix = probe_hostcpu.stage_prepacked(
            eng, jpegs, thr_all)
        fn = functools.partial(eng._run_program, prefix)
        dev = eng.devices[0]
        put = eng._to_device
        print(f"row bytes: {packed.shape[1]} x b{b} = "
              f"{packed.nbytes / 1e6:.2f} MB h2d per batch")

        with torch.inference_mode():
            if args.sync:
                def blocked(f):
                    def run():
                        out = f()
                        _sync(dev)
                        return out
                    return run

                timeit("put packed (blocked)",
                       blocked(lambda: put(packed, dev)), args.iters)
                timeit("put thr (blocked)",
                       blocked(lambda: put(thr, dev)), args.iters)
                dpacked = blocked(lambda: put(packed, dev))()
                timeit("exec resident (blocked)",
                       blocked(lambda: fn(dpacked)), args.iters)
                dres = blocked(lambda: fn(dpacked))()
                timeit("fetch result (np.asarray)",
                       lambda: [t.cpu() for t in dres], args.iters)
                timeit("full sync chain",
                       lambda: [t.cpu() for t in fn(put(packed, dev))],
                       args.iters)
            pipelined_probes(eng, fn, packed, thr)
    finally:
        eng.close()
    return 0


def pipelined_probes(eng, fn, packed, thr, iters=None):
    """Sustained cost per operation kind: issue ``iters`` operations,
    synchronize once at the end; amortized ms/op."""
    iters = PIPE_ITERS if iters is None else iters
    dev = eng.devices[0]
    put = eng._to_device

    def run(tag, issue):
        issue()   # warm
        _sync(dev)
        t0 = time.perf_counter()
        outs = [issue() for _ in range(iters)]
        _sync(dev)
        dt = (time.perf_counter() - t0) / iters
        del outs
        print(f"{tag:28s} {dt * 1e3:7.2f} ms/op (pipelined)", flush=True)

    # the JAX tool's tags (sizes at b24); the row bytes line has the truth
    run("put tiny (96B)", lambda: put(thr, dev))
    run("put packed (1.2MB)", lambda: put(packed, dev))
    dpacked = put(packed, dev)
    _sync(dev)
    run("exec resident", lambda: fn(dpacked))
    run("put+exec chain", lambda: fn(put(packed, dev)))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
