"""cProfile the two host legs of the sparse serving path.

    python -m fastdet_tpu_torch.tools.profile_legs [--batches 8] [--batch 24]

The port of the JAX package's ``tools/profile_legs.py``. On one int8
engine (``probe_hostcpu.build_engine``: no warm-up, each leg warms what
it runs):

  packonly  entropy decode + row staging, nothing dispatched
  prepack   ONE staged batch run on this thread in a loop: the pinned
            copy to the card, the engine's sparse program (kernel B1,
            the net, postprocess) and the fetch of its (packed, wire)
            pair; all its Python time is the dispatch path

Each leg prints the top of its profile by cumulative time.
``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys

import numpy as np

LINES = 18   # rows of each profile table


def report(pr, tag, lines=LINES):
    s = io.StringIO()
    st = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    st.print_stats(lines)
    print(f"===== {tag} =====")
    # keep only the table body
    out = s.getvalue().splitlines()
    start = next(i for i, l in enumerate(out) if "ncalls" in l)
    print("\n".join(out[start:start + lines + 1]))


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "profile_legs")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=24)
    args = ap.parse_args(argv[1:])
    b = args.batch

    import torch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.tools import probe_hostcpu

    dev = device_mod.resolve(device)
    print(bench.card_line(dev))
    eng = probe_hostcpu.build_engine(b, device)
    try:
        jpegs = bench.make_jpegs(b)
        thr_all = np.asarray([0.1] * b, np.float32)
        groups = bench.layout_groups(eng, jpegs)

        # leg 1: packonly
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(args.batches):
            _, jobs = eng._stage_sparse(jpegs, thr_all, groups, "std")
            eng._run_sparse_jobs(jobs)
        pr.disable()
        report(pr, f"packonly x{args.batches} (b={b})")

        # leg 2: prepack, on this thread (not through the transfer worker,
        # so the profile sees the dispatch path)
        _, _, packed, _, fn = probe_hostcpu.stage_prepacked(eng, jpegs,
                                                            thr_all)
        dev0 = eng.devices[0]

        def once():
            res = eng._run_program(fn, eng._to_device(packed, dev0))
            return [t.cpu() for t in res]

        with torch.inference_mode():
            once()   # warm
            pr = cProfile.Profile()
            pr.enable()
            for _ in range(args.batches):
                once()
            pr.disable()
        report(pr, f"prepack x{args.batches} (b={b}) [sync, on-thread]")
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
