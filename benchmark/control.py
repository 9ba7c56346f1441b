"""Readings for the limits of ``correct``: the comparison's numbers over
several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
        [--seconds 5] [--mode int8]

``--mode int8`` runs the lower-precision control: the program's own int8
path (``-m int8``) in place of the configuration's bf16, at the cell's
own traffic and sizes, which has to come out not correct; ``--mode
bf16`` reads the program as configured. Prints one JSON line per seed
(the numbers and the verdict against the cell's limits) and a last line
with the largest of each number over the seeds. Needs the card.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", default="int8")
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.run import _cache_dirs

    _cache_dirs()
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 1
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    worst: dict = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        result, numbers = harness.run_cell(
            bench, HERE, ROOT, args.workload, seed, args.seconds, False,
            device="cuda:0", mode=args.mode)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": result["correct"],
                          "failed": result["failed"], **numbers}),
              flush=True)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
