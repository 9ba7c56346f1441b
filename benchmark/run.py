"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Prints diagnostics on standard error (the
card, set-up, the window's counts, the generator's lateness, the
program's batches and ingest, the reference), then the numbers compared
for ``correct`` beside their limits as its last lines; the last line of
standard output is the result object. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
run. Exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for) and when JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"needs {need} CUDA device(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, "
                    f"device_count {torch.cuda.device_count()}")
        return 1
    result, _ = harness.run_cell(bench, HERE, ROOT, args.workload, args.seed,
                              args.seconds, bool(args.trace),
                              device="cuda:0")
    found = harness.jax_modules()
    if found:
        harness.log("loaded in this process after the window: "
                    + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
