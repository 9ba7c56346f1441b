"""A/B the multi-client serving section across server-side shapes.

    python -m fastdet_tpu_torch.tools.ab_serving [--passes 3] [--clients 8]
        [--per-client 48]

The port of the JAX package's ``tools/ab_serving.py``: which engine
bucket set and client window should multi-client serving run? A larger
bucket ships a larger copy per dispatch, and serving clients refill
their windows only on answers, so larger buckets may starve supply where
the batched bench's dedicated producer does not. Each pass serves every
variant of :data:`VARIANTS` (name, int8 engine buckets, client window)
in turn: a loopback server over a fresh ``ModelService`` of the
variant's engine (the bench's model of :data:`ARCH`), an untimed pass of
:data:`WARM_PER_CLIENT` frames a client, then the timed pass. The
clients run in a separate process with no card visible
(``tools/client_load``), so their interpreter lock stays out of the
server's number. Prints each pass's frames/s, average batch and errors,
then each variant's median over passes. ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import sys

ARCH = ("full", 80)
VARIANTS = (
    ("b16/w4", (1, 8, 16), 4),
    ("b24/w6", (1, 8, 16, 24), 6),
    ("b24/w4", (1, 8, 16, 24), 4),
)
WARM_PER_CLIENT = 12
THRESHOLD = 0.1


def run_clients(port, n_clients, per_client, window):
    """Drive the load from a separate process (tools/client_load): client
    threads in this process would share the interpreter lock with the
    server's event loop. Returns (wall s, errors); raises when the load
    process fails."""
    from fastdet_tpu_torch.tools import client_load

    out = client_load.run_in_subprocess(
        port, path="full", clients=n_clients, per_client=per_client,
        window=window, threshold=THRESHOLD)
    if "error" in out:
        raise RuntimeError(out["error"])
    return out["wall_s"], out["errors"]


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "ab_serving")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--per-client", type=int, default=48)
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import ModelService

    print(bench.card_line(device_mod.resolve(device)))
    spec, params, _kind = bench.load_bench_model(*ARCH)

    engines = {}
    try:
        for _name, buckets, _w in VARIANTS:
            if buckets not in engines:
                e = DetectionEngine(
                    spec, params, mode="int8", buckets=buckets,
                    calibration_images=bench.bench_calibration(),
                    device=device)
                engines[buckets] = e
                e.warmup()
                e.wait_warm()

        results = {name: [] for name, _, _ in VARIANTS}
        for p in range(args.passes):
            for name, buckets, window in VARIANTS:
                # a fresh service for each server: a service's queue binds
                # to the first event loop that waits on it
                svc = ModelService(engines[buckets], name="full")
                with bench.serving({"full": svc}) as server:
                    # warm-up pass (sessions + first hits of each bucket)
                    run_clients(server.bound_port, args.clients,
                                WARM_PER_CLIENT, window)
                    b0, f0 = svc.batches, svc.frames
                    wall, errs = run_clients(server.bound_port, args.clients,
                                             args.per_client, window)
                fps = args.clients * args.per_client / wall
                ab = (svc.frames - f0) / max(1, svc.batches - b0)
                results[name].append(fps)
                print(f"pass {p} {name}: {fps:.1f} f/s avg_batch {ab:.2f} "
                      f"errors={errs}", flush=True)
    finally:
        for e in engines.values():
            e.close()

    print("\nsummary (median over passes):")
    for name, vals in results.items():
        vals = sorted(vals)
        med = vals[len(vals) // 2]
        print(f"  {name}: {med:.1f} f/s  (all: {[round(v, 1) for v in vals]})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
