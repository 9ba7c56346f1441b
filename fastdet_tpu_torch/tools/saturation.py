"""Serving saturation study: the engine's ceiling against the server's
frames/s under a sweep of protocol clients, with the gap attributed.

    python -m fastdet_tpu_torch.tools.saturation [--clients 8,16,32,64]
        [--per-client 48] [--window 6] [--frames 192] [--mode int8]
        [--out FILE]

The port of the JAX package's ``tools/saturation.py``:

1. the engine-only batched ceiling at the largest of the bench's int8
   buckets (``bench.INT8_BUCKETS``; the bench's threaded producer,
   ``bench.BATCHED_INFLIGHT`` deep);
2. the same engine served over loopback, swept over client counts; each
   row's clients run in a separate process (``tools/client_load``, no
   card visible) after a short untimed pass, and the row records total
   fps, the clients' p50 / p99, the dispatched-batch histogram and the
   serving stage percentiles of ``utils.profiling.GLOBAL``
   (``dispatch_batch``, ``fetch_batch``, ``infer_batch``,
   ``request_e2e``), reset before the row;
3. every row bracketed by link probes; ``attribution`` sets the best
   row against the ceiling.

Prints the document (and one line per row on standard error) and writes
it only to ``--out``. ``main(argv, device="cuda")`` returns it.
"""

from __future__ import annotations

import argparse
import json
import sys

WARM_PER_CLIENT = 8
STAGES = ("dispatch_batch", "fetch_batch", "infer_batch", "request_e2e")


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "saturation")
    ap.add_argument("--clients", default="8,16,32,64")
    ap.add_argument("--per-client", type=int, default=48)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--frames", type=int, default=192,
                    help="frames for the engine-ceiling measurement")
    ap.add_argument("--mode", default="int8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import ModelService
    from fastdet_tpu_torch.tools import client_load
    from fastdet_tpu_torch.utils.profiling import GLOBAL as TIMERS

    spec, params, kind = bench.load_bench_model("full", 80)
    engine = DetectionEngine(spec, params, mode=args.mode,
                             buckets=bench.INT8_BUCKETS,
                             calibration_images=bench.bench_calibration(),
                             device=device)
    dev0 = engine.devices[0]

    def probe():
        return round(bench.probe_link_mbps(n=3, device=dev0), 1)

    try:
        engine.warmup()
        engine.wait_warm()
        doc = {"mode": args.mode, "weights": kind,
               "buckets": list(bench.INT8_BUCKETS),
               "window": args.window, "per_client": args.per_client,
               "card": bench.card_line(dev0)}

        # 1. the engine-only ceiling, the serving overlap of submit/fetch
        fixtures = bench.make_jpegs(3)
        bsz = engine.max_batch
        thrs = [bench.BENCH_THRESHOLD] * bsz

        def submit(i):
            bj = [fixtures[(i * bsz + j) % 3] for j in range(bsz)]
            res = (engine.detect_async_sparse(bj, thrs)
                   or engine.detect_async_planes(bj, thrs))
            if res is None:
                raise RuntimeError("no native ingest path for the scenes")
            return res

        bench._threaded_fps(engine, submit, 2, bsz,
                            bench.BATCHED_INFLIGHT)   # warm
        p0 = probe()
        ceiling = round(bench._threaded_fps(
            engine, submit, max(1, args.frames // bsz), bsz,
            bench.BATCHED_INFLIGHT), 1)
        doc["engine_ceiling"] = {"fps": ceiling, "batch": bsz,
                                 "probes_mbps": [p0, probe()]}

        # 2. the same engine through the protocol stack
        svc = ModelService(engine, name="full")
        rows = []
        with bench.serving({"full": svc}) as server:
            for n_clients in [int(x) for x in args.clients.split(",")]:
                def load(per_client):
                    return client_load.run_in_subprocess(
                        server.bound_port, path="full", clients=n_clients,
                        per_client=per_client, window=args.window,
                        threshold=bench.BENCH_THRESHOLD)

                load(WARM_PER_CLIENT)   # short untimed pass
                svc.batch_hist.clear()
                b0, f0 = svc.batches, svc.frames
                # this row's stage percentiles reflect this row only
                TIMERS.reset()
                pa = probe()
                out = load(args.per_client)
                pb = probe()
                stages = {k: {kk: round(vv, 2) for kk, vv in v.items()}
                          for k, v in TIMERS.snapshot().items()
                          if k in STAGES}
                row = {
                    "clients": n_clients,
                    "fps": out.get("fps"),
                    "p50_ms": out.get("p50_ms"),
                    "p99_ms": out.get("p99_ms"),
                    "frames_answered": out.get("frames"),
                    "errors": ([out["error"]] if "error" in out
                               else out.get("errors", [])),
                    "avg_batch": round((svc.frames - f0)
                                       / max(1, svc.batches - b0), 2),
                    "batch_hist": dict(sorted(svc.batch_hist.items())),
                    "stages_ms": stages,
                    "probes_mbps": [pa, pb],
                    "vs_engine_ceiling": (round(out["fps"] / ceiling, 3)
                                          if out.get("fps") else None),
                }
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
        doc["sweep"] = rows
    finally:
        engine.close()

    # 3. attribution: the best row's serving stages against the ceiling
    best = max((r for r in rows if r.get("fps")), key=lambda r: r["fps"],
               default=None)
    if best:
        doc["attribution"] = {
            "best_row_clients": best["clients"],
            "serving_fps": best["fps"],
            "engine_ceiling_fps": ceiling,
            "gap_pct": round(100 * (1 - best["fps"] / ceiling), 1),
            "note": ("dispatch_batch = host ingest+dispatch per batch; "
                     "fetch_batch = result wait+unpack; infer_batch = "
                     "dispatch->results total; request_e2e = per-request "
                     "wire-to-wire. avg_batch below the largest bucket "
                     "means supply (client windows), not server capacity, "
                     "limits batch depth."),
            "stages_ms": best["stages_ms"],
            "avg_batch": best["avg_batch"],
        }

    print(json.dumps(doc, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(doc, fp, indent=1)
    return doc


if __name__ == "__main__":
    main(sys.argv)
