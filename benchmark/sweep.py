"""The knee of a stream cell: the most cameras the system keeps up with.

    python3 benchmark/sweep.py --workload <stream cell> --seed <n>
        [--seconds S] [--start 4] [--step 2] [--write]

One process and one warm set-up (the cell's engine, as a run builds
it), then the cell's open-loop mix at a rising number of cameras, each
step a fresh server and fresh camera processes for ``--seconds`` (by
default the benchmark's ``run_seconds``, the length over which a
backlog has to show). A
step keeps up when every frame is answered in time and the frames
answered per second reach 95 % of the offered rate; the coarse steps
stop at the first that does not, then the cameras between the last
that kept up and it are tried one by one. The knee is the last step
that kept up; the cell offers 4/5 of it, rounded down to whole
cameras. Prints one JSON line per step and the table's summary;
``--write`` puts ``cameras`` into ``cells/<cell>.json`` (keeping its
other keys). Needs the card.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

KEEP_UP = 0.95


def step(ctx, gen, program, cameras: int) -> dict:
    from benchmark import stats

    ctx.mix["cameras"] = cameras
    ctx.svc = program.service(ctx.engine)
    win = gen.run(ctx)
    fps = win.answered_in_window() / win.seconds
    offered = cameras * float(ctx.mix["fps_per_camera"])
    failed = sum(1 for f in win.frames if not win.ok(f))
    hist = {k: win.after["batch_hist"][k] - win.before["batch_hist"].get(k, 0)
            for k in win.after["batch_hist"]}
    batches = sum(hist.values())
    return {"cameras": cameras, "offered_fps": offered,
            "answered_fps": round(fps, 2), "ratio": round(fps / offered, 4),
            "frames": len(win.frames), "failed": failed,
            "p50_ms": round(stats.latency_ms(win, 50), 2),
            "p95_ms": round(stats.latency_ms(win, 95), 2),
            "mean_batch": round(sum(k * v for k, v in hist.items())
                                / max(batches, 1), 2),
            "kept_up": failed == 0 and fps >= KEEP_UP * offered}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="benchmark/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--start", type=int, default=4)
    ap.add_argument("--step", type=int, default=2)
    ap.add_argument("--max", type=int, default=64)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)

    from benchmark import harness, program
    from benchmark.run import _cache_dirs

    _cache_dirs()
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 1
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    seconds = args.seconds or float(bench["run_seconds"])
    cell = harness.resolve(bench, HERE, ROOT, args.workload)
    cfg, mix = cell.cfg, dict(cell.mix)
    if mix["kind"] != "open_loop_udp":
        harness.log(f"{args.workload} is not an open-loop stream cell")
        return 2
    ctx = harness.Context(args.workload, cfg, mix, args.seed, seconds,
                          False, "cuda:0", ROOT, HERE,
                          t_start=harness.process_start())
    harness.prepare(ctx)
    gen = harness.load_generator(HERE, mix["kind"])
    rows = []
    try:
        cams = args.start
        while cams <= args.max:
            rows.append(step(ctx, gen, program, cams))
            print(json.dumps(rows[-1]), flush=True)
            if not rows[-1]["kept_up"]:
                break
            cams += args.step
        passed = [r["cameras"] for r in rows if r["kept_up"]]
        last = max(passed) if passed else 0
        for cams in range(last + 1, rows[-1]["cameras"]):
            rows.append(step(ctx, gen, program, cams))
            print(json.dumps(rows[-1]), flush=True)
            if not rows[-1]["kept_up"]:
                break
            last = cams
    finally:
        ctx.engine.close()
    knee = last * float(mix["fps_per_camera"])
    cell_cams = int(0.8 * knee // float(mix["fps_per_camera"]))
    print(json.dumps({"workload": args.workload, "knee_cameras": last,
                      "knee_fps": knee, "cell_cameras": cell_cams,
                      "card": harness.card_line()}), flush=True)
    if args.write and cell_cams > 0:
        path = os.path.join(HERE, "cells", args.workload + ".json")
        own = harness.load_json(path) if os.path.exists(path) else {}
        own["cameras"] = cell_cams
        with open(path, "w") as fp:
            json.dump(own, fp, indent=1)
            fp.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
