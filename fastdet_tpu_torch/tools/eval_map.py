"""mAP of a trained shape detector over held-out synthetic scenes.

    python -m fastdet_tpu_torch.tools.eval_map
        [--weights weights/detect9_full.npz] [--n 128] [--modes bf16,int8]
        [--batch 16] [--seed-base 140000] [--out FILE]

The port of the JAX package's ``tools/eval_map.py``: per-class AP,
mAP@0.5 and COCO-style mAP@[.5:.95] (``ops/metrics.py``) for each mode
of ``--modes``, over ``--n`` freshly generated scenes
(``data/synth.py``, seeds from 140000: reserved for evaluation, disjoint
from every training, validation and test range), and the int8-vs-bf16
delta. The engine runs at threshold 0.05 so the precision-recall curve
reaches the low-confidence tail; its max_det budget caps each frame's
candidates as serving does. int8 calibrates on the first 8 scenes.

Prints one JSON line per mode and, with both bf16 and int8, a summary
line; ``--out`` also gets the per-class AP and the PR curves.
``main(argv, device="cuda")`` returns that document. Where a trimmed
copy of the repository lacks the default weights, run it with
``--weights weights/detect80_full.npz``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

EVAL_SEED_BASE = 140000
DET_THRESHOLD = 0.05


def run_mode(spec, params, mode, imgs, batch, calib, device="cuda"):
    """Detections of every image, through the engine's pixel path in
    batches of ``batch`` (the last padded with its last image)."""
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    kw = {"calibration_images": calib} if mode == "int8" else {}
    eng = DetectionEngine(spec, params, mode=mode, buckets=(batch,),
                          device=device, **kw)
    dets = []
    thrs = [DET_THRESHOLD] * batch
    try:
        for lo in range(0, len(imgs), batch):
            chunk = imgs[lo:lo + batch]
            arr = list(chunk) + [chunk[-1]] * (batch - len(chunk))
            dets.extend(eng.fetch(eng.detect_async(arr, thrs),
                                  batch)[:len(chunk)])
    finally:
        eng.close()
    return dets


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "eval_map")
    ap.add_argument("--weights", default="weights/detect9_full.npz")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--modes", default="bf16,int8")
    ap.add_argument("--seed-base", type=int, default=EVAL_SEED_BASE)
    ap.add_argument("--out", default=None,
                    help="dump per-class AP + PR curves to this JSON")
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.ops import metrics

    device_mod.resolve(device)
    spec, params = weights_io.load_npz(args.weights)
    nc = spec.num_classes
    print(f"[model] {spec.name} num_classes={nc} from {args.weights}",
          file=sys.stderr)

    t0 = time.time()
    imgs, gt_boxes, gt_labels = synth.make_dataset(
        range(args.seed_base, args.seed_base + args.n), num_classes=nc)
    print(f"[data] {args.n} held-out scenes (seeds {args.seed_base}+) "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    calib = imgs[:8].astype(np.uint8)

    results = {}
    detail = {"weights": args.weights, "n_scenes": args.n,
              "seed_base": args.seed_base, "modes": {}}
    for mode in args.modes.split(","):
        t0 = time.time()
        dets = run_mode(spec, params, mode, imgs, args.batch, calib, device)
        ev = metrics.evaluate_detections(
            dets, gt_boxes, gt_labels, nc, spec.image_size,
            iou_thresholds=metrics.COCO_IOU_THRESHOLDS)
        row = {
            "mode": mode,
            "map50": ev["map"][0.5],
            "map50_95": ev.get("map_coco"),
            "wall_s": round(time.time() - t0, 1),
        }
        results[mode] = row
        detail["modes"][mode] = {
            **row,
            "map_per_iou": {str(k): v for k, v in ev["map"].items()},
            "per_class": {str(k): v for k, v in ev["per_class"].items()},
            "pr50": {str(k): [list(np.round(p, 4)), list(np.round(r, 4))]
                     for (k, t), (p, r) in ev["pr"].items() if t == 0.5},
        }
        print(json.dumps(row), flush=True)

    if "bf16" in results and "int8" in results:
        summary = {
            "delta_map50_int8_vs_bf16": round(
                results["bf16"]["map50"] - results["int8"]["map50"], 4),
            "delta_map50_95_int8_vs_bf16": round(
                (results["bf16"]["map50_95"] or 0)
                - (results["int8"]["map50_95"] or 0), 4),
        }
        detail["summary"] = summary
        print(json.dumps(summary), flush=True)

    if args.out:
        with open(args.out, "w") as fp:
            json.dump(detail, fp, indent=1)
        print(f"[out] {args.out}", file=sys.stderr)
    return detail


if __name__ == "__main__":
    main(sys.argv)
