"""Demo app: detect over images and write annotated copies.

Headless equivalent of the reference's Unity demo app (DetectionTest.cs):
the app layer that wires a detector backend to frames and renders boxes.
Backends mirror the app's mode button (dummy / local / remote):

    python -m fastdet_tpu_torch.cli.demo -o outdir img1.jpg img2.jpg  # local card
    python -m fastdet_tpu_torch.cli.demo -u rtsp://host:10000/full ...  # remote
    python -m fastdet_tpu_torch.cli.demo --dummy ...                   # no model

Stream mode reproduces the app's continuous capture loop
(DetectionTest.cs:98-122): frames are taken from the image list (cycled,
like a directory camera) at ``--interval`` seconds (scene default 0.1),
the centered-square detect area is computed from the aspect ratio
(DetectionTest.cs:104-111), and rendered boxes persist 0.5 s with
IoU>0.5 same-label replacement (DetectionTest.cs:177-203, via
client_api.BoxTracker):

    python -m fastdet_tpu_torch.cli.demo --stream -n 50 -o outdir imgs...

Thresholds default per mode like the scene config (COCO 0.3 / RSU 0.1,
SampleScene.unity:519-520); -t overrides.

Local mode flags: -w weights (default synthetic:tiny), -c classes,
-m engine mode (bf16|f32|int8). The port's counterpart of the JAX
package's ``fastdet_tpu/cli/demo.py``, flag for flag; the local engine
runs on the CUDA card, or on the device ``main(argv, device=...)`` is
given (the tests pass ``"cpu"``). The demo closes the engine it built
(joins its workers) when it ends.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

# scene defaults (reference SampleScene.unity:518-520)
DEFAULT_INTERVAL = 0.1
DEFAULT_THRESHOLD_COCO = 0.3
DEFAULT_THRESHOLD_RSU = 0.1
BOX_RETAIN = 0.5


def centered_square_area(w: int, h: int):
    """The app's detect area: the largest centered square, in UV
    (DetectionTest.cs:104-111)."""
    if w < h:
        ratio = w / h
        return (0.0, (1 - ratio) / 2, 1.0, ratio)
    ratio = h / w
    return ((1 - ratio) / 2, 0.0, ratio, 1.0)


def _names_for(args, num_classes):
    from fastdet_tpu_torch.utils import labels

    table = {
        "coco": labels.COCO_NAMES, "rsu": labels.RSU_NAMES,
        "shapes": labels.SHAPES3_NAMES, "shapes9": labels.SHAPES9_NAMES,
        "shapes80": labels.SHAPES80_NAMES,
    }
    if args.labels != "auto":
        return table[args.labels]
    return {3: labels.SHAPES3_NAMES, 9: labels.RSU_NAMES}.get(
        num_classes, labels.COCO_NAMES)


def build_detector(args, device="cuda"):
    from fastdet_tpu_torch import client_api
    from fastdet_tpu_torch.utils import labels

    if args.dummy:
        return client_api.DummyDetector()
    if args.url:
        if args.labels != "auto":
            names = _names_for(args, 0)
        else:
            names = labels.RSU_NAMES if args.url.rstrip("/").endswith("rsu") \
                else labels.COCO_NAMES
        return client_api.RemoteDetector(args.url, names=names)
    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params = weights_io.load_model(args.weights, num_classes=args.classes)
    engine = DetectionEngine(spec, params, mode=args.mode, buckets=(1, 4),
                             device=device)
    return client_api.LocalDetector(
        engine, names=_names_for(args, spec.num_classes))


def run_oneshot(det, args, threshold):
    from fastdet_tpu_torch.runtime import jpeg
    from fastdet_tpu_torch.utils import draw

    results = {}
    det.on_result = lambda r: results.__setitem__(r.request_id, r)

    req_to_path = {}
    for path in args.images:
        img = jpeg.decode_rgb(open(path, "rb").read())
        reqid = det.process_image(img, threshold=threshold)
        req_to_path[reqid] = (path, img)

    deadline = time.time() + 30
    while len(results) < len(req_to_path) and time.time() < deadline:
        det.update()
        time.sleep(0.01)

    for reqid, (path, img) in req_to_path.items():
        r = results.get(reqid)
        if r is None:
            logging.warning("%s: no result (timeout)", path)
            continue
        h, w = img.shape[:2]
        dets = [
            (o.klass, o.conf, o.bbox[0] * w, o.bbox[1] * h,
             o.bbox[2] * w, o.bbox[3] * h)
            for o in r.objects
        ]
        out = draw.draw_detections(img, dets, det.names)
        dst = os.path.join(args.outdir, os.path.basename(path))
        with open(dst, "wb") as fp:
            fp.write(jpeg.encode_rgb(out, 92))
        logging.info("%s: %d objects (inference %.0f ms) -> %s",
                     path, len(r.objects), r.inference_time * 1000, dst)


def run_stream(det, args, threshold):
    """Continuous capture loop with box retention (DetectionTest.cs)."""
    from fastdet_tpu_torch import client_api
    from fastdet_tpu_torch.runtime import jpeg
    from fastdet_tpu_torch.utils import draw

    frames = [jpeg.decode_rgb(open(p, "rb").read()) for p in args.images]
    tracker = client_api.BoxTracker(retain=BOX_RETAIN)
    stats = {"total_ms": 0.0, "infer_ms": 0.0, "results": 0}

    def on_result(r):
        tracker.add_result(r)
        stats["results"] += 1
        stats["total_ms"] = (r.recv_time - r.sent_time) * 1000
        stats["infer_ms"] = r.inference_time * 1000

    det.on_result = on_result

    next_detection = 0.0
    for fi in range(args.frames):
        img = frames[fi % len(frames)]
        h, w = img.shape[:2]
        now = time.time()
        if next_detection < now:
            area = centered_square_area(w, h)
            det.process_image(img, detect_area=area, threshold=threshold)
            next_detection = now + args.interval
        det.update()

        boxes = tracker.active()
        dets = [
            (b.klass, b.conf, b.bbox[0] * w, b.bbox[1] * h,
             b.bbox[2] * w, b.bbox[3] * h)
            for b in boxes
        ]
        out = draw.draw_detections(img, dets, det.names)
        dst = os.path.join(args.outdir, f"frame_{fi:04d}.jpg")
        with open(dst, "wb") as fp:
            fp.write(jpeg.encode_rgb(out, 92))
        # the app's Total/Inference overlay (DetectionTest.cs:67-71)
        logging.info("frame %d: boxes=%d Total %.0f ms, Inference %.0f ms",
                     fi, len(boxes), stats["total_ms"], stats["infer_ms"])
        time.sleep(max(0.0, args.interval - (time.time() - now)))
    # drain in-flight requests so late boxes are accounted
    deadline = time.time() + 5
    while det.num_pending_requests and time.time() < deadline:
        det.update()
        time.sleep(0.01)
    logging.info("stream done: %d frames, %d results", args.frames,
                 stats["results"])


def main(argv, device="cuda"):
    ap = argparse.ArgumentParser(prog=argv[0])
    ap.add_argument("images", nargs="+")
    ap.add_argument("-o", "--outdir", default="demo_out")
    ap.add_argument("-u", "--url", default=None, help="remote server URL")
    ap.add_argument("--dummy", action="store_true")
    ap.add_argument("-w", "--weights", default="synthetic:tiny")
    ap.add_argument("-c", "--classes", type=int, default=80)
    ap.add_argument("-t", "--threshold", type=float, default=None,
                    help="default: 0.3 COCO / 0.1 RSU (scene defaults)")
    ap.add_argument("-m", "--mode", default=None)
    ap.add_argument("--labels", default="auto",
                    choices=("auto", "coco", "rsu", "shapes", "shapes9",
                             "shapes80"),
                    help="label table (auto: 3 classes->shapes, 9->rsu, "
                         "else coco)")
    ap.add_argument("--stream", action="store_true",
                    help="continuous capture loop with box retention")
    ap.add_argument("--interval", type=float, default=DEFAULT_INTERVAL,
                    help="stream detection interval seconds (default 0.1)")
    ap.add_argument("-n", "--frames", type=int, default=30,
                    help="stream frame count")
    args = ap.parse_args(argv[1:])
    logging.basicConfig(format="%(asctime)s %(levelname)s %(message)s",
                        level=logging.INFO)

    rsu = args.classes == 9 or (args.url or "").rstrip("/").endswith("rsu")
    threshold = args.threshold if args.threshold is not None else (
        DEFAULT_THRESHOLD_RSU if rsu else DEFAULT_THRESHOLD_COCO)

    from fastdet_tpu_torch import client_api

    det = build_detector(args, device)
    os.makedirs(args.outdir, exist_ok=True)
    try:
        if args.stream:
            run_stream(det, args, threshold)
        else:
            run_oneshot(det, args, threshold)
    finally:
        det.close()
        if isinstance(det, client_api.LocalDetector):
            det.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
