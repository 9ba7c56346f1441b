"""Training CLI: fine-tune / train a YOLOv3-family model on the CUDA card.

The port of the JAX package's ``fastdet_tpu/cli/train.py``, flag for
flag. Data can be a directory of ``<image>.jpg`` + ``<image>.txt`` label
files in the standard darknet layout (one ``class cx cy w h`` line per
object, all normalized), or ``--synthetic`` for a self-contained
smoke/benchmark run. Batches are drawn from ``RandomState(0)`` in the
JAX CLI's order, so both CLIs see the same batches.

Usage:
    python -m fastdet_tpu_torch.cli.train [-a full|tiny] [-c classes]
        [-w init_weights] [-o out.npz] [--steps N] [--batch B] [--lr LR]
        [--ckpt file] [--ckpt-every N] [--resume] [--synthetic | data_dir]

Differences from the JAX CLI: training runs in float32 on one device (the
card, or the device ``main(argv, device=...)`` is given; the tests pass
``"cpu"``), where the JAX CLI spreads it over a mesh of every device;
``--ckpt`` names one checkpoint file (parallel/checkpoint.save), where
the JAX CLI writes an orbax directory.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger(__name__)


def load_dataset(data_dir: str, image_size: int):
    """Darknet-layout dataset: list of (image_path, boxes, labels)."""
    items = []
    for img_path in sorted(glob.glob(os.path.join(data_dir, "*.jpg"))):
        txt = os.path.splitext(img_path)[0] + ".txt"
        boxes, labels = [], []
        if os.path.exists(txt):
            with open(txt) as fp:
                for line in fp:
                    f = line.split()
                    if len(f) >= 5:
                        labels.append(int(f[0]))
                        boxes.append([float(v) for v in f[1:5]])
        items.append((img_path,
                      np.asarray(boxes, np.float32).reshape(-1, 4),
                      np.asarray(labels, np.int32)))
    if not items:
        raise SystemExit(f"no .jpg files under {data_dir}")
    return items


def synthetic_batch(rng, batch, image_size, num_classes):
    """Self-contained batch: colored squares on noise, one box each."""
    images = rng.rand(batch, image_size, image_size, 3).astype(np.float32) * 0.3
    boxes, labels = [], []
    for i in range(batch):
        cx, cy = rng.uniform(0.25, 0.75, 2)
        w = h = rng.uniform(0.15, 0.35)
        x0 = int((cx - w / 2) * image_size)
        y0 = int((cy - h / 2) * image_size)
        klass = rng.randint(num_classes)
        color = np.zeros(3)
        color[klass % 3] = 1.0
        images[i, y0 : y0 + int(h * image_size), x0 : x0 + int(w * image_size)] = color
        boxes.append(np.array([[cx, cy, w, h]], np.float32))
        labels.append(np.array([klass], np.int32))
    return images, boxes, labels


def real_batch(rng, items, batch, image_size):
    from fastdet_tpu_torch.runtime import jpeg as jm

    idx = rng.randint(len(items), size=batch)
    images = np.zeros((batch, image_size, image_size, 3), np.float32)
    boxes, labels = [], []
    for j, i in enumerate(idx):
        path, b, l = items[i]
        img = jm.decode_rgb(open(path, "rb").read())
        if img.shape[:2] != (image_size, image_size):
            raise SystemExit(f"{path}: images must be {image_size}x{image_size}")
        images[j] = img.astype(np.float32) / 255.0
        boxes.append(b)
        labels.append(l)
    return images, boxes, labels


def main(argv, device="cuda"):
    ap = argparse.ArgumentParser(prog=argv[0])
    ap.add_argument("data_dir", nargs="?", help="darknet-layout dataset dir")
    ap.add_argument("-a", "--arch", default="full", choices=["full", "tiny"])
    ap.add_argument("-c", "--classes", type=int, default=80)
    ap.add_argument("-w", "--weights", default=None, help="init weights")
    ap.add_argument("-o", "--out", default="trained.npz")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--image-size", type=int, default=416)
    ap.add_argument("--ckpt", default=None, help="checkpoint file")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv[1:])
    if not args.synthetic and not args.data_dir:
        ap.error("provide a data_dir or --synthetic")

    logging.basicConfig(format="%(asctime)s %(levelname)s %(message)s",
                        level=logging.INFO)

    import torch

    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.models import yolov3
    from fastdet_tpu_torch.parallel import checkpoint as ckpt_lib
    from fastdet_tpu_torch.parallel import train as train_lib

    dev = device_mod.resolve(device)
    spec = yolov3.get_spec(args.arch, args.classes)
    if args.image_size != 416:
        spec = yolov3.ModelSpec(spec.name, spec.num_classes, spec.layers,
                                spec.anchors, image_size=args.image_size)
    if args.weights:
        _, params = weights_io.load_model(args.weights, arch=args.arch,
                                          num_classes=args.classes)
    else:
        params = weights_io.synthetic_params(spec)

    logger.info("device: %s", torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else dev)
    state = train_lib.init_train_state(spec, params, lr=args.lr, device=dev)
    step_fn = train_lib.make_train_step(spec)
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        state = ckpt_lib.restore(args.ckpt, state)
        logger.info("resumed at step %d", state.step)

    items = None if args.synthetic else load_dataset(args.data_dir, spec.image_size)
    rng = np.random.RandomState(0)
    t0 = time.time()
    start = state.step
    for step in range(start, args.steps):
        if args.synthetic:
            images, boxes, labels = synthetic_batch(
                rng, args.batch, spec.image_size, args.classes)
        else:
            images, boxes, labels = real_batch(rng, items, args.batch,
                                               spec.image_size)
        targets = train_lib.build_targets(spec, boxes, labels)
        state, metrics = step_fn(
            state, torch.from_numpy(images).to(dev),
            *[torch.from_numpy(t).to(dev) for t in targets])
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (step + 1 - start) * args.batch / (time.time() - t0)
            logger.info("step %d loss=%.3f coord=%.3f obj=%.3f cls=%.3f "
                        "(%.1f img/s)", step + 1, m["loss"], m["coord"],
                        m["obj"], m["cls"], rate)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt, state)
            logger.info("checkpoint saved at step %d", step + 1)

    ckpt_lib.export_inference(args.out, spec, state)
    logger.info("wrote %s (servable: name:%d:%s)", args.out, args.classes,
                args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
