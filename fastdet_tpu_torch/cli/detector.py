"""Detector CLI — flag-for-flag parity with the reference detector CLI.

Reference grammar (server/detector.py:169-195)::

    python -m fastdet_tpu_torch.cli.detector [-m mode] [-c num_classes]
        [-t threshold] weights images ...

and per image prints ``(wall_seconds, results)`` exactly like the
reference's ``print(dt, result)``.

The port's counterpart of the JAX package's ``fastdet_tpu/cli/detector.py``,
flag for flag. ``weights`` accepts fastdet .npz, darknet .weights, .onnx
and ``synthetic[:arch]``; ``-m`` accepts bf16|f32|int8 as well as the
reference's cpu|cuda|tensorrt values (mapped to the default, bf16);
``-a arch`` disambiguates a .weights architecture if needed. The engine
runs on the CUDA cards; ``main(argv, device=...)`` takes another device
for callers that ask for one (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import getopt
import logging
import sys
import time


def main(argv, device="cuda"):
    def usage():
        print(
            f"usage: {argv[0]} [-m mode] [-c num_classes] [-t threshold] "
            f"[-a arch] weights images ..."
        )
        return 100

    try:
        (opts, args) = getopt.getopt(argv[1:], "m:c:t:a:")
    except getopt.GetoptError:
        return usage()
    mode = None
    num_classes = 80
    threshold = 0.1
    arch = None
    for (k, v) in opts:
        if k == "-m":
            mode = v
        elif k == "-c":
            num_classes = int(v)
        elif k == "-t":
            threshold = float(v)
        elif k == "-a":
            arch = v
    if not args:
        return usage()
    path = args.pop(0)

    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(message)s", level=logging.INFO
    )

    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.runtime.detector import EngineDetector
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params = weights_io.load_model(path, arch=arch, num_classes=num_classes)
    engine = DetectionEngine(spec, params, mode=mode, buckets=(1,),
                             device=device)
    try:
        # warm the first-choice programs so the first image's printed
        # wall time is not the kernels' build and cuDNN's algorithm
        # choice; no fallbacks: a one-shot CLI would warm programs it
        # will likely never run
        engine.warmup((1,), fallbacks=False)
        detector = EngineDetector(engine, path=path)
        for img_path in args:
            with open(img_path, "rb") as fp:
                data = fp.read()
            t0 = time.time()
            result = detector.perform(data, threshold=threshold)
            dt = time.time() - t0
            print(dt, result)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
