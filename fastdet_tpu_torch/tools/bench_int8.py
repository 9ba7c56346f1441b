"""Forward time of int8 vs bf16 vs f32 on the card.

    python -m fastdet_tpu_torch.tools.bench_int8 [--arch full]
        [--batches 1,8] [--iters 30] [--modes bf16,int8,f32]

The port of the JAX package's ``tools/bench_int8.py``: the per-mode
table of forward-only ms/img at several batch sizes for

- bf16: ``YoloNet(dtype=torch.bfloat16)``, the default serving mode;
- int8: ``Int8Net`` (models/quantize.py), calibrated on four random
  frames;
- f32: ``YoloNet(dtype=torch.float32)`` in true float32
  (``device.strict_fp32``).

Weights are ``synthetic:<arch>`` at 80 classes, folded, as in the JAX
tool. Each row holds ``b{b}_ms_per_img`` (the best of five blocks of
max(4, iters // 5) forwards, one synchronize a block) and
``b{b}_compile_s`` (the first forward's wall: cuDNN's algorithm choice
and the allocator's first blocks; the key keeps the JAX tool's name).
Each row goes to standard error; the last line of standard output is
the JSON table with ``int8_speedup_b{b}`` = bf16 / int8 ms per image.
``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BLOCKS = 5   # timed blocks per (mode, batch); the best is kept


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "bench_int8")
    ap.add_argument("--arch", default="full")
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--modes", default="bf16,int8,f32")
    args = ap.parse_args(argv[1:])

    import torch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.models import quantize, weights
    from fastdet_tpu_torch.models.yolov3 import YoloNet

    dev = device_mod.resolve(device)
    device_mod.strict_fp32()
    print(bench.card_line(dev))
    spec, params = weights.load_model(f"synthetic:{args.arch}",
                                      num_classes=80)
    folded = weights.fold_params(spec, params)
    batches = [int(b) for b in args.batches.split(",")]
    modes = args.modes.split(",")

    def net(mode):
        if mode == "int8":
            rng = np.random.RandomState(0)
            calib = rng.randint(0, 255, (4, spec.image_size,
                                         spec.image_size, 3), np.uint8)
            scales = quantize.calibrate(spec, folded, calib, device=dev)
            qparams = quantize.quantize_params(spec, folded, scales)
            return quantize.Int8Net(spec, qparams, device=dev).eval()
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[mode]
        return YoloNet(spec, folded, dtype=dt, device=dev).eval()

    table = {}
    for mode in modes:
        fn = net(mode)
        row = {}
        for b in batches:
            x = torch.from_numpy(
                np.random.RandomState(1).rand(
                    b, spec.image_size, spec.image_size, 3)
                .astype(np.float32)).to(dev)
            with torch.inference_mode():
                t0 = time.time()
                fn(x)
                bench._sync(dev)
                compile_s = time.time() - t0
                # many forwards in flight, one synchronize at the end
                ts = []
                per_block = max(4, args.iters // 5)
                for _ in range(BLOCKS):
                    t0 = time.time()
                    for _ in range(per_block):
                        fn(x)
                    bench._sync(dev)
                    ts.append((time.time() - t0) / per_block)
            ms = 1e3 * min(ts) / b
            row[f"b{b}_ms_per_img"] = round(ms, 3)
            row[f"b{b}_compile_s"] = round(compile_s, 1)
        table[mode] = row
        del fn
        print(f"{mode}: {row}", file=sys.stderr)

    if "bf16" in table and "int8" in table:
        for b in batches:
            k = f"b{b}_ms_per_img"
            table[f"int8_speedup_b{b}"] = round(
                table["bf16"][k] / table["int8"][k], 3)
    print(json.dumps({"arch": args.arch, "backend": dev.type, **table}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
