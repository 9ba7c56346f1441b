"""Weights made from the seed, for a configuration without a checkpoint.

Starts from the benchmark's frozen copy of the program's
``bench.calibrated_params`` (fastdet_tpu_torch/bench.py): Kaiming-normal
conv weights for LeakyReLU(0.1) and batch norm at identity, drawn in
one normal draw from a ``torch.Generator`` on ``device`` and split by
layer, in float32 (the type the program's engine takes them in). That
recipe's heads (every 1x1 head conv x 0.02, objectness bias -3) answer
no record at threshold 0.1, so the heads here are set so that a frame
has some detections, and the same number whatever the seed:

- batch norm's running mean and variance are set from the first
  ``calibration_frames`` frames of the pool, so that every channel
  comes out normalised whatever the seed drew (as a trained model's
  are);
- the head convs' box and class rows are scaled by ``head_scale``, the
  objectness rows by ``objectness_scale`` (a spread of objectness over
  the grid);
- each anchor's class biases are a seeded permutation of the ladder
  ``class_bias_top - class_bias_step * rank``, so a cell's class is
  decided by a margin far above rounding;
- the objectness bias is found by bisection so that, over the first
  ``calibration_frames`` frames of the pool, ``detections_per_frame``
  candidates a frame reach the threshold (the plain reference network,
  :mod:`benchmark.reference.darknet`, in float32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.flops import conv_shapes


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """{``conv<i>``: {"w" (k, k, in, out), "bn" | "b"}} as numpy float32,
    a pure function of ``cfg`` and ``seed``, objectness bias 0."""
    spec = cfg["weights"]
    shapes = conv_shapes(cfg)
    sizes = [k * k * cin * cout for _, k, cin, cout in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                        0xB1A5]))
    gain = math.sqrt(2.0 / (1 + 0.1 ** 2))
    stride = 5 + int(cfg["classes"])
    ladder = (float(spec["class_bias_top"]) - float(spec["class_bias_step"])
              * np.arange(int(cfg["classes"]), dtype=np.float32))
    out: Dict[str, dict] = {}
    off = 0
    for i, ((layer, k, cin, cout), n) in enumerate(zip(shapes, sizes)):
        w = flat[off:off + n].reshape(k, k, cin, cout)
        off += n
        w = w * np.float32(gain / math.sqrt(k * k * cin))
        if layer.get("batch_normalize"):
            out[f"conv{i}"] = {"w": w, "bn": {
                "gamma": np.ones((cout,), np.float32),
                "beta": np.zeros((cout,), np.float32),
                "mean": np.zeros((cout,), np.float32),
                "var": np.ones((cout,), np.float32)}}
            continue
        scale = np.full((cout,), spec["head_scale"], np.float32)
        b = np.zeros((cout,), np.float32)
        for a in range(cout // stride):
            scale[stride * a + 4] = spec["objectness_scale"]
            b[stride * a + 5:stride * (a + 1)] = rng.permutation(ladder)
        out[f"conv{i}"] = {"w": (w * scale).astype(np.float32), "b": b}
    return out


def head_convs(cfg: dict) -> List[str]:
    return [f"conv{i}" for i, (layer, _, _, _) in enumerate(conv_shapes(cfg))
            if not layer.get("batch_normalize")]


def calibrate(cfg: dict, weights: Dict[str, dict], frames_u8: np.ndarray,
              threshold: float, device) -> float:
    """Set batch norm's statistics from ``frames_u8``, then every anchor's
    objectness bias so that ``detections_per_frame`` candidates a frame
    score at least ``threshold``; returns the bias."""
    from benchmark.reference.darknet import DarknetF32

    target = float(cfg["weights"]["detections_per_frame"])
    stride = 5 + int(cfg["classes"])
    frames = torch.from_numpy(frames_u8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        stats: list = []
        DarknetF32(cfg, weights, device)(frames, batch_stats=stats)
        bn_convs = [n for n in (f"conv{i}" for i in range(len(
            conv_shapes(cfg)))) if "bn" in weights[n]]
        for name, (mean, var) in zip(bn_convs, stats):
            weights[name]["bn"]["mean"] = mean.cpu().numpy().astype(
                np.float32)
            weights[name]["bn"]["var"] = var.cpu().numpy().astype(
                np.float32)
        heads = DarknetF32(cfg, weights, device)(frames)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    obj = np.concatenate([h[..., 4].reshape(len(frames_u8), -1).cpu().numpy()
                          for h in heads], axis=1).astype(np.float64)
    cls = np.concatenate([torch.sigmoid(h[..., 5:].max(-1).values)
                          .reshape(len(frames_u8), -1).cpu().numpy()
                          for h in heads], axis=1).astype(np.float64)

    def count(b: float) -> float:
        s = cls / (1.0 + np.exp(-(obj + b)))
        return float((s >= threshold).sum(axis=1).mean())

    lo, hi = -40.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if count(mid) >= target else (mid, hi)
    bias = np.float32(hi)
    for name in head_convs(cfg):
        b = weights[name]["b"]
        for a in range(len(b) // stride):
            b[stride * a + 4] = bias
    return float(bias)


def decoded(jpegs: Sequence[bytes]) -> np.ndarray:
    from benchmark.reference.detect import decode_jpeg

    return np.stack([decode_jpeg(j) for j in jpegs])
