"""Space-to-depth stem rewrite (inference-only graph transform).

The port of the JAX package's models/s2d.py; the weights are rearranged
in numpy exactly as there, so both packages get the same parameters bit
for bit (tests/test_torch_s2d.py). The first two Darknet convolutions
(conv0 3x3/s1 over three input channels at full resolution, conv1 3x3/s2)
are rewritten on the 2x-decimated grid:

    x (416, 416, 3)  --s2d-->  (208, 208, 12 [+20 zero channels])
    conv0' = 3x3/s1 ->  (208, 208, 4*f0)     [phase-major channels]
    conv1' = 2x2/s1, pad ((1,0),(1,0)) -> (208, 208, f1)

with weights rearranged so every output value is the same sum: each
original tap (di, dj) lands at s2d tap (u, v) and phase (r, s) via
row = 2a + P + di = 2(a + u) + r (and the column analog). conv1'
consumes conv0's phase-major form directly and emits the standard map.

Exactness: the rearranged weights are the same values plus structural
zeros, and every transformed output channel holds exactly one original
channel's taps, so int8 per-channel weight scales and int32 sums are
unchanged — bit-exact in int8 given one set of activation scales. In
f32/bf16 the summation order differs, so results agree to float
tolerance. The serving engine applies the rewrite in every mode wherever
the stem matches (the JAX engine's default; the port has no switch to
turn it off). Training, checkpoints and import keep the canonical spec.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

from fastdet_tpu_torch.models.yolov3 import (
    Conv, ModelSpec, Route, Shortcut, SpaceToDepth)


def stem_to_s2d(
    spec: ModelSpec, folded_params: Dict[str, Any]
) -> Optional[Tuple[ModelSpec, Dict[str, Any]]]:
    """Rewrite (conv0 3x3/s1, conv1 3x3/s2) -> (s2d, conv0', conv1').

    ``folded_params`` must be inference-folded ({'w','b'} per conv, HWIO
    numpy). Returns (new_spec, new_params) or None when the spec doesn't
    start with the Darknet stem pattern (e.g. yolov3-tiny's maxpool stem).
    """
    ls = spec.layers
    if len(ls) < 2 or not (isinstance(ls[0], Conv) and isinstance(ls[1], Conv)):
        return None
    c0, c1 = ls[0], ls[1]
    if not (c0.ksize == 3 and c0.stride == 1 and c0.pad is None and c0.bn
            and c1.ksize == 3 and c1.stride == 2 and c1.pad is None and c1.bn
            and spec.image_size % 2 == 0):
        return None
    p0, p1 = folded_params[c0.name], folded_params[c1.name]
    if "w" not in p0 or "w" not in p1:
        return None
    w0 = np.asarray(p0["w"], np.float32)       # (3, 3, cin, f0)
    w1 = np.asarray(p1["w"], np.float32)       # (3, 3, f0, f1)
    cin, f0 = w0.shape[2], w0.shape[3]
    f1 = w1.shape[3]

    # conv0': 3x3 SAME over the s2d grid, 4*cin -> 4*f0 (phase-major).
    w0p = np.zeros((3, 3, 4 * cin, 4 * f0), np.float32)
    for P in (0, 1):
        for Q in (0, 1):
            for di in (-1, 0, 1):
                u, r = divmod(P + di, 2)
                for dj in (-1, 0, 1):
                    v, s = divmod(Q + dj, 2)
                    w0p[u + 1, v + 1,
                        (2 * r + s) * cin:(2 * r + s + 1) * cin,
                        (2 * P + Q) * f0:(2 * P + Q + 1) * f0] = \
                        w0[di + 1, dj + 1]
    b0p = np.tile(np.asarray(p0["b"], np.float32), 4)

    # Pad conv0' input channels up to 32 with zero channels (and zero
    # kernel rows): every sum is unchanged, and the int8 GEMM's depth
    # 3*3*32 = 288 is a multiple of 8 (torch._int_mm's K) where 3*3*12
    # would not be. The JAX package pads for its TPU's int8 lane packing.
    pad_c = 0
    if 4 * cin < 32:
        pad_c = 32 - 4 * cin
        w0p = np.concatenate(
            [w0p, np.zeros((3, 3, pad_c, 4 * f0), np.float32)], axis=2)

    # conv1': 2x2, pad ((1,0),(1,0)), 4*f0 (phase-major) -> f1.
    w1p = np.zeros((2, 2, 4 * f0, f1), np.float32)
    for di in (-1, 0, 1):
        u, r = divmod(di, 2)
        for dj in (-1, 0, 1):
            v, s = divmod(dj, 2)
            w1p[u + 1, v + 1,
                (2 * r + s) * f0:(2 * r + s + 1) * f0] = w1[di + 1, dj + 1]

    new_layers = [
        SpaceToDepth(2, pad_channels=pad_c),
        replace(c0, filters=4 * f0),
        replace(c1, ksize=2, stride=1, pad=((1, 0), (1, 0))),
    ]
    # One layer was inserted at the front: every absolute layer index in
    # routes/shortcuts shifts by +1.
    for l in ls[2:]:
        if isinstance(l, Route):
            l = Route(tuple(i + 1 for i in l.sources))
        elif isinstance(l, Shortcut):
            l = Shortcut(l.source + 1)
        new_layers.append(l)

    new_params = dict(folded_params)
    new_params[c0.name] = {"w": w0p, "b": b0p}
    new_params[c1.name] = {"w": w1p, "b": np.asarray(p1["b"], np.float32)}
    return replace(spec, layers=tuple(new_layers)), new_params
