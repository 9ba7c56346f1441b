"""The yardstick's operation and byte counts, from the configuration and
the frames alone (nothing is read from the program).

- :func:`flops_per_frame`: 2 * k^2 * C_in * C_out * H_out * W_out summed
  over the convolutions of the published layer list, Darknet's own
  count (65.86 G for YOLOv3-416, 5.56 G for YOLOv3-tiny-416 in
  pjreddie.com's table).
- :func:`b1_bytes`: the bytes kernel B1 (the sparse-coefficient
  reconstruction) has to move for one frame: the per-block stream
  offsets in (four int32 per block boundary) and the DC lane in (one
  int32 per block), the natural-order int32 coefficients out (64 per
  block). The frame's mask and value streams, whose size depends on
  its content, are left out, so the count is a floor and a share of
  the roofline read from it errs low.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

#: H100 SXM, NVIDIA's data sheet: dense bf16 tensor rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def _walk(cfg: dict):
    """Yield (layer, in (h, w, c), out (h, w, c)) over the layer list."""
    h, w, c = int(cfg["height"]), int(cfg["width"]), int(cfg["channels"])
    outs: List[Tuple[int, int, int]] = []
    for i, l in enumerate(cfg["layers"]):
        t = l["type"]
        src = (h, w, c)
        if t == "convolutional":
            k, s = int(l["size"]), int(l["stride"])
            p = (k - 1) // 2 if l.get("pad") else 0
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
            c = int(l["filters"])
        elif t == "maxpool":
            s = int(l["stride"])
            h, w = (h - 1) // s + 1, (w - 1) // s + 1
        elif t == "upsample":
            h, w = h * int(l["stride"]), w * int(l["stride"])
        elif t == "route":
            idx = [j if j >= 0 else i + j for j in l["layers"]]
            h, w = outs[idx[0]][0], outs[idx[0]][1]
            c = sum(outs[j][2] // int(l.get("groups", 1)) for j in idx)
        elif t not in ("shortcut", "yolo"):
            raise ValueError(f"layer {i}: unknown type {t!r}")
        outs.append((h, w, c))
        yield l, src, (h, w, c)


def conv_shapes(cfg: dict) -> List[Tuple[dict, int, int, int]]:
    """(layer, k, C_in, C_out) for each convolution, in layer order."""
    return [(l, int(l["size"]), src[2], int(l["filters"]))
            for l, src, _ in _walk(cfg) if l["type"] == "convolutional"]


def flops_per_frame(cfg: dict) -> int:
    total = 0
    for l, src, out in _walk(cfg):
        if l["type"] == "convolutional":
            k = int(l["size"])
            total += 2 * k * k * src[2] * out[2] * out[0] * out[1]
    return total


def jpeg_blocks(data: bytes) -> int:
    """8x8 blocks of all components of a baseline or progressive JPEG,
    from its SOF header (each component padded to whole MCUs)."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError("not a JPEG marker stream")
        marker = data[i + 1]
        (length,) = struct.unpack(">H", data[i + 2:i + 4])
        if marker in (0xC0, 0xC1, 0xC2):
            _, height, width, ncomp = struct.unpack(
                ">BHHB", data[i + 4:i + 10])
            comps = [(data[i + 11 + 3 * k] >> 4, data[i + 11 + 3 * k] & 15)
                     for k in range(ncomp)]
            hmax = max(c[0] for c in comps)
            vmax = max(c[1] for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            return sum(mcux * hs * mcuy * vs for hs, vs in comps)
        i += 2 + length
    raise ValueError("no SOF marker")


def b1_bytes(data: bytes) -> int:
    nb = jpeg_blocks(data)
    return 4 * 4 * (nb + 1) + 4 * nb + 4 * 64 * nb
