"""Batched postprocess: decode -> candidate budget, and wire packing.

Counterpart of the JAX package's ops/postprocess.py ``select_batch``
and ``pack_wire_records``; the NMS between them is ops/nms.py.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fastdet_tpu_torch.models.yolov3 import ModelSpec
from fastdet_tpu_torch.ops.decode import (decode_all_components,
                                          select_candidates_components)
from fastdet_tpu_torch.ops.nms import NMSResult

MAX_CANDIDATES = 512
MAX_DET = 100


def select_batch(heads: Sequence[torch.Tensor], spec: ModelSpec,
                 thresholds: torch.Tensor,
                 max_candidates: int = MAX_CANDIDATES):
    """Per-scale (B, H, W, 3*(5+C)) heads + (B,) thresholds -> top-K
    candidate (boxes, scores, klass), the input of nms.soft_nms_batch."""
    comps, scores, klass = decode_all_components(heads, spec)
    return select_candidates_components(comps, scores, klass, thresholds,
                                        max_candidates)


def pack_wire_records(res: NMSResult, image_size: int) -> torch.Tensor:
    """A batched NMSResult -> (B, max_det*10 + 4) uint8 response-wire
    records: max_det big-endian >BBhhhh records [klass u8, conf*255 u8,
    x y w h i16 pixel coords] then the valid count as 4 LE bytes.

    Coordinates scale in float32, NaN -> 0, truncate toward zero and
    saturate to i16 / u8 — the JAX package's device packer exactly."""
    b, md = res.scores.shape
    zero = torch.zeros((), dtype=torch.float32, device=res.scores.device)
    coords = res.boxes * torch.tensor(float(image_size), dtype=torch.float32)
    coords = torch.where(torch.isnan(coords), zero, coords)
    coords = torch.clamp(torch.trunc(coords), -32768.0, 32767.0).to(
        torch.int32)
    conf = torch.where(torch.isnan(res.scores), zero, res.scores)
    c_u8 = torch.clamp(torch.trunc(conf * torch.tensor(
        255.0, dtype=torch.float32)), 0.0, 255.0)
    hi = ((coords >> 8) & 255).to(torch.uint8)             # two's complement
    lo = (coords & 255).to(torch.uint8)
    rec = torch.stack([
        res.klass.to(torch.uint8), c_u8.to(torch.uint8),
        hi[..., 0], lo[..., 0], hi[..., 1], lo[..., 1],
        hi[..., 2], lo[..., 2], hi[..., 3], lo[..., 3],
    ], dim=-1).reshape(b, md * 10)
    cnt = res.count.to(torch.int64)
    tail = torch.stack([cnt & 255, (cnt >> 8) & 255, (cnt >> 16) & 255,
                        (cnt >> 24) & 255], dim=-1).to(torch.uint8)
    return torch.cat([rec, tail], dim=-1)
