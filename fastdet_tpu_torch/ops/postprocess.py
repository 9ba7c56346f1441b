"""Postprocess: decode -> candidate budget -> soft-NMS, and wire packing.

Counterpart of the JAX package's ops/postprocess.py: ``select_batch``
(decode + budget, composed with nms.soft_nms_batch by the engine),
``postprocess_image`` / ``postprocess_batch`` (the whole postprocess of
one image or of a batch under one threshold), ``pack_wire_records`` and
``to_reference_results`` (one image's result as the reference's tuples).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from fastdet_tpu_torch.models.yolov3 import ModelSpec
from fastdet_tpu_torch.ops.decode import (decode_all_components,
                                          select_candidates_components)
from fastdet_tpu_torch.ops.nms import NMSResult, soft_nms_batch

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


def postprocess_batch(heads: Sequence[torch.Tensor], spec: ModelSpec,
                      threshold, max_candidates: int = MAX_CANDIDATES,
                      max_det: int = MAX_DET) -> NMSResult:
    """Per-scale (B, H, W, 3*(5+C)) heads and one threshold (a scalar,
    shared by the batch) -> the batched NMSResult: :func:`select_batch`
    then nms.soft_nms_batch with the threshold broadcast to (B,), the
    path the engine serves."""
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=heads[0].device).reshape(()).expand(
        heads[0].shape[0])
    b, s, k = select_batch(heads, spec, thr, max_candidates)
    return soft_nms_batch(b, s, k, thr, max_det)


def postprocess_image(heads: Sequence[torch.Tensor], spec: ModelSpec,
                      threshold, max_candidates: int = MAX_CANDIDATES,
                      max_det: int = MAX_DET) -> NMSResult:
    """ONE image's per-scale (H, W, 3*(5+C)) heads -> its NMSResult
    ((max_det, ...) fields, a () count): :func:`postprocess_batch` on a
    batch of one."""
    res = postprocess_batch([h[None] for h in heads], spec, threshold,
                            max_candidates, max_det)
    return NMSResult(*(a[0] for a in res))


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


def to_reference_results(
    result: NMSResult, image_size: int = 416
) -> List[Tuple[int, float, float, float, float, float]]:
    """ONE image's NMSResult (tensors or numpy arrays) -> the reference's
    result tuples [(klass, conf, x, y, w, h)] in pixel coordinates (float64
    products), pick order — the shape the reference's Detector.perform
    returns."""

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    boxes = np.asarray(host(result.boxes), dtype=np.float64) * image_size
    scores = np.asarray(host(result.scores), dtype=np.float64)
    klass = np.asarray(host(result.klass))
    n = int(host(result.count))
    return [(int(klass[i]), float(scores[i]), float(boxes[i, 0]),
             float(boxes[i, 1]), float(boxes[i, 2]), float(boxes[i, 3]))
            for i in range(n)]
