"""Gaussian soft-NMS with a static detection budget (batched), in PyTorch.

Counterpart of the JAX package's ops/nms.py ``soft_nms_batch``: pick the
max-score candidate, stop when it drops below the image's threshold,
decay survivors by exp(-3 * overlap^2) where overlap is the ASYMMETRIC
intersection / area(picked) (the reference's detector.py:38-42 — not
true IoU). Output slots past an image's last valid pick stay zeroed and
invalid; validity is monotone (scores only decay), so the loop stops
as soon as NO image of the batch can still make a valid pick and its
output equals the fixed ``max_det``-trip loop's. The stop test is a
host sync per trip; a soft-NMS kernel is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NMSResult(NamedTuple):
    boxes: torch.Tensor   # (B, max_det, 4) normalized top-left (x, y, w, h)
    scores: torch.Tensor  # (B, max_det) decayed confidence at pick time
    klass: torch.Tensor   # (B, max_det) int32, 1-indexed; 0 in invalid slots
    valid: torch.Tensor   # (B, max_det) bool
    count: torch.Tensor   # (B,) int32 — number of valid detections


def asymmetric_overlap(picked: torch.Tensor, boxes: torch.Tensor):
    """intersection(picked, boxes) / area(picked); 0 when disjoint.
    picked (B, 4), boxes (B, K, 4) -> (B, K)."""
    px, py, pw, ph = (picked[:, i:i + 1] for i in range(4))
    ix = torch.maximum(px, boxes[..., 0])
    iy = torch.maximum(py, boxes[..., 1])
    iw = torch.minimum(px + pw, boxes[..., 0] + boxes[..., 2]) - ix
    ih = torch.minimum(py + ph, boxes[..., 1] + boxes[..., 3]) - iy
    ov = (iw * ih) / (pw * ph)
    return torch.where((iw > 0) & (ih > 0), ov, torch.zeros_like(ov))


def soft_nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   klass: torch.Tensor, thresholds: torch.Tensor,
                   max_det: int) -> NMSResult:
    """boxes (B, K, 4), scores (B, K) (sub-threshold entries < 0), klass
    (B, K) int32, thresholds (B,) -> NMSResult."""
    bsz, k = scores.shape
    dev = scores.device
    lane = torch.arange(k, device=dev)
    cur = scores.to(torch.float32).clone()
    out_boxes = torch.zeros((bsz, max_det, 4), dtype=torch.float32,
                            device=dev)
    out_scores = torch.zeros((bsz, max_det), dtype=torch.float32, device=dev)
    out_klass = torch.zeros((bsz, max_det), dtype=torch.int32, device=dev)
    out_valid = torch.zeros((bsz, max_det), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    i = 0
    while i < max_det and bool((cur.max(dim=1).values >= thresholds).any()):
        best, m = torch.max(cur, dim=1)
        sel = lane[None, :] == m[:, None]
        is_valid = best >= thresholds
        # one-hot sums, as the JAX loop picks (keeps -0.0 -> +0.0 alike)
        picked = torch.where(sel[..., None], boxes, zero).sum(dim=1)
        picked_klass = torch.where(sel, klass, 0).sum(dim=1)
        out_boxes[:, i] = torch.where(is_valid[:, None], picked, zero)
        out_scores[:, i] = torch.where(is_valid, best, zero)
        out_klass[:, i] = torch.where(is_valid, picked_klass, 0).to(
            torch.int32)
        out_valid[:, i] = is_valid
        cur = torch.where(sel, neg_inf, cur)
        ov = asymmetric_overlap(picked, boxes)
        decay = torch.exp(-3.0 * ov * ov)
        cur = torch.where(is_valid[:, None], cur * decay, cur)
        i += 1
    return NMSResult(out_boxes, out_scores, out_klass, out_valid,
                     out_valid.sum(dim=1).to(torch.int32))


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, klass: torch.Tensor,
             threshold, max_det: int) -> NMSResult:
    """ONE image's soft-NMS, the JAX ``soft_nms``: boxes (K, 4), scores
    (K,), klass (K,), a scalar threshold -> NMSResult of (max_det, ...)
    fields and a () count. It is :func:`soft_nms_batch` on a batch of
    one, whose early exit gives the fixed ``max_det``-trip result."""
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=scores.device).reshape(1)
    res = soft_nms_batch(boxes[None], scores[None], klass[None], thr,
                         max_det)
    return NMSResult(*(a[0] for a in res))
