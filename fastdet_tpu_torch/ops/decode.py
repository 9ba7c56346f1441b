"""Vectorized YOLO head decode (batched), in PyTorch.

Counterpart of the JAX package's ops/decode.py, with a leading batch
dimension:

- box center  x = (x0 + sigmoid(tx)) / cols,  y = (y0 + sigmoid(ty)) / rows
- box size    w = anchor_w * exp(min(tw, 15)) / image,  likewise h (the
  exp clamp keeps garbage logits from overflowing to inf)
- confidence  conf = sigmoid(obj) * sigmoid(max class logit)
- class id    argmax + 1 (1-indexed; first maximum on ties)
- bbox        normalized top-left (x - w/2, y - h/2, w, h)

Candidate order is scale-major, row-major, anchor-minor — the
reference's loop nesting — and the top-K candidate budget keeps it among
equal scores: ``lax.top_k`` is stable and ``torch.topk`` is not, so the
budget is a STABLE descending sort.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from fastdet_tpu_torch.models.yolov3 import ModelSpec

Comps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def decode_head_components(head: torch.Tensor, anchors: torch.Tensor,
                           num_classes: int, image_size: int):
    """Decode one scale of a batch: head (B, H, W, 3*(5+C)) float32 ->
    ((bx, by, bw, bh) each (B, N), scores (B, N), klass (B, N) int32)."""
    b, rows, cols = head.shape[:3]
    na = anchors.shape[0]
    n = rows * cols * na
    m = head.reshape(b, n, 5 + num_classes)
    dev = head.device
    txy = torch.sigmoid(m[..., 0:2])
    xs = torch.arange(cols, dtype=torch.float32, device=dev)
    ys = torch.arange(rows, dtype=torch.float32, device=dev)
    gx0 = xs[None, :, None].expand(rows, cols, na).reshape(n)
    gy0 = ys[:, None, None].expand(rows, cols, na).reshape(n)
    gx = (gx0 + txy[..., 0]) / cols
    gy = (gy0 + txy[..., 1]) / rows
    wh = (anchors.repeat(rows * cols, 1)
          * torch.exp(torch.clamp(m[..., 2:4], max=15.0)) / image_size)
    obj = torch.sigmoid(m[..., 4])
    cls_max, klass = torch.max(m[..., 5:], dim=-1)
    scores = obj * torch.sigmoid(cls_max)
    comps = (gx - wh[..., 0] / 2, gy - wh[..., 1] / 2, wh[..., 0], wh[..., 1])
    return comps, scores, (klass + 1).to(torch.int32)


_ANCHORS: dict = {}


def head_anchors(spec: ModelSpec, device: torch.device):
    """Each scale's (A, 2) float32 anchors on ``device``, made once per
    (anchors, device): a forward uploads nothing from the host, so a CUDA
    graph can capture it."""
    key = (spec.anchors, device)
    out = _ANCHORS.get(key)
    if out is None:
        # the first writer wins, so a captured graph's anchors stay alive
        out = _ANCHORS.setdefault(key, [
            torch.tensor(a, dtype=torch.float32, device=device)
            for a in spec.anchors])
    return out


def decode_all_components(heads: Sequence[torch.Tensor], spec: ModelSpec):
    """Decode and concatenate every scale, reference order."""
    cs, ss, ks = [], [], []
    for head, a in zip(heads, head_anchors(spec, heads[0].device)):
        c, s, k = decode_head_components(head, a, spec.num_classes,
                                         spec.image_size)
        cs.append(c)
        ss.append(s)
        ks.append(k)
    comps = tuple(torch.cat([c[i] for c in cs], dim=1) for i in range(4))
    return comps, torch.cat(ss, dim=1), torch.cat(ks, dim=1)


def select_candidates_components(comps: Comps, scores: torch.Tensor,
                                 klass: torch.Tensor,
                                 thresholds: torch.Tensor,
                                 max_candidates: int):
    """Top-K candidates with score >= threshold per image: boxes (B, K,
    4), scores (B, K) (-1 where invalid), klass (B, K) (0 where invalid).
    Sub-threshold entries are masked to -1 so they never win the NMS."""
    thr = thresholds[:, None]
    masked = torch.where(scores >= thr, scores, torch.full_like(scores, -1.0))
    kk = min(max_candidates, scores.shape[1])
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, idx = top[:, :kk], idx[:, :kk]
    sel_boxes = torch.stack([torch.gather(c, 1, idx) for c in comps], dim=-1)
    sel_klass = torch.gather(klass, 1, idx)
    valid = top >= thr
    return (sel_boxes, torch.where(valid, top, torch.full_like(top, -1.0)),
            torch.where(valid, sel_klass, torch.zeros_like(sel_klass)))


def decode_head(head: torch.Tensor, anchors: torch.Tensor, num_classes: int,
                image_size: int):
    """Decode one scale of ONE image: head (H, W, 3*(5+C)) -> (boxes
    (N, 4), scores (N,), klass (N,) int32), the JAX ``decode_head``."""
    comps, scores, klass = decode_head_components(
        head[None], anchors, num_classes, image_size)
    return torch.stack([c[0] for c in comps], dim=-1), scores[0], klass[0]


def decode_all(heads: Sequence[torch.Tensor], spec: ModelSpec):
    """Decode and concatenate every scale of ONE image (per-scale (H, W,
    3*(5+C)) heads), reference order: (boxes (N, 4), scores, klass)."""
    comps, scores, klass = decode_all_components([h[None] for h in heads],
                                                 spec)
    return torch.stack([c[0] for c in comps], dim=-1), scores[0], klass[0]


def select_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                      klass: torch.Tensor, threshold, max_candidates: int):
    """The top-K candidates of ONE image with score >= ``threshold`` (a
    scalar): boxes (K, 4), scores (K,) (-1 where invalid), klass (K,) (0
    where invalid), the JAX ``select_candidates``."""
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=scores.device).reshape(1)
    comps = tuple(boxes[None, :, i] for i in range(4))
    b, s, k = select_candidates_components(comps, scores[None], klass[None],
                                           thr, max_candidates)
    return b[0], s[0], k[0]
