"""Training: YOLOv3 loss, target building and the train step, in PyTorch.

The port of the JAX package's ``fastdet_tpu/parallel/train.py``. Target
building is host numpy, copied line for line (the same boxes give the
same arrays). The loss is the same YOLOv3 formulation, per scale:

- coordinate loss on the positive cells: MSE on sigmoid(tx,ty) against the
  cell-relative offsets and on raw (tw,th) against log-space targets,
  weighted by (2 - w*h) to boost small boxes;
- objectness BCE everywhere (noobj term down-weighted);
- per-class BCE on the positive cells (multi-label, like the paper).

The step runs the forward and backward of :class:`TrainNet` on one
device (the card by default), ``torch.optim.AdamW`` with weight decay on
the conv kernels only (the update of ``optax.adamw`` with the JAX
package's mask), then moves BN's running statistics by the EMA of this
step's batch statistics, after the optimizer update as in the JAX step.

Differences from the JAX module: :class:`TrainState` holds the network
and its optimizer (torch optimizers are bound to their parameters), so
:func:`make_train_step` takes no optimizer and the step updates the state
in place; the sharded step over a device mesh (``make_sharded_train_step``,
``shard_batch``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdet_tpu_torch.models import yolov3
from fastdet_tpu_torch.models.yolov3 import ModelSpec, TrainNet

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5
BN_MOMENTUM = 0.97   # running-stat EMA factor per step


# ---------------------------------------------------------------------------
# Target building (host-side, numpy)
# ---------------------------------------------------------------------------

def build_targets(
    spec: ModelSpec,
    gt_boxes: Sequence[np.ndarray],    # per image: (N, 4) normalized cx cy w h
    gt_labels: Sequence[np.ndarray],   # per image: (N,) int, 0-indexed classes
    grids: Optional[Sequence[int]] = None,
    multi_anchor_thr: Optional[float] = 0.35,
) -> List[np.ndarray]:
    """Dense per-scale targets (B, H, W, 3, 5+C).

    Channel layout: [tx_off, ty_off, tw_log, th_log, obj, one-hot classes].
    Each ground-truth box claims the best-matching FREE anchor slot (max
    IoU of width/height against the anchor table, at its center cell for
    that anchor's scale) — and, when ``multi_anchor_thr`` is set, every
    other free anchor whose wh-IoU clears the threshold too.

    Collision-aware: a box whose best slot already holds another box's
    primary assignment overflows to its next-best anchor by wh-IoU
    (another anchor of the same cell, or another scale). Primaries may
    evict threshold-extras but never another primary; candidates are
    floored at wh-IoU >= max(0.15, iou_best/2).
    """
    b = len(gt_boxes)
    c = spec.num_classes
    grids = list(grids) if grids is not None else yolov3.head_grid_sizes(spec)
    targets = [np.zeros((b, g, g, 3, 5 + c), np.float32) for g in grids]

    anchors = np.asarray(spec.anchors, np.float32)       # (S, 3, 2) pixels
    flat = anchors.reshape(-1, 2)                         # (S*3, 2)

    def slot_of(a, cx, cy):
        s, k = divmod(a, anchors.shape[1])
        g = grids[s]
        gx = min(int(cx * g), g - 1)
        gy = min(int(cy * g), g - 1)
        return s, k, gy, gx

    for i in range(b):
        boxes = np.asarray(gt_boxes[i], np.float32).reshape(-1, 4)
        labels = np.asarray(gt_labels[i]).reshape(-1)
        occ: Dict[Tuple[int, int, int, int], bool] = {}  # slot -> is_primary
        for (cx, cy, w, h), lab in zip(boxes, labels):
            if lab < 0:
                continue   # negative label = ignore marker (darknet -1)
            if lab >= spec.num_classes:
                raise ValueError(
                    f"label {int(lab)} out of range for "
                    f"{spec.num_classes}-class model (image {i})")
            wh = np.array([w, h], np.float32) * spec.image_size
            inter = np.minimum(flat, wh).prod(axis=1)
            union = flat.prod(axis=1) + wh.prod() - inter
            iou = inter / np.maximum(union, 1e-9)
            order = np.argsort(-iou)
            best = int(order[0])
            floor = max(0.15, float(iou[best]) * 0.5)
            primary = best            # fallback: overwrite-best (rare)
            for a in order:
                if iou[a] < floor and a != best:
                    break
                if occ.get(slot_of(int(a), cx, cy)) is not True:
                    primary = int(a)
                    break
            chosen = [primary]
            if multi_anchor_thr is not None:
                for a in np.nonzero(iou >= multi_anchor_thr)[0].tolist():
                    if a != primary and slot_of(a, cx, cy) not in occ:
                        chosen.append(a)
            for a in chosen:
                s, k, gy, gx = slot_of(a, cx, cy)
                occ[(s, k, gy, gx)] = occ.get((s, k, gy, gx), False) \
                    or (a == primary)
                g = grids[s]
                t = targets[s][i, gy, gx, k]
                t[:] = 0.0
                t[0] = cx * g - gx
                t[1] = cy * g - gy
                t[2] = np.log(max(wh[0], 1e-6) / anchors[s, k, 0])
                t[3] = np.log(max(wh[1], 1e-6) / anchors[s, k, 1])
                t[4] = 1.0
                t[5 + int(lab)] = 1.0
    return targets


# Sparse target row layout: [scale, gy, gx, k, tx, ty, tw, th, lab];
# invalid slots carry scale = -1.
MAX_SLOTS = 32


def build_sparse_targets(
    spec: ModelSpec,
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    grids: Optional[Sequence[int]] = None,
    multi_anchor_thr: Optional[float] = 0.35,
    max_slots: int = MAX_SLOTS,
) -> np.ndarray:
    """Sparse (B, max_slots, 9) float32 form of :func:`build_targets`: the
    assigned slots only (read back from per-image dense planes, so the
    two can never drift); :func:`yolo_loss_sparse` scatters and gathers
    on the device, and flips are an O(slots) transform
    (:func:`flip_slots`)."""
    b = len(gt_boxes)
    grids = list(grids) if grids is not None else yolov3.head_grid_sizes(spec)
    out = np.full((b, max_slots, 9), -1.0, np.float32)
    for i in range(b):
        # per-image dense planes (tiny) — building the whole batch dense
        # at C=80 would transiently cost GBs of host RAM
        dense = build_targets(spec, [gt_boxes[i]], [gt_labels[i]], grids,
                              multi_anchor_thr)
        rows = []
        for s, g in enumerate(grids):
            pos = np.argwhere(dense[s][0, :, :, :, 4] > 0)
            for gy, gx, k in pos:
                t = dense[s][0, gy, gx, k]
                lab = int(np.argmax(t[5:]))
                rows.append([s, gy, gx, k, t[0], t[1], t[2], t[3], lab])
        if len(rows) > max_slots:
            raise ValueError(
                f"image {i}: {len(rows)} assigned slots exceed "
                f"max_slots={max_slots}")
        if rows:
            out[i, :len(rows)] = np.asarray(rows, np.float32)
    return out


def flip_slots(
    slots: torch.Tensor,         # (B, M, 9) float32
    fh: torch.Tensor,            # (B,) bool — horizontal flip
    fv: torch.Tensor,            # (B,) bool — vertical flip
    grids: Sequence[int],
) -> torch.Tensor:
    """Transform sparse targets for on-device image flips.

    A flipped center cx' = 1-cx maps to cell/offset
    (gx', tx') = split(g - gx - tx): for tx in (0,1) that is exactly
    (g-1-gx, 1-tx). The measure-zero tx == 0 edge clamps into the last
    cell. Invalid slots (scale = -1) pass through unchanged.
    """
    garr = torch.tensor(list(grids), dtype=torch.float32, device=slots.device)
    scale = slots[..., 0]
    valid = scale >= 0
    g = garr[torch.clamp(scale.to(torch.int32), 0, len(grids) - 1).long()]

    def _flip(gc, t):
        f = g - gc - t
        gc2 = torch.minimum(torch.clamp(torch.floor(f - 1e-6), min=0.0),
                            g - 1.0)
        return gc2, f - gc2

    gy, gx = slots[..., 1], slots[..., 2]
    ty, tx = slots[..., 5], slots[..., 4]
    gx_f, tx_f = _flip(gx, tx)
    gy_f, ty_f = _flip(gy, ty)
    fh_ = fh[:, None] & valid
    fv_ = fv[:, None] & valid
    out = slots.clone()
    out[..., 2] = torch.where(fh_, gx_f, gx)
    out[..., 4] = torch.where(fh_, tx_f, tx)
    out[..., 1] = torch.where(fv_, gy_f, gy)
    out[..., 5] = torch.where(fv_, ty_f, ty)
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (``torch.maximum`` splits the
    gradient of a tie at 0 as ``jnp.maximum`` does)."""
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _forward(net: TrainNet, images, compute_dtype, collect_bn_stats):
    if collect_bn_stats:
        return net(images, compute_dtype, with_stats=True)
    return net(images, compute_dtype), None


def _metrics(coord_l, obj_l, cls_l, b, bn_stats):
    total = (LAMBDA_COORD * coord_l + obj_l + cls_l) / b
    metrics: Dict[str, Any] = {
        "loss": total,
        "coord": coord_l / b,
        "obj": obj_l / b,
        "cls": cls_l / b,
    }
    if bn_stats is not None:
        metrics["bn_stats"] = bn_stats
    return total, metrics


def yolo_loss(
    spec: ModelSpec,
    net: TrainNet,
    images: torch.Tensor,               # (B, H, W, 3) float in [0,1]
    targets: Sequence[torch.Tensor],    # per-scale (B, g, g, 3, 5+C)
    *,
    compute_dtype=None,
    collect_bn_stats: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total, {"loss", "coord", "obj", "cls"[, "bn_stats"]}) over dense
    targets; the batch statistics come with ``collect_bn_stats``."""
    heads, bn_stats = _forward(net, images, compute_dtype, collect_bn_stats)
    b = images.shape[0]
    c = spec.num_classes
    coord_l = obj_l = cls_l = 0.0
    for head, tgt, anchors in zip(heads, targets, spec.anchors):
        g = head.shape[1]
        p = head.reshape(b, g, g, 3, 5 + c).float()
        pos = tgt[..., 4]
        # (2 - w*h) small-box boost, from the decoded target size
        aw = torch.tensor(anchors, dtype=torch.float32,
                          device=head.device)[None, None, None, :, :]
        twh = torch.exp(tgt[..., 2:4]) * aw / spec.image_size
        box_w = pos * (2.0 - twh[..., 0] * twh[..., 1])

        pxy = torch.sigmoid(p[..., 0:2])
        coord_l = coord_l + torch.sum(
            box_w[..., None] * (pxy - tgt[..., 0:2]) ** 2
        ) + torch.sum(box_w[..., None] * (p[..., 2:4] - tgt[..., 2:4]) ** 2)

        obj_bce = _bce_logits(p[..., 4], pos)
        obj_l = obj_l + torch.sum(
            torch.where(pos > 0.5, obj_bce, LAMBDA_NOOBJ * obj_bce))

        cls_l = cls_l + torch.sum(
            pos[..., None] * _bce_logits(p[..., 5:], tgt[..., 5:]))
    return _metrics(coord_l, obj_l, cls_l, b, bn_stats)


def yolo_loss_sparse(
    spec: ModelSpec,
    net: TrainNet,
    images: torch.Tensor,               # (B, H, W, 3) float in [0,1]
    slots: torch.Tensor,                # (B, M, 9) sparse targets
    *,
    compute_dtype=None,
    collect_bn_stats: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Same loss as :func:`yolo_loss`, from sparse slot rows: the
    coordinate and class terms gather head activations at the assigned
    slots (advanced indexing), the objectness map is a max-scatter of
    ones into each scale's (g, g, 3) plane (``scatter_reduce`` "amax" on
    a flat index, the JAX ``.at[...].max``)."""
    heads, bn_stats = _forward(net, images, compute_dtype, collect_bn_stats)
    b, m = images.shape[0], slots.shape[1]
    c = spec.num_classes
    scale_col = slots[..., 0]
    bidx = torch.arange(b, device=slots.device)[:, None].expand(b, m)
    coord_l = obj_l = cls_l = 0.0
    for s, (head, anchors) in enumerate(zip(heads, spec.anchors)):
        g = head.shape[1]
        p = head.reshape(b, g, g, 3, 5 + c).float()
        sel = scale_col == s
        gy = torch.clamp(slots[..., 1].to(torch.int64), 0, g - 1)
        gx = torch.clamp(slots[..., 2].to(torch.int64), 0, g - 1)
        k = torch.clamp(slots[..., 3].to(torch.int64), 0, 2)
        pred = p[bidx, gy, gx, k]                      # (B, M, 5+C)
        txy = slots[..., 4:6]
        twh = slots[..., 6:8]
        lab = torch.clamp(slots[..., 8].to(torch.int64), 0, c - 1)
        aw = torch.tensor(anchors, dtype=torch.float32,
                          device=slots.device)[k]      # (B, M, 2)
        wh_dec = torch.exp(twh) * aw / spec.image_size
        box_w = torch.where(sel, 2.0 - wh_dec[..., 0] * wh_dec[..., 1], 0.0)
        pxy = torch.sigmoid(pred[..., 0:2])
        coord_l = coord_l + torch.sum(box_w[..., None] * (pxy - txy) ** 2) \
            + torch.sum(box_w[..., None] * (pred[..., 2:4] - twh) ** 2)
        onehot = F.one_hot(lab, c).to(torch.float32)
        cls_l = cls_l + torch.sum(torch.where(
            sel, torch.sum(_bce_logits(pred[..., 5:], onehot), -1), 0.0))
        flat = (((bidx * g + gy) * g + gx) * 3 + k).reshape(-1)
        pos = torch.zeros(b * g * g * 3, dtype=torch.float32,
                          device=slots.device).scatter_reduce(
            0, flat, sel.to(torch.float32).reshape(-1), "amax",
            include_self=True).view(b, g, g, 3)
        obj_bce = _bce_logits(p[..., 4], pos)
        obj_l = obj_l + torch.sum(
            torch.where(pos > 0.5, obj_bce, LAMBDA_NOOBJ * obj_bce))
    return _metrics(coord_l, obj_l, cls_l, b, bn_stats)


# ---------------------------------------------------------------------------
# Train state / step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    net: TrainNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def decay_mask(net: TrainNet) -> Dict[str, bool]:
    """{parameter name: decayed}: weight decay applies to conv kernels
    only (the JAX package's ``_decay_mask``); BN gamma/beta and the head
    biases are not decayed, and the running statistics are buffers."""
    return {name: name.endswith(".w") for name, _ in net.named_parameters()}


def make_optimizer(net: TrainNet, lr: float = 1e-3,
                   weight_decay: float = 5e-4) -> torch.optim.AdamW:
    """AdamW over ``net``: betas (0.9, 0.999), eps 1e-8, decoupled weight
    decay on the conv kernels only (two parameter groups) — the update
    of ``optax.adamw(lr, weight_decay=..., mask=_decay_mask)``."""
    mask = decay_mask(net)
    groups = {True: [], False: []}
    for name, p in net.named_parameters():
        groups[mask[name]].append(p)
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(spec: ModelSpec, params: Dict[str, Any], *,
                     lr: float = 1e-3, weight_decay: float = 5e-4,
                     device="cuda") -> TrainState:
    """A step-0 state from the unfolded numpy tree ``params`` on
    ``device`` (the card by default)."""
    net = TrainNet.from_params(spec, params, device=device)
    return TrainState(net, make_optimizer(net, lr, weight_decay), 0)


def make_train_step(spec: ModelSpec, *, compute_dtype=None,
                    sparse: bool = False):
    """The train step fn(state, images, *targets) -> (state, metrics).

    One forward and backward, the optimizer update, then the EMA of BN's
    running statistics from this step's batch statistics; ``state`` is
    updated in place. ``sparse=True`` builds the slot-row variant:
    fn(state, images, slots) with slots from :func:`build_sparse_targets`.
    The metrics are detached tensors of the loss before the update."""

    def step_fn(state: TrainState, images: torch.Tensor,
                *targets: torch.Tensor):
        net, opt = state.net, state.optimizer
        opt.zero_grad(set_to_none=True)
        if sparse:
            total, metrics = yolo_loss_sparse(
                spec, net, images, targets[0], compute_dtype=compute_dtype,
                collect_bn_stats=True)
        else:
            total, metrics = yolo_loss(
                spec, net, images, targets, compute_dtype=compute_dtype,
                collect_bn_stats=True)
        total.backward()
        opt.step()
        bn_stats = metrics.pop("bn_stats")
        # EMA the BN running statistics used by the folded inference path
        with torch.no_grad():
            for name, (mean, var) in bn_stats.items():
                conv = net.convs[name]
                conv.mean.copy_(BN_MOMENTUM * conv.mean
                                + (1 - BN_MOMENTUM) * mean)
                conv.var.copy_(BN_MOMENTUM * conv.var
                               + (1 - BN_MOMENTUM) * var)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn
