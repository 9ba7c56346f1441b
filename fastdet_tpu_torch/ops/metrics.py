"""Detection-quality metrics: AP / mAP / PR curves (numpy only).

The port's copy of the JAX package's ``fastdet_tpu/ops/metrics.py``,
held equal to it by tests/test_torch_synth_metrics.py. The standard
ranked-detection evaluation:

- per-class Average Precision at a single IoU threshold (greedy
  highest-IoU matching, each ground truth consumed once, all-points
  interpolation — the VOC2010-style continuous AP),
- mAP@0.5 and COCO-style mAP@[.5:.95] (mean over the 10 thresholds
  0.50, 0.55, ..., 0.95),
- the underlying precision/recall curves for inspection.

Conventions match the repo's wire/result model: detections are
``(klass, conf, x, y, w, h)`` with 1-INDEXED classes and x,y the
top-left corner in pixels; ground truth is ``boxes`` (N,4) normalized
cx cy w h + ``labels`` (N,) 0-indexed (data/synth.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.round(np.arange(0.50, 1.00, 0.05), 2))


def _iou_matrix(det_xywh: np.ndarray, gt_xywh: np.ndarray) -> np.ndarray:
    """IoU between (D,4) and (G,4) top-left-corner pixel boxes."""
    if not len(det_xywh) or not len(gt_xywh):
        return np.zeros((len(det_xywh), len(gt_xywh)), np.float64)
    d = det_xywh[:, None, :].astype(np.float64)
    g = gt_xywh[None, :, :].astype(np.float64)
    x0 = np.maximum(d[..., 0], g[..., 0])
    y0 = np.maximum(d[..., 1], g[..., 1])
    x1 = np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2])
    y1 = np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    union = d[..., 2] * d[..., 3] + g[..., 2] * g[..., 3] - inter
    return np.where(union > 0, inter / union, 0.0)


def _ap_from_pr(tp: np.ndarray, fp: np.ndarray, n_gt: int
                ) -> Tuple[float, np.ndarray, np.ndarray]:
    """All-points-interpolated AP from per-detection TP/FP flags
    (already sorted by descending confidence)."""
    if n_gt == 0:
        return float("nan"), np.zeros(0), np.zeros(0)
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    env = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0.0], recall])
    ap = float(np.sum((r[1:] - r[:-1]) * env))
    return ap, precision, recall


def evaluate_detections(
    dets_per_image: Sequence[Sequence[Tuple]],
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    num_classes: int,
    image_size: int = 416,
    iou_thresholds: Sequence[float] = (0.5,),
) -> Dict:
    """Rank-based detection evaluation over a set of images.

    Returns {"per_class": {klass(1-idx): {"ap@t": ..., "n_gt": ...}},
    "map": {t: mAP}, "map_coco": mean over thresholds if the COCO set
    was given, "pr": {(klass, t): (precision, recall)}}.
    """
    # flatten detections: (conf, image_idx, klass, box)
    flat_conf: List[float] = []
    flat_img: List[int] = []
    flat_cls: List[int] = []
    flat_box: List[Tuple[float, float, float, float]] = []
    for i, dets in enumerate(dets_per_image):
        for (k, c, x, y, w, h) in dets:
            flat_conf.append(float(c))
            flat_img.append(i)
            flat_cls.append(int(k))
            flat_box.append((float(x), float(y), float(w), float(h)))
    order = np.argsort(-np.asarray(flat_conf, np.float64), kind="stable")

    # ground truth in pixel top-left form, grouped per (image, class)
    gt_px: List[np.ndarray] = []
    for bx in gt_boxes:
        bx = np.asarray(bx, np.float64).reshape(-1, 4) * image_size
        gt_px.append(np.stack([bx[:, 0] - bx[:, 2] / 2,
                               bx[:, 1] - bx[:, 3] / 2,
                               bx[:, 2], bx[:, 3]], axis=1)
                     if len(bx) else bx.reshape(0, 4))

    out: Dict = {"per_class": {}, "map": {}, "pr": {}}
    maps = []
    for t in iou_thresholds:
        aps = []
        for klass in range(1, num_classes + 1):
            lab0 = klass - 1
            n_gt = int(sum((np.asarray(l) == lab0).sum()
                           for l in gt_labels))
            # matched flags per image for this class/threshold
            used = [np.zeros((np.asarray(l) == lab0).sum(), bool)
                    for l in gt_labels]
            gt_cls_boxes = [g[np.asarray(l) == lab0]
                            for g, l in zip(gt_px, gt_labels)]
            tp, fp = [], []
            for oi in order:
                if flat_cls[oi] != klass:
                    continue
                i = flat_img[oi]
                ious = _iou_matrix(
                    np.asarray([flat_box[oi]]), gt_cls_boxes[i])[0]
                cand = -1
                if len(ious):
                    for gi in np.argsort(-ious):
                        if ious[gi] < t:
                            break
                        if not used[i][gi]:
                            cand = int(gi)
                            break
                if cand >= 0:
                    used[i][cand] = True
                    tp.append(1.0)
                    fp.append(0.0)
                else:
                    tp.append(0.0)
                    fp.append(1.0)
            ap, prec, rec = _ap_from_pr(
                np.asarray(tp), np.asarray(fp), n_gt)
            entry = out["per_class"].setdefault(
                klass, {"n_gt": n_gt})
            entry[f"ap@{t:g}"] = None if np.isnan(ap) else round(ap, 4)
            if not np.isnan(ap):
                aps.append(ap)
            out["pr"][(klass, float(t))] = (prec, rec)
        out["map"][float(t)] = round(float(np.mean(aps)), 4) if aps else None
    vals = [v for v in out["map"].values() if v is not None]
    if len(iou_thresholds) > 1 and vals:
        out["map_coco"] = round(float(np.mean(vals)), 4)
    return out
