"""The comparison that decides ``correct``.

Every answered frame's records (what the timed path produced) are held
against the reference's records for the same JPEG. Per frame, records
are paired greedily, the reference's in descending confidence, each
with the unpaired record of the same class that overlaps it most (IoU at
least 0.5). A record is off by k when its pair's confidence differs by
k wire units (1/255) or more, or one of x, y, w, h by k pixels or more;
a record left unpaired is off by k when its confidence lies k units or
more above the threshold (the other side scored it below). One wire
unit is what truncation alone can make of any difference, two are not.

- ``off<k>_share`` for k in :data:`OFF_UNITS` (a cell's limits name the
  ones held): records off by k over all records (pairs and unpaired);
- beside it, for the record: ``conf_gap`` / ``box_gap_px`` (the worst
  pair or unpaired record), ``conf_mean`` / ``box_mean_px`` (over the
  pairs), ``unpaired_share``.

The run is correct when each limited number is at or under its limit
(the cell's ``limits``) and some records were compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_records(blob: bytes) -> np.ndarray:
    """(n, 6) int64 records (klass, conf255, x, y, w, h) of a blob of
    ``>BBhhhh`` records."""
    n = len(blob) // 10
    if n == 0:
        return np.zeros((0, 6), np.int64)
    a = np.frombuffer(blob[:n * 10], dtype=np.dtype(
        [("k", "u1"), ("c", "u1"), ("x", ">i2"), ("y", ">i2"),
         ("w", ">i2"), ("h", ">i2")]))
    return np.stack([a[f].astype(np.int64) for f in a.dtype.names], axis=1)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0, min(a[2] + a[4], b[2] + b[4]) - max(a[2], b[2]))
    iy = max(0, min(a[3] + a[5], b[3] + b[5]) - max(a[3], b[3]))
    inter = ix * iy
    union = a[4] * a[5] + b[4] * b[5] - inter
    return inter / union if union > 0 else 0.0


OFF_UNITS = (2, 4, 8)


def compare_frame(got: np.ndarray, ref: np.ndarray, threshold: float):
    """(conf gap, box gap px, pairs, unpaired, summed conf gaps and box
    gaps of the pairs, records off by each k of OFF_UNITS) of one frame."""
    thr = threshold * 255.0
    used = [False] * len(got)
    conf_gap = box_gap = conf_sum = box_sum = 0.0
    pairs = unpaired = 0
    off = np.zeros(len(OFF_UNITS), np.int64)
    units = np.asarray(OFF_UNITS)
    for r in ref[np.argsort(-ref[:, 1], kind="stable")]:
        best, best_iou = -1, 0.5
        for j, g in enumerate(got):
            if used[j] or g[0] != r[0]:
                continue
            iou = _iou(g, r)
            if iou >= best_iou:
                best, best_iou = j, iou
        if best < 0:
            unpaired += 1
            conf_gap = max(conf_gap, r[1] - thr)
            off += r[1] - thr >= units
            continue
        used[best] = True
        pairs += 1
        g = got[best]
        dc = abs(int(g[1]) - int(r[1]))
        db = float(np.abs(g[2:] - r[2:]).max())
        conf_gap, box_gap = max(conf_gap, dc), max(box_gap, db)
        conf_sum += dc
        box_sum += db
        off += (dc >= units) | (db >= units)
    for j, g in enumerate(got):
        if not used[j]:
            unpaired += 1
            conf_gap = max(conf_gap, g[1] - thr)
            off += g[1] - thr >= units
    return float(conf_gap), box_gap, pairs, unpaired, conf_sum, box_sum, off


def compare(answers: Sequence[Tuple[int, bytes]],
            refs: Dict[int, np.ndarray], threshold: float) -> dict:
    """Numbers over ``answers`` ((pool slot, record blob) per answered
    frame) against ``refs`` (pool slot -> reference records)."""
    conf_gap = box_gap = conf_sum = box_sum = 0.0
    pairs = unpaired = 0
    off = np.zeros(len(OFF_UNITS), np.int64)
    for slot, blob in answers:
        c, b, p, u, cs, bs, o = compare_frame(parse_records(blob),
                                              refs[slot], threshold)
        conf_gap, box_gap = max(conf_gap, c), max(box_gap, b)
        pairs += p
        unpaired += u
        conf_sum += cs
        box_sum += bs
        off += o
    n = max(pairs + unpaired, 1)
    return {**{f"off{k}_share": int(o) / n for k, o in zip(OFF_UNITS, off)},
            "conf_gap": conf_gap, "box_gap_px": box_gap,
            "conf_mean": conf_sum / max(pairs, 1),
            "box_mean_px": box_sum / max(pairs, 1),
            "unpaired_share": unpaired / max(pairs + unpaired, 1),
            "frames": len(answers), "pairs": pairs, "unpaired": unpaired}


def verdict(numbers: dict, limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for each limited number."""
    checks = {k: {"value": numbers[k], "limit": float(v)}
              for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def reference_for(cfg: dict, weights, jpegs: List[bytes], slots,
                  threshold: float, device) -> Dict[int, np.ndarray]:
    """The reference's records for each pool slot in ``slots``."""
    from benchmark.reference.detect import reference_records

    order = sorted(set(slots))
    recs = reference_records(cfg, weights, [jpegs[s] for s in order],
                             threshold, device)
    return dict(zip(order, recs))
