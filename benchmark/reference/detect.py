"""JPEG bytes -> the wire's detection records, the plain way.

- Decode: Pillow (libjpeg's integer IDCT and fancy chroma upsampling).
- Heads: :class:`.darknet.DarknetF32` in float32 with TF32 off.
- Box decode (YOLOv3, with YOLOv4's grid sensitivity): centre ``((col
  + (sxy * sigmoid(tx) - (sxy - 1) / 2)) / W, (row + ...) / H)``, where
  ``sxy`` is the ``yolo`` layer's ``scale_x_y`` (1 where it has none, as
  in YOLOv3), size ``anchor * exp(min(t, 15)) / 416`` (the clamp only
  guards against overflow), confidence ``sigmoid(obj) *
  sigmoid(max class logit)``, class ``argmax + 1``, box as normalised
  top-left ``(x, y, w, h)``. Candidates in head order, row-major, anchor
  minor.
- Gaussian soft-NMS as the protocol's server defines it: keep the
  candidates at or above the threshold (the ``max_candidates`` best, in
  a stable descending order), then pick the best score while it is at or
  above the threshold, at most ``max_detections`` times, and decay every
  other score by ``exp(-3 * ov^2)``, where ``ov`` is the intersection
  over the PICKED box's area.
- Records: ``klass:u8, trunc(conf*255):u8, trunc(x*416), trunc(y*416),
  trunc(w*416), trunc(h*416)`` as saturated int16.
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference.darknet import DarknetF32


def decode_jpeg(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _candidates(heads: List[torch.Tensor], cfg: dict):
    """Per-frame (boxes (N, 4), scores (N,), klass (N,)) float32 arrays
    over every head, reference order."""
    size = float(cfg["width"])
    anchors = cfg["anchors"]
    yolos = [l for l in cfg["layers"] if l["type"] == "yolo"]
    boxes, scores, klass = [], [], []
    for h, l in zip(heads, yolos):
        mask, sxy = l["mask"], float(l.get("scale_x_y", 1.0))
        b, rows, cols, na, _ = h.shape
        dev = h.device
        a = torch.tensor([anchors[m] for m in mask], dtype=torch.float32,
                         device=dev)
        gy = torch.arange(rows, dtype=torch.float32, device=dev)[
            :, None, None]
        gx = torch.arange(cols, dtype=torch.float32, device=dev)[
            None, :, None]
        cx = (gx + (torch.sigmoid(h[..., 0]) * sxy - (sxy - 1) / 2)) / cols
        cy = (gy + (torch.sigmoid(h[..., 1]) * sxy - (sxy - 1) / 2)) / rows
        bw = a[:, 0] * torch.exp(torch.clamp(h[..., 2], max=15.0)) / size
        bh = a[:, 1] * torch.exp(torch.clamp(h[..., 3], max=15.0)) / size
        cmax, cidx = torch.max(h[..., 5:], dim=-1)
        s = torch.sigmoid(h[..., 4]) * torch.sigmoid(cmax)
        boxes.append(torch.stack([cx - bw / 2, cy - bh / 2, bw, bh],
                                 dim=-1).reshape(b, -1, 4))
        scores.append(s.reshape(b, -1))
        klass.append((cidx + 1).reshape(b, -1))
    return (torch.cat(boxes, 1).cpu().numpy(),
            torch.cat(scores, 1).cpu().numpy(),
            torch.cat(klass, 1).cpu().numpy())


def soft_nms(boxes: np.ndarray, scores: np.ndarray, klass: np.ndarray,
             threshold: np.float32, max_candidates: int,
             max_detections: int):
    """One frame's picks: (boxes (n, 4), scores (n,), klass (n,))."""
    thr = np.float32(threshold)
    keep = np.nonzero(scores >= thr)[0]
    order = keep[np.argsort(-scores[keep], kind="stable")][:max_candidates]
    bx = boxes[order].astype(np.float32)
    cur = scores[order].astype(np.float32).copy()
    kl = klass[order]
    picks = []
    while len(picks) < max_detections and cur.size and cur.max() >= thr:
        m = int(np.argmax(cur))
        picks.append((bx[m].copy(), np.float32(cur[m]), int(kl[m])))
        cur[m] = -np.inf
        px, py, pw, ph = bx[m]
        ix = np.maximum(px, bx[:, 0])
        iy = np.maximum(py, bx[:, 1])
        iw = np.minimum(px + pw, bx[:, 0] + bx[:, 2]) - ix
        ih = np.minimum(py + ph, bx[:, 1] + bx[:, 3]) - iy
        ov = np.where((iw > 0) & (ih > 0), (iw * ih) / (pw * ph),
                      np.float32(0)).astype(np.float32)
        cur = cur * np.exp(np.float32(-3.0) * ov * ov).astype(np.float32)
    if not picks:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))
    return (np.stack([p[0] for p in picks]),
            np.asarray([p[1] for p in picks], np.float32),
            np.asarray([p[2] for p in picks], np.int64))


def records(boxes: np.ndarray, scores: np.ndarray, klass: np.ndarray,
            size: int) -> np.ndarray:
    """(n, 6) int64 wire records: klass, conf255, x, y, w, h."""
    coords = np.nan_to_num(boxes.astype(np.float32) * np.float32(size))
    coords = np.clip(np.trunc(coords), -32768, 32767).astype(np.int64)
    conf = np.clip(np.trunc(np.nan_to_num(scores) * np.float32(255)), 0,
                   255).astype(np.int64)
    return np.concatenate([klass.astype(np.int64)[:, None], conf[:, None],
                           coords], axis=1)


def reference_records(cfg: dict, weights: Dict[str, dict],
                      jpegs: Sequence[bytes], threshold: float, device,
                      block: int = 16) -> List[np.ndarray]:
    """The reference's (n, 6) records for each JPEG, computed in blocks
    of ``block`` frames so that it fits beside nothing else."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = DarknetF32(cfg, weights, device)
        out: List[np.ndarray] = []
        for i in range(0, len(jpegs), block):
            frames = np.stack([decode_jpeg(j) for j in jpegs[i:i + block]])
            heads = net(torch.from_numpy(frames))
            bxs, scs, kls = _candidates(heads, cfg)
            for f in range(len(frames)):
                pb, ps, pk = soft_nms(bxs[f], scs[f], kls[f],
                                      np.float32(threshold),
                                      int(cfg["max_candidates"]),
                                      int(cfg["max_detections"]))
                out.append(records(pb, ps, pk, int(cfg["width"])))
        del net
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
