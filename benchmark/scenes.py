"""The frame pool: seeded synthetic scenes as camera JPEGs.

The scene generator is the benchmark's frozen copy of the program's
``data/synth.py`` (``make_scene`` with the 80-class palette; numpy only,
the same seed gives the same pixels): smooth camera-clean backgrounds
with one to three shapes of 9 geometries in 9 hue families. Each scene
is encoded with Pillow at ``quality`` and 4:2:0 chroma, the frames a
phone camera sends.

:func:`make_pool` draws one scene seed per pool slot from the run's
``--seed`` (``numpy.random.SeedSequence``) and renders the pool in
worker processes.
"""

from __future__ import annotations

import io
import math
from typing import List, Sequence, Tuple

import numpy as np

MIN_SIZE = 56
MAX_SIZE = 168


def _background(rng: np.random.RandomState, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = rng.uniform(40, 160, 3).astype(np.float32)
    gx = rng.uniform(-60, 60, 3).astype(np.float32)
    gy = rng.uniform(-60, 60, 3).astype(np.float32)
    img = base[None, None] + gx[None, None] * xx[..., None] \
        + gy[None, None] * yy[..., None]
    for _ in range(rng.randint(2, 5)):
        cx, cy = rng.uniform(0, 1, 2)
        rad = rng.uniform(0.15, 0.5)
        amp = rng.uniform(-35, 35, 3).astype(np.float32)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        img += amp[None, None] * np.exp(-d2 / (2 * rad * rad))[..., None]
    img += rng.randn(size, size, 3).astype(np.float32) * 2.0
    return img


def _hsv_to_rgb(h: float, s: float, v: float) -> np.ndarray:
    h = (h % 360.0) / 60.0
    i = int(h) % 6
    f = h - int(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r, g, b = [(v, t, p), (q, v, p), (p, v, t),
               (p, q, v), (t, p, v), (v, p, q)][i]
    return np.array([r * 255, g * 255, b * 255], np.float32)


def _object_color_hue(rng, family: int, bg_mean: np.ndarray) -> np.ndarray:
    c = None
    for attempt in range(6):
        h = family * 40.0 + rng.uniform(-12.0, 12.0)
        s = rng.uniform(0.85, 1.0)
        v = rng.uniform(0.7, 1.0) if attempt % 2 == 0 else \
            rng.uniform(0.3, 0.5)
        c = _hsv_to_rgb(h, s, v)
        if np.abs(c - bg_mean).sum() > 130:
            return c
    return c


def _shape_mask_and_box(rng, klass: int, size: int):
    s = rng.randint(MIN_SIZE, MAX_SIZE + 1)
    aspect = rng.uniform(0.7, 1.4)
    if klass == 6:
        aspect = rng.uniform(3.2, 4.5)
    w_px = s * math.sqrt(aspect)
    h_px = s / math.sqrt(aspect)
    theta = rng.uniform(0, 2 * math.pi)
    verts = None
    if klass in (0, 3, 7, 8):
        bw, bh = w_px, h_px
    elif klass in (1, 4, 5, 6):
        c, sn = abs(math.cos(theta)), abs(math.sin(theta))
        bw = w_px * c + h_px * sn
        bh = w_px * sn + h_px * c
    else:
        verts = np.array([[0.0, -h_px / 2], [-w_px / 2, h_px / 2],
                          [w_px / 2, h_px / 2]], np.float32)
        rot = np.array([[math.cos(theta), -math.sin(theta)],
                        [math.sin(theta), math.cos(theta)]], np.float32)
        verts = verts @ rot.T
        bw = float(verts[:, 0].max() - verts[:, 0].min())
        bh = float(verts[:, 1].max() - verts[:, 1].min())
    margin = 4
    if bw + 2 * margin > size or bh + 2 * margin > size:
        raise ValueError(f"shape extent {bw:.0f}x{bh:.0f} exceeds {size}")
    cx = rng.uniform(bw / 2 + margin, size - bw / 2 - margin)
    cy = rng.uniform(bh / 2 + margin, size - bh / 2 - margin)
    x0 = int(math.floor(cx - bw / 2))
    y0 = int(math.floor(cy - bh / 2))
    x1 = int(math.ceil(cx + bw / 2))
    y1 = int(math.ceil(cy + bh / 2))
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    xr, yr = xx - cx, yy - cy
    if klass == 0:
        mask = (xr / (w_px / 2)) ** 2 + (yr / (h_px / 2)) ** 2 <= 1.0
    elif klass == 3:
        r2 = (xr / (w_px / 2)) ** 2 + (yr / (h_px / 2)) ** 2
        mask = (r2 <= 1.0) & (r2 >= 0.55 ** 2)
    elif klass == 7:
        mask = np.zeros(xr.shape, bool)
        r = min(w_px, h_px) / 9.0
        for gy in (-1, 0, 1):
            for gx in (-1, 0, 1):
                dx = xr - gx * (w_px / 2 - r)
                dy = yr - gy * (h_px / 2 - r)
                mask |= dx * dx + dy * dy <= r * r
    elif klass == 8:
        inside = (np.abs(xr) <= w_px / 2) & (np.abs(yr) <= h_px / 2)
        period = max(6.0, min(w_px, h_px) / 4.0)
        band = ((xr + yr) / period) % 1.0 < 0.55
        mask = inside & band
        mask |= inside & (np.abs(xr) >= w_px / 2 - 1.5)
        mask |= inside & (np.abs(yr) >= h_px / 2 - 1.5)
    elif klass in (1, 4, 5, 6):
        u = xr * math.cos(theta) + yr * math.sin(theta)
        v = -xr * math.sin(theta) + yr * math.cos(theta)
        in_rect = (np.abs(u) <= w_px / 2) & (np.abs(v) <= h_px / 2)
        if klass in (1, 6):
            mask = in_rect
        elif klass == 4:
            t = 0.18 * min(w_px, h_px)
            inner = (np.abs(u) <= w_px / 2 - t) & (np.abs(v) <= h_px / 2 - t)
            mask = in_rect & ~inner
        else:
            mask = ((np.abs(u) <= w_px / 6) & (np.abs(v) <= h_px / 2)) | (
                (np.abs(u) <= w_px / 2) & (np.abs(v) <= h_px / 6))
    else:
        pos = np.ones(xr.shape, bool)
        neg = np.ones(xr.shape, bool)
        for i in range(3):
            ax, ay = verts[i]
            bx, by = verts[(i + 1) % 3]
            cross = (bx - ax) * (yr - ay) - (by - ay) * (xr - ax)
            pos &= cross >= 0
            neg &= cross <= 0
        mask = pos | neg
    ys, xs = np.nonzero(mask)
    gx0, gx1 = x0 + xs.min(), x0 + xs.max() + 1
    gy0, gy1 = y0 + ys.min(), y0 + ys.max() + 1
    box = ((gx0 + gx1) / 2.0 / size, (gy0 + gy1) / 2.0 / size,
           (gx1 - gx0) / size, (gy1 - gy0) / size)
    return mask, (y0, x0), box


def _iou(a, b) -> float:
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def make_scene(seed: int, size: int = 416, max_objects: int = 3,
               num_classes: int = 80) -> np.ndarray:
    """One scene's (size, size, 3) uint8 pixels (80-class palette)."""
    rng = np.random.RandomState(seed)
    img = _background(rng, size)
    boxes: List[Tuple[float, float, float, float]] = []
    n_obj = rng.randint(1, max_objects + 1)
    attempts = 0
    while len(boxes) < n_obj and attempts < 20:
        attempts += 1
        klass = rng.randint(num_classes)
        mask, (y0, x0), box = _shape_mask_and_box(rng, klass % 9, size)
        if any(_iou(box, b) > 0.25 for b in boxes):
            continue
        h, w = mask.shape
        patch = img[y0:y0 + h, x0:x0 + w]
        bg_mean = patch[mask].mean(axis=0)
        color = _object_color_hue(rng, klass // 9, bg_mean)
        patch[mask] = color[None, :] + rng.randn(int(mask.sum()), 3) * 2.0
        boxes.append(box)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img: np.ndarray, quality: int) -> bytes:
    """Pillow JPEG at ``quality`` with 4:2:0 chroma."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(quality),
                              subsampling=2)
    return buf.getvalue()


def scene_seeds(seed: int, n: int) -> List[int]:
    """The pool's scene seeds (each < 2**32) for a run's ``--seed``."""
    ss = np.random.SeedSequence(seed % (1 << 128))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]


def _render(args) -> bytes:
    scene_seed, size, max_objects, quality = args
    return encode(make_scene(scene_seed, size, max_objects), quality)


def make_pool(seed: int, mix: dict, size: int, workers: int = 4):
    """Start rendering the mix's pool; returns a callable that waits and
    gives the JPEGs (pool slot order). The worker processes are spawned
    (a fresh interpreter each) and joined before the callable returns."""
    import multiprocessing as mp

    jobs = [(s, size, int(mix["objects_max"]), int(mix["jpeg_quality"]))
            for s in scene_seeds(seed, int(mix["pool"]))]
    if workers <= 1:
        out = [_render(j) for j in jobs]
        return lambda: out
    pool = mp.get_context("spawn").Pool(workers)
    pending = pool.map_async(_render, jobs, chunksize=8)

    def wait() -> List[bytes]:
        try:
            return pending.get(timeout=600)
        finally:
            pool.terminate()
            pool.join()
    return wait


def pool_blob(jpegs: Sequence[bytes]) -> bytes:
    """The pool as one byte string: a count, then length-prefixed JPEGs."""
    import struct

    parts = [struct.pack(">I", len(jpegs))]
    for j in jpegs:
        parts.append(struct.pack(">I", len(j)))
        parts.append(j)
    return b"".join(parts)
