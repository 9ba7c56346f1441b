"""Procedurally generated labeled detection scenes (numpy only).

The port's copy of the JAX package's ``fastdet_tpu/data/synth.py``, kept
line for line: the same seed gives the same arrays, bit for bit
(tests/test_torch_synth_metrics.py), so the held-out gates of both
packages score the same frames.

Three shape classes — disc (0), box (1), tri (2) — rendered at random
size / position / rotation / color over smooth photographic-style
backgrounds, with exact axis-aligned ground-truth boxes; 9- and 80-class
palettes extend them. Class identity is SHAPE (and, for the larger
palettes, hue family), so a model that solves this corpus has learned
geometry. The committed checkpoints were trained on these scenes and are
held to the full serving stack over held-out seeds (chip_smoke.py [10]).

Everything is a pure function of the seed: train/val/test splits are
disjoint seed ranges, documented where they are used.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

SHAPE_CLASSES = ("disc", "box", "tri")

# Extended 9-class palette, the shape-world analog of the reference's
# custom 9-class RSU model (server registry grammar ``rsu:9:<model>``).
# Classes 0-2 match
# SHAPE_CLASSES; 3-8 are geometrically distinct under random rotation
# and color. make_scene(seed) with the default num_classes=3 is BYTE-
# STABLE (the committed 3-class checkpoint and its tests depend on the
# seed->scene mapping).
SHAPE_CLASSES_9 = ("disc", "box", "tri", "ring", "frame", "cross",
                   "bar", "dots", "stripes")

# 80-class palette: hue family x shape (full:80 is the reference's
# primary registry entry). Identity is the COMPOSITE of geometry
# AND hue: 9 hue families at 40-degree spacing x the 9 shapes = 81
# combos, minus the last ("pink-stripes") = 80. klass // 9 selects the
# hue family, klass % 9 the shape. Saturation/value still jitter per
# object (and drop to a dark variant when a bright one can't contrast
# with the local background), so a solver needs hue + geometry, not a
# pixel-value lookup.
HUE_FAMILIES = ("red", "amber", "lime", "green", "teal", "azure",
                "blue", "violet", "pink")
SHAPE_CLASSES_80 = tuple(
    f"{HUE_FAMILIES[k // 9]}-{SHAPE_CLASSES_9[k % 9]}" for k in range(80))

# Object size range in pixels (short side), at 416. Matches the tiny
# anchor table's middle range (models/yolov3.ANCHORS_TINY).
MIN_SIZE = 56
MAX_SIZE = 168


def _background(rng: np.random.RandomState, size: int) -> np.ndarray:
    """Smooth background: global gradient + a few low-frequency blobs.

    Kept camera-clean (low noise) so q90 re-encodes ride the engine's
    std sparse tier — the same content class the serving defaults were
    tuned on (tools/measure_sparse_stats.py).
    """
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


def _object_color(rng: np.random.RandomState, bg_mean: np.ndarray) -> np.ndarray:
    """A saturated color guaranteed to contrast with the local background."""
    for _ in range(8):
        c = rng.uniform(0, 255, 3).astype(np.float32)
        if np.abs(c - bg_mean).sum() > 180:
            return c
    return (255.0 - bg_mean).astype(np.float32)  # guaranteed fallback


def _hsv_to_rgb(h: float, s: float, v: float) -> np.ndarray:
    """h in degrees, s/v in [0,1] -> RGB float32 in [0,255]."""
    h = (h % 360.0) / 60.0
    i = int(h) % 6
    f = h - int(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r, g, b = [(v, t, p), (q, v, p), (p, v, t),
               (p, q, v), (t, p, v), (v, p, q)][i]
    return np.array([r * 255, g * 255, b * 255], np.float32)


def _object_color_hue(
    rng: np.random.RandomState, family: int, bg_mean: np.ndarray
) -> np.ndarray:
    """A color from one of the 9 hue families (identity-bearing: hue is
    half the 80-class label). Hue jitters ±12° inside the family's
    40°-wide band; saturation/value jitter freely, falling back to a
    dark variant when a bright one can't contrast with the local
    background — the hue NEVER leaves the family."""
    c = None
    for attempt in range(6):
        h = family * 40.0 + rng.uniform(-12.0, 12.0)
        s = rng.uniform(0.85, 1.0)
        v = rng.uniform(0.7, 1.0) if attempt % 2 == 0 else \
            rng.uniform(0.3, 0.5)
        c = _hsv_to_rgb(h, s, v)
        if np.abs(c - bg_mean).sum() > 130:
            return c
    return c  # keep the family even at weak contrast


def _shape_mask_and_box(
    rng: np.random.RandomState, klass: int, size: int
) -> Tuple[np.ndarray, Tuple[int, int], Tuple[float, float, float, float]]:
    """Render one shape's boolean mask on a local patch.

    Returns (mask, (y0, x0) patch origin, (cx, cy, w, h) normalized
    tight ground-truth box).
    """
    s = rng.randint(MIN_SIZE, MAX_SIZE + 1)
    aspect = rng.uniform(0.7, 1.4)
    if klass == 6:        # bar: force a long thin aspect
        aspect = rng.uniform(3.2, 4.5)
    w_px = s * math.sqrt(aspect)
    h_px = s / math.sqrt(aspect)
    theta = rng.uniform(0, 2 * math.pi)

    if klass in (0, 3, 7, 8):   # axis-aligned-extent shapes
        bw, bh = w_px, h_px
    elif klass in (1, 4, 5, 6):  # rotated-rect-extent shapes
        c, sn = abs(math.cos(theta)), abs(math.sin(theta))
        bw = w_px * c + h_px * sn
        bh = w_px * sn + h_px * c
    else:                 # tri (rotated isoceles triangle)
        verts = np.array([
            [0.0, -h_px / 2],
            [-w_px / 2, h_px / 2],
            [w_px / 2, h_px / 2],
        ], np.float32)
        rot = np.array([[math.cos(theta), -math.sin(theta)],
                        [math.sin(theta), math.cos(theta)]], np.float32)
        verts = verts @ rot.T
        bw = float(verts[:, 0].max() - verts[:, 0].min())
        bh = float(verts[:, 1].max() - verts[:, 1].min())

    margin = 4
    # Fail loudly when the sampled extent cannot fit: RandomState.uniform
    # with low > high silently samples the REVERSED interval, yielding
    # out-of-bounds centers and corrupt ground truth for small `size`
    # (advisor r3). The bar class at MAX_SIZE needs size >= ~375.
    if bw + 2 * margin > size or bh + 2 * margin > size:
        raise ValueError(
            f"shape extent {bw:.0f}x{bh:.0f}+margin exceeds scene size "
            f"{size}; MIN_SIZE/MAX_SIZE are tuned for size>=384")
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
    elif klass == 3:      # ring (annulus)
        r2 = (xr / (w_px / 2)) ** 2 + (yr / (h_px / 2)) ** 2
        mask = (r2 <= 1.0) & (r2 >= 0.55 ** 2)
    elif klass == 7:      # dots: 3x3 grid of small discs
        mask = np.zeros(xr.shape, bool)
        r = min(w_px, h_px) / 9.0
        for gy in (-1, 0, 1):
            for gx in (-1, 0, 1):
                dx = xr - gx * (w_px / 2 - r)
                dy = yr - gy * (h_px / 2 - r)
                mask |= dx * dx + dy * dy <= r * r
    elif klass == 8:      # stripes: axis-aligned patch of diagonal bands
        inside = (np.abs(xr) <= w_px / 2) & (np.abs(yr) <= h_px / 2)
        period = max(6.0, min(w_px, h_px) / 4.0)
        band = ((xr + yr) / period) % 1.0 < 0.55
        mask = inside & band
        # guarantee the tight box spans the patch (corner pixels on)
        mask |= inside & (np.abs(xr) >= w_px / 2 - 1.5)
        mask |= inside & (np.abs(yr) >= h_px / 2 - 1.5)
    elif klass in (1, 4, 5, 6):
        u = xr * math.cos(theta) + yr * math.sin(theta)
        v = -xr * math.sin(theta) + yr * math.cos(theta)
        in_rect = (np.abs(u) <= w_px / 2) & (np.abs(v) <= h_px / 2)
        if klass in (1, 6):          # box / bar: filled rectangle
            mask = in_rect
        elif klass == 4:             # frame: rectangle outline
            t = 0.18 * min(w_px, h_px)
            inner = (np.abs(u) <= w_px / 2 - t) & (np.abs(v) <= h_px / 2 - t)
            mask = in_rect & ~inner
        else:                        # cross: two crossing bars
            mask = ((np.abs(u) <= w_px / 6) & (np.abs(v) <= h_px / 2)) | (
                (np.abs(u) <= w_px / 2) & (np.abs(v) <= h_px / 6))
    else:
        mask = np.ones(xr.shape, bool)
        n = len(verts)
        # interior = same side of every edge (vertices are CCW or CW
        # consistently; use the sign of the first non-degenerate test)
        signs = []
        for i in range(n):
            ax, ay = verts[i]
            bx, by = verts[(i + 1) % n]
            cross = (bx - ax) * (yr - ay) - (by - ay) * (xr - ax)
            signs.append(cross)
        pos = np.ones(xr.shape, bool)
        neg = np.ones(xr.shape, bool)
        for cr in signs:
            pos &= cr >= 0
            neg &= cr <= 0
        mask = pos | neg

    # tight box from the actual rendered mask (sub-pixel rounding safe)
    ys, xs = np.nonzero(mask)
    gx0, gx1 = x0 + xs.min(), x0 + xs.max() + 1
    gy0, gy1 = y0 + ys.min(), y0 + ys.max() + 1
    box = (
        (gx0 + gx1) / 2.0 / size,
        (gy0 + gy1) / 2.0 / size,
        (gx1 - gx0) / size,
        (gy1 - gy0) / size,
    )
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


def make_scene(
    seed: int, size: int = 416, max_objects: int = 3,
    num_classes: int = 3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One labeled scene.

    Returns (image uint8 (size,size,3), boxes float32 (N,4) normalized
    cx cy w h, labels int32 (N,) 0-indexed into SHAPE_CLASSES (3) /
    SHAPE_CLASSES_9 (9) / SHAPE_CLASSES_80 (80). The default
    num_classes=3 path consumes the rng identically to before this
    parameter existed — the committed 3-class checkpoint's seed->scene
    mapping is frozen (and likewise the 9-class stream predates the
    80-class branch)."""
    assert num_classes in (3, 9, 80)
    rng = np.random.RandomState(seed)
    img = _background(rng, size)
    boxes: List[Tuple[float, float, float, float]] = []
    labels: List[int] = []
    n_obj = rng.randint(1, max_objects + 1)
    attempts = 0
    while len(boxes) < n_obj and attempts < 20:
        attempts += 1
        klass = rng.randint(num_classes)
        shape = klass % 9 if num_classes == 80 else klass
        mask, (y0, x0), box = _shape_mask_and_box(rng, shape, size)
        if any(_iou(box, b) > 0.25 for b in boxes):
            continue
        h, w = mask.shape
        patch = img[y0:y0 + h, x0:x0 + w]
        bg_mean = patch[mask].mean(axis=0)
        if num_classes == 80:
            color = _object_color_hue(rng, klass // 9, bg_mean)
        else:
            color = _object_color(rng, bg_mean)
        patch[mask] = color[None, :] + rng.randn(int(mask.sum()), 3) * 2.0
        boxes.append(box)
        labels.append(klass)
    return (
        np.clip(img, 0, 255).astype(np.uint8),
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32),
    )


def match_detections(
    dets: Sequence[Tuple],
    boxes: np.ndarray,
    labels: np.ndarray,
    size: int = 416,
    iou_thr: float = 0.5,
) -> Tuple[int, int, int]:
    """Score one frame's detections against its ground truth.

    ``dets`` are engine/wire results: (klass 1-INDEXED, conf, x, y, w, h)
    in pixel coords with x,y the TOP-LEFT corner (the reference's result
    convention, server/detector.py:142-144). ``boxes`` are normalized
    cx cy w h; ``labels`` 0-indexed.

    Returns (matched, total_gt, false_positives): greedy one-to-one
    matching by IoU>=iou_thr AND class agreement.
    """
    gt = []
    for (cx, cy, w, h), lab in zip(boxes.reshape(-1, 4), labels):
        gt.append(((cx * size, cy * size, w * size, h * size), int(lab)))
    used = [False] * len(gt)
    matched = 0
    fps = 0
    for d in dets:
        klass, _, x, y, w, h = d[0], d[1], d[2], d[3], d[4], d[5]
        dcx, dcy = x + w / 2, y + h / 2
        best, best_iou = -1, iou_thr
        for gi, ((gcx, gcy, gw, gh), glab) in enumerate(gt):
            if used[gi] or glab != int(klass) - 1:
                continue
            iou = _iou((dcx / size, dcy / size, w / size, h / size),
                       (gcx / size, gcy / size, gw / size, gh / size))
            if iou >= best_iou:
                best, best_iou = gi, iou
        if best >= 0:
            used[best] = True
            matched += 1
        else:
            fps += 1
    return matched, len(gt), fps


def make_dataset(
    seeds: Sequence[int], size: int = 416, max_objects: int = 3,
    num_classes: int = 3,
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Stack of scenes for the given seeds: (images, boxes list, labels list)."""
    imgs, boxes, labels = [], [], []
    for s in seeds:
        im, bx, lb = make_scene(s, size, max_objects, num_classes)
        imgs.append(im)
        boxes.append(bx)
        labels.append(lb)
    return np.stack(imgs), boxes, labels
