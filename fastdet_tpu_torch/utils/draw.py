"""Box-overlay rendering for demo/diagnostic output (the port's copy of
the JAX package's ``fastdet_tpu/utils/draw.py``).

The reference's Unity app draws detection rectangles + labels on the
camera view (DetectionTest.cs:177-203); this is the headless equivalent
for annotated stills.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

# deterministic per-class colors (golden-ratio hue walk)
def _color(klass: int) -> Tuple[int, int, int]:
    h = (klass * 0.61803398875) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    q, t = int(255 * (1 - f)), int(255 * f)
    return [(255, t, 0), (q, 255, 0), (0, 255, t),
            (0, q, 255), (t, 0, 255), (255, 0, q)][i % 6]


def draw_detections(
    image: np.ndarray,
    detections: Iterable[Tuple[int, float, float, float, float, float]],
    names: Optional[list] = None,
) -> np.ndarray:
    """Overlay (klass, conf, x, y, w, h) pixel-space boxes; returns a copy."""
    import cv2

    from fastdet_tpu_torch.utils import labels as labels_mod

    out = np.ascontiguousarray(image.copy())
    for klass, conf, x, y, w, h in detections:
        color = _color(klass)
        p1 = (int(round(x)), int(round(y)))
        p2 = (int(round(x + w)), int(round(y + h)))
        cv2.rectangle(out, p1, p2, color, 2)
        name = labels_mod.name_of(names or labels_mod.COCO_NAMES, klass) or str(klass)
        cv2.putText(out, f"{name} {conf:.2f}", (p1[0], max(12, p1[1] - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1, cv2.LINE_AA)
    return out
