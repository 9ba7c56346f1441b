"""Host-side JPEG decode for the frame path.

The reference decodes with Pillow/libjpeg inside perform()
(server/detector.py:128-133). The port decodes with its own native
decoder first (runtime/native_jpeg.py, built from native/jpeg at first
use); files outside that decoder's baseline-sequential subset fall back
to OpenCV, then PIL, imported only when such a file arrives — the card
machine may have neither.
"""

from __future__ import annotations

import io

import numpy as np


class JpegError(ValueError):
    pass


def decode_rgb(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to an RGB uint8 (H, W, 3) array."""
    from fastdet_tpu_torch.runtime import native_jpeg

    try:
        return native_jpeg.decode_rgb(data)
    except ValueError:
        pass  # progressive/exotic file: fall through
    try:
        import cv2  # type: ignore
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise JpegError("invalid JPEG data")
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB
    try:
        from PIL import Image
    except ImportError:
        raise JpegError("JPEG outside the native decoder's subset and "
                        "neither cv2 nor PIL is installed") from None
    try:
        img = Image.open(io.BytesIO(data))
        return np.asarray(img.convert("RGB"))
    except Exception as e:
        raise JpegError(f"invalid JPEG data: {e}") from None
