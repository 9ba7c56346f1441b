"""Host-side JPEG decode for the frame path.

The reference decodes with Pillow/libjpeg inside perform()
(server/detector.py:128-133). The port picks its decoder as the JAX
package's ``fastdet_tpu/runtime/jpeg.py`` does, from
``FASTDET_JPEG_BACKEND`` (read once, at import):

- ``auto`` (the default): OpenCV, else PIL;
- ``cv2``: OpenCV, else PIL;
- ``native``: the port's own decoder (runtime/native_jpeg.py, built from
  native/jpeg at first use); a file outside its baseline-sequential
  subset falls through to PIL, as in the JAX package.

So the same JPEG bytes give the same pixels, and the same wire bytes,
as the reference wherever this module decodes: the server's pixel
fallback and ``FASTDET_CALIB_DIR`` calibration frames.

On a machine with neither OpenCV nor PIL, ``auto`` and ``cv2`` decode
natively and log that once. The pixels then differ from the reference's:
on testdata/scene1.jpg 2.7 % of the values, by up to 3 levels.
:data:`LAST_DECODER` names the decoder of the last successful call.
"""

from __future__ import annotations

import io
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

_BACKEND = os.environ.get("FASTDET_JPEG_BACKEND", "auto")

#: the decoder of the last successful decode_rgb call: "cv2", "pil" or
#: "native"
LAST_DECODER = None

_NATIVE_NOTED = False


class JpegError(ValueError):
    pass


def _cv2():
    try:
        import cv2  # type: ignore
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _native(data: bytes) -> np.ndarray:
    from fastdet_tpu_torch.runtime import native_jpeg

    return native_jpeg.decode_rgb(data)


def decode_rgb(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to an RGB uint8 (H, W, 3) array."""
    global LAST_DECODER, _NATIVE_NOTED
    if _BACKEND == "native":
        try:
            img = _native(data)
            LAST_DECODER = "native"
            return img
        except ValueError:
            pass  # progressive/exotic file: fall through to PIL
    cv2 = _cv2() if _BACKEND in ("auto", "cv2") else None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise JpegError("invalid JPEG data")
        LAST_DECODER = "cv2"
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB
    image = _pil_image()
    if image is not None:
        try:
            img = np.asarray(image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as e:
            raise JpegError(f"invalid JPEG data: {e}") from None
        LAST_DECODER = "pil"
        return img
    if _BACKEND == "native":
        raise JpegError("JPEG outside the native decoder's subset and "
                        "neither cv2 nor PIL is installed")
    if not _NATIVE_NOTED:
        _NATIVE_NOTED = True
        logger.warning("FASTDET_JPEG_BACKEND=%s: neither cv2 nor PIL is "
                       "installed; decoding with the native decoder, whose "
                       "pixels differ from the reference's by a few levels",
                       _BACKEND)
    try:
        img = _native(data)
    except ValueError as e:
        raise JpegError(f"native decode failed and neither cv2 nor PIL is "
                        f"installed: {e}") from None
    LAST_DECODER = "native"
    return img
