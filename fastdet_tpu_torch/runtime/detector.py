"""Detector API: the framework's equivalent of the reference detector layer.

Mirrors the behavioral contract of reference server/detector.py:64-146:

- ``Detector.perform(jpeg_bytes, threshold) -> [(klass, conf, x, y, w, h)]``
  in 416x416 pixel coordinates, classes 1-indexed;
- images that are not exactly 416x416 raise ValueError (the server never
  resizes — the client letterboxes, detector.py:130-132);
- ``dbgout`` dumps every received JPEG to a file (detector.py:72-76);
- ``DummyDetector`` returns one constant cat box regardless of input
  (detector.py:83-92) — the protocol-stack test fake.

The real implementation, :class:`EngineDetector` (the detector CLI's),
decodes on the host and runs the port's DetectionEngine on its device.
The server's model path goes through runtime/server.py's ModelService in
front of the same engine instead.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from fastdet_tpu_torch.runtime import jpeg
from fastdet_tpu_torch.wire.messages import ResultTuple

if TYPE_CHECKING:  # torch-heavy; keep dummy-only servers light at import
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

logger = logging.getLogger(__name__)


class Detector:
    def __init__(self, image_size=(416, 416), num_classes: int = 80,
                 dbgout: Optional[str] = None):
        self.image_size = image_size
        self.num_classes = num_classes
        self.dbgout = dbgout

    def _debug_dump(self, data: bytes) -> None:
        if self.dbgout is not None:
            with open(self.dbgout, "wb") as fp:
                fp.write(data)

    def perform(self, data: bytes, threshold: float = 0.1) -> List[ResultTuple]:
        raise NotImplementedError


class DummyDetector(Detector):
    """Constant-result fake: one cat box, conf 1.0, centered 40% square."""

    def __repr__(self):
        return "<DummyDetector>"

    def perform(self, data: bytes, threshold: float = 0.1) -> List[ResultTuple]:
        self._debug_dump(data)
        (width, height) = self.image_size
        return [(16, 1.0, 0.5 * width, 0.5 * height, 0.4 * width, 0.4 * height)]


class EngineDetector(Detector):
    """JPEG -> host decode -> DetectionEngine -> reference-format results.

    The counterpart of the JAX package's ``TPUDetector``
    (fastdet_tpu/runtime/detector.py:61): frames take the engine's pixel
    path (``detect_one``) on the device the engine was built on."""

    def __init__(self, engine: "DetectionEngine", path: str = "",
                 dbgout: Optional[str] = None):
        super().__init__(
            image_size=(engine.spec.image_size, engine.spec.image_size),
            num_classes=engine.spec.num_classes,
            dbgout=dbgout,
        )
        self.engine = engine
        self.path = path
        logger.info("load: path=%s, engine=%s mode=%s device=%s", path,
                    engine.spec.name, engine.mode, engine.device)

    def __repr__(self):
        return (f"<EngineDetector mode={self.engine.mode}, "
                f"device={self.engine.device}, path={self.path}, "
                f"num_classes={self.num_classes}>")

    def decode_image(self, data: bytes) -> np.ndarray:
        img = jpeg.decode_rgb(data)
        if img.shape[:2] != self.image_size[::-1]:
            raise ValueError("invalid image size")
        return img

    def perform(self, data: bytes, threshold: float = 0.1) -> List[ResultTuple]:
        self._debug_dump(data)
        img = self.decode_image(data)
        results = self.engine.detect_one(img, threshold)
        logger.info("perform: results=%s", results)
        return results
