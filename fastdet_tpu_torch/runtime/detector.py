"""Detector API: the framework's equivalent of the reference detector layer.

Mirrors the behavioral contract of reference server/detector.py:64-146:

- ``Detector.perform(jpeg_bytes, threshold) -> [(klass, conf, x, y, w, h)]``
  in 416x416 pixel coordinates, classes 1-indexed;
- images that are not exactly 416x416 raise ValueError (the server never
  resizes — the client letterboxes, detector.py:130-132);
- ``dbgout`` dumps every received JPEG to a file (detector.py:72-76);
- ``DummyDetector`` returns one constant cat box regardless of input
  (detector.py:83-92) — the protocol-stack test fake.

Model-backed serving goes through runtime/server.py's ModelService in
front of the port's DetectionEngine; a synchronous engine-backed
Detector (the detector CLI's) is not ported yet.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from fastdet_tpu_torch.wire.messages import ResultTuple

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
