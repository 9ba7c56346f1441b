"""Client-side detector API.

The port's copy of the JAX package's ``fastdet_tpu/client_api.py``: the
same classes and behaviour over the port's client, JPEG codec and
engine. Python equivalent of the reference's C# client detector layer
(fastdet-test/Assets/client/): the ``ObjectDetector`` interface with three
interchangeable backends —

- :class:`RemoteDetector`  — streams frames to a detection server over the
  fastdet wire protocol (the reference's RemoteYOLODetector.cs);
- :class:`LocalDetector`   — in-process inference via the port's
  DetectionEngine on the engine's device (the reference's
  LocalYOLODetector.cs ran Barracuda on-device);
- :class:`DummyDetector`   — constant result, no I/O (DummyDetector.cs).

Behavioral contract mirrored from the reference
(Assets/client/IObjectDetector.cs:106-121, YOLODetector.cs:18,145-232):

- ``process_image(image, detect_area, threshold) -> request_id`` crops the
  detect area, letterboxes to 416x416, JPEG-encodes, and submits;
- results surface via the ``on_result`` callback from ``update()``, as
  :class:`DetectionResult` with request id, timestamps, inference time,
  and objects mapped back into detect-area UV space;
- requests unanswered for ``REQUEST_TIMEOUT`` (3 s) fire ``on_timeout``;
- class ids are 1-indexed; 0/out-of-range are filtered
  (RemoteYOLODetector.cs:238).

Unlike the reference client (which has a real data race between its
socket thread and the Unity main thread, SURVEY.md §5), this API is
single-threaded: network I/O is drained inside ``update()``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastdet_tpu_torch.utils import labels as labels_mod

logger = logging.getLogger(__name__)

REQUEST_TIMEOUT = 3.0
IMAGE_SIZE = 416


@dataclass(frozen=True)
class DetectedObject:
    label: Optional[str]
    klass: int
    conf: float                     # [0, 1]
    bbox: Tuple[float, float, float, float]  # (x, y, w, h) in detect-area UV


@dataclass(frozen=True)
class DetectionResult:
    request_id: int
    sent_time: float
    recv_time: float
    inference_time: float           # seconds, server-reported
    objects: Tuple[DetectedObject, ...]


@dataclass
class _Pending:
    sent_time: float
    detect_area: Tuple[float, float, float, float]
    threshold: float


def letterbox(image: np.ndarray,
              detect_area: Optional[Tuple[float, float, float, float]] = None,
              size: int = IMAGE_SIZE) -> np.ndarray:
    """Crop ``detect_area`` (UV fractions of the image) and resize to
    size x size — the client-side scaling step the server requires
    (reference YOLODetector.cs:145-153; the server never resizes).
    """
    h, w = image.shape[:2]
    if detect_area is not None:
        # clamp to the frame: slightly out-of-range UV areas (float
        # jitter in the app layer) must not wrap to negative indices
        # (silently wrong crop) or produce an empty slice (cv2.resize
        # raises on empty input)
        x0, y0, aw, ah = detect_area
        xi = min(max(int(x0 * w), 0), w - 1)
        yi = min(max(int(y0 * h), 0), h - 1)
        image = image[yi : yi + max(1, int(ah * h)),
                      xi : xi + max(1, int(aw * w))]
    try:
        import cv2

        return cv2.resize(image, (size, size), interpolation=cv2.INTER_LINEAR)
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.fromarray(image).resize((size, size)))


class ObjectDetector:
    """Interface: submit frames, poll update(), receive events."""

    def __init__(self, names: Optional[List[str]] = None):
        self.names = names if names is not None else labels_mod.COCO_NAMES
        self.on_result: Optional[Callable[[DetectionResult], None]] = None
        self.on_timeout: Optional[Callable[[int], None]] = None
        self._pending: Dict[int, _Pending] = {}
        self._next_id = 1

    # -- required interface --------------------------------------------
    def process_image(
        self,
        image: np.ndarray,
        detect_area: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
        threshold: float = 0.3,
    ) -> int:
        reqid = self._next_id
        self._next_id += 1
        self._pending[reqid] = _Pending(time.time(), detect_area, threshold)
        frame = letterbox(image, detect_area)
        self._submit(reqid, frame, threshold)
        return reqid

    def update(self) -> None:
        """Drain I/O, fire on_result/on_timeout. Call once per frame."""
        self._drain()
        now = time.time()
        expired = [r for r, p in self._pending.items()
                   if now - p.sent_time > REQUEST_TIMEOUT]
        for reqid in expired:
            del self._pending[reqid]
            logger.info("request timeout: %d", reqid)
            self._request_timed_out(reqid)
            if self.on_timeout is not None:
                self.on_timeout(reqid)

    @property
    def num_pending_requests(self) -> int:
        return len(self._pending)

    def close(self) -> None:
        pass

    # -- backend hooks ---------------------------------------------------
    def _submit(self, reqid: int, frame416: np.ndarray, threshold: float) -> None:
        raise NotImplementedError

    def _drain(self) -> None:
        pass

    def _request_timed_out(self, reqid: int) -> None:
        pass

    # -- shared result plumbing -------------------------------------------
    def _deliver(self, reqid: int, inference_time: float,
                 raw: Sequence[Tuple[int, float, float, float, float, float]]) -> None:
        """raw: (klass, conf01, x, y, w, h) in 416-space pixels."""
        p = self._pending.pop(reqid, None)
        if p is None:
            return  # stale/unknown request ids dropped (RemoteYOLODetector.cs:227-229)
        ax, ay, aw, ah = p.detect_area
        objs = []
        for klass, conf, x, y, w, h in raw:
            if not (1 <= klass <= len(self.names)):
                continue  # klass 0 = UNDEFINED
            # 416-space -> detect-area UV (RemoteYOLODetector.cs:247-251)
            objs.append(
                DetectedObject(
                    label=labels_mod.name_of(self.names, klass),
                    klass=klass,
                    conf=conf,
                    bbox=(
                        ax + (x / IMAGE_SIZE) * aw,
                        ay + (y / IMAGE_SIZE) * ah,
                        (w / IMAGE_SIZE) * aw,
                        (h / IMAGE_SIZE) * ah,
                    ),
                )
            )
        result = DetectionResult(
            request_id=reqid,
            sent_time=p.sent_time,
            recv_time=time.time(),
            inference_time=inference_time,
            objects=tuple(objs),
        )
        if self.on_result is not None:
            self.on_result(result)


@dataclass
class TrackedBox:
    label: Optional[str]
    klass: int
    conf: float
    bbox: Tuple[float, float, float, float]  # UV, like DetectedObject
    deadline: float                          # absolute expiry time


class BoxTracker:
    """The app layer's box retention (reference DetectionTest.cs:177-203).

    Each displayed box lives ``retain`` seconds (scene default 0.5 s).
    When a result arrives — and only if it is NEWER than the last one by
    sent time (DetectionTest.cs:179) — each object REPLACES an existing
    box of the same label whose overlap exceeds 0.5, else is appended.
    Overlap uses the app's asymmetric measure intersection/area(existing)
    (DetectionTest.cs getIOU:205-211), reproduced exactly.
    """

    def __init__(self, retain: float = 0.5):
        self.retain = retain
        self.boxes: List[TrackedBox] = []
        self._last_sent: float = -1.0

    @staticmethod
    def _overlap(b0, b1) -> float:
        x = max(b0[0], b1[0])
        y = max(b0[1], b1[1])
        w = min(b0[0] + b0[2], b1[0] + b1[2]) - x
        h = min(b0[1] + b0[3], b1[1] + b1[3]) - y
        area0 = b0[2] * b0[3]
        if area0 <= 0:
            return 0.0
        # NOTE: the app does not clamp negative w/h — a disjoint pair can
        # yield a positive product; kept bit-faithful (DetectionTest.cs:210)
        return (w * h) / area0

    def add_result(self, result: DetectionResult,
                   now: Optional[float] = None) -> None:
        if result.sent_time <= self._last_sent:
            return  # stale result: out-of-order responses are ignored
        self._last_sent = result.sent_time
        now = time.time() if now is None else now
        deadline = now + self.retain
        for obj in result.objects:
            found = -1
            for i, box in enumerate(self.boxes):
                if box.label == obj.label and self._overlap(box.bbox, obj.bbox) > 0.5:
                    found = i
                    break
            newbox = TrackedBox(obj.label, obj.klass, obj.conf, obj.bbox, deadline)
            if found >= 0:
                self.boxes[found] = newbox
            else:
                self.boxes.append(newbox)

    def active(self, now: Optional[float] = None) -> List[TrackedBox]:
        """Live boxes; expired ones are pruned (the app skips them at
        render time)."""
        now = time.time() if now is None else now
        self.boxes = [b for b in self.boxes if b.deadline > now]
        return list(self.boxes)


class DummyDetector(ObjectDetector):
    """Constant cat box at the center, conf 1.0 (DummyDetector.cs:41-55)."""

    def __init__(self, names=None):
        super().__init__(names)
        self._queue: List[int] = []

    def _submit(self, reqid, frame416, threshold):
        self._queue.append(reqid)

    def _drain(self):
        # swap out first: an on_result callback may submit the NEXT frame
        # (the standard streaming pattern), and iterating the live list
        # would deliver it immediately and never return from update()
        queue, self._queue = self._queue, []
        for reqid in queue:
            # same numbers the server-side DummyDetector puts on the wire
            # (center-coded, reproducing the reference's dummy quirk), so
            # local-dummy and remote-dummy deliver identical results
            self._deliver(reqid, 0.0,
                          [(16, 1.0, 0.5 * IMAGE_SIZE, 0.5 * IMAGE_SIZE,
                            0.4 * IMAGE_SIZE, 0.4 * IMAGE_SIZE)])


class RemoteDetector(ObjectDetector):
    """Streams frames to a fastdet server (rtsp://host[:port]/path).

    Elastic recovery beyond the reference (which never reconnects): after
    ``RECONNECT_AFTER`` consecutive request timeouts the session is torn
    down and re-established (fresh FEED handshake + UDP endpoint), so a
    restarted server picks the stream back up without app involvement.
    """

    RECONNECT_AFTER = 3

    def __init__(self, url: str, names=None, jpeg_quality: int = 90,
                 auto_reconnect: bool = True):
        super().__init__(names)
        if not url.startswith("rtsp://"):
            raise ValueError(f"bad url: {url!r}")
        hostport, _, path = url[7:].partition("/")
        host, _, port = hostport.partition(":")
        self._addr = (host or "localhost", int(port) if port else 10000,
                      path or "detect")
        self.jpeg_quality = jpeg_quality
        self.auto_reconnect = auto_reconnect
        self._timeout_streak = 0
        self.reconnects = 0
        self.client = self._connect()

    def _connect(self):
        from fastdet_tpu_torch.runtime.client import DetectClient

        client = DetectClient(*self._addr)
        client.open()
        return client

    def _submit(self, reqid, frame416, threshold):
        from fastdet_tpu_torch.runtime import jpeg

        try:
            self.client.request(
                reqid, threshold, jpeg.encode_rgb(frame416, self.jpeg_quality)
            )
        except OSError:
            pass  # counted as a timeout; reconnect logic recovers

    def _drain(self):
        try:
            self.client.poll(0)
        except OSError:
            return
        for reqid in list(self.client.responses):
            msec, records = self.client.responses.pop(reqid)
            raw = [(k, c255 / 255.0, x, y, w, h)
                   for (k, c255, x, y, w, h) in records]
            self._timeout_streak = 0
            self._deliver(reqid, msec / 1000.0, raw)

    def _request_timed_out(self, reqid):
        self._timeout_streak += 1
        if self.auto_reconnect and self._timeout_streak >= self.RECONNECT_AFTER:
            logger.warning("reconnecting after %d timeouts", self._timeout_streak)
            self._timeout_streak = 0
            try:
                self.client.close()
            except OSError:
                pass
            try:
                self.client = self._connect()
                self.reconnects += 1
            except OSError as e:
                logger.error("reconnect failed: %s", e)

    def close(self):
        self.client.close()


class LocalDetector(ObjectDetector):
    """In-process inference on a DetectionEngine (the Barracuda-local
    analog); the engine's device is the one it was built on."""

    def __init__(self, engine, names=None):
        super().__init__(names)
        self.engine = engine
        self._queue: List[Tuple[int, np.ndarray, float]] = []

    def _submit(self, reqid, frame416, threshold):
        self._queue.append((reqid, frame416, threshold))

    def _drain(self):
        if not self._queue:
            return
        batch = self._queue[: self.engine.max_batch]
        self._queue = self._queue[len(batch):]
        t0 = time.time()
        results = self.engine.detect(
            [f for _, f, _ in batch], [t for _, _, t in batch]
        )
        dt = time.time() - t0
        for (reqid, _, _), res in zip(batch, results):
            self._deliver(reqid, dt / max(1, len(batch)), res)
