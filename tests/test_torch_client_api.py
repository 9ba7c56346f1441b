"""The port's client API (fastdet_tpu_torch.client_api) and engine-backed
detector against the JAX package's, on the CPU.

- ``letterbox``: bit-equal to the JAX one (same resize, same clamping);
- ``BoxTracker``: the app's retention rules and its unclamped-IoU quirk,
  event for event equal to the JAX tracker on a random stream;
- ``DummyDetector``: events, callback resubmission and timeouts;
- ``LocalDetector`` and ``EngineDetector`` on a CPU engine (synthetic:tiny,
  f32) against the JAX ones on the shared JAX engine, at the engine
  tolerance of tests/test_torch_engine.py (same count and classes, boxes
  at IoU >= 0.999, confidences within 1/255);
- ``RemoteDetector`` against the port's dummy server, and its reconnect
  after a server restart.
"""

import asyncio
import contextlib
import pathlib
import threading
import time

import numpy as np
import pytest

from fastdet_tpu import client_api as jax_client_api
from fastdet_tpu.runtime.detector import TPUDetector
from fastdet_tpu_torch import client_api
from fastdet_tpu_torch.client_api import (BoxTracker, DummyDetector,
                                          LocalDetector, RemoteDetector,
                                          letterbox)
from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.runtime.detector import EngineDetector
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from fastdet_tpu_torch.runtime.server import DetectionServer, build_services

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"


def _frame(seed=0, shape=(480, 640, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape, np.uint8)


@contextlib.contextmanager
def serving(services, port=0):
    """A port DetectionServer on 127.0.0.1 in a thread; yields its port
    and stops it on exit (engines stay with their owner)."""
    server = DetectionServer(services, port=port, host="127.0.0.1")
    state = {}
    ready = threading.Event()

    def serve():
        loop = asyncio.new_event_loop()
        state["loop"] = loop

        async def main():
            ev = asyncio.Event()
            state["task"] = asyncio.ensure_future(server.serve(ev))
            await ev.wait()
            ready.set()
            try:
                await state["task"]
            except asyncio.CancelledError:
                pass

        loop.run_until_complete(main())
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        assert ready.wait(30)
        yield server.bound_port
    finally:
        if "task" in state:
            # one callback: after request_shutdown the serve task may end
            # and the loop close before a second call could be scheduled
            task = state["task"]
            state["loop"].call_soon_threadsafe(
                lambda: (server.request_shutdown(), task.cancel()))
        thread.join(30)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def port_engine():
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1, 2),
                          device="cpu")
    yield eng
    eng.close()


def _iou(a, b):
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    iw = max(0, min(ax + aw, bx + bw) - max(ax, bx))
    ih = max(0, min(ay + ah, by + bh) - max(ay, by))
    union = aw * ah + bw * bh - iw * ih
    return 1.0 if union <= 0 else iw * ih / union


def _assert_close(got, want):
    """(klass, conf, x, y, w, h) tuples of one frame, engine tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert abs(g[1] - w[1]) <= 1.0 / 255.0
        assert _iou(g[2:], w[2:]) >= 0.999


# ---------------------------------------------------------------------------
# letterbox and BoxTracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("area", [
    None, (0.0, 0.0, 1.0, 1.0), (0.25, 0.0, 0.5, 1.0),
    (0.125, 0.0, 0.75, 1.0), (-0.05, -0.02, 1.1, 1.1), (1.5, 1.5, 0.5, 0.5),
    (0.3333, 0.1, 0.2, 0.7)])
@pytest.mark.parametrize("shape", [(480, 640, 3), (416, 416, 3),
                                   (300, 200, 3)])
def test_letterbox_bit_equal_jax(area, shape):
    img = _frame(1, shape)
    got = letterbox(img, area)
    want = jax_client_api.letterbox(img, area)
    assert got.shape == (416, 416, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _result(mod, sent, objs):
    return mod.DetectionResult(
        request_id=int(sent * 1000), sent_time=sent, recv_time=sent + 0.05,
        inference_time=0.01,
        objects=tuple(mod.DetectedObject(label=lbl, klass=1, conf=0.9,
                                         bbox=bb) for lbl, bb in objs))


def test_box_tracker_retention_and_quirks():
    """Replacement of a same-label box at overlap > 0.5, appending
    otherwise, 0.5 s retention, stale results ignored, the asymmetric
    overlap, and the unclamped-IoU quirk (a same-label box disjoint in
    BOTH axes replaces: negative x negative > 0)."""
    t = BoxTracker(retain=0.5)
    t.add_result(_result(client_api, 10.0, [("dog", (0.1, 0.1, 0.2, 0.2))]),
                 now=10.0)
    t.add_result(_result(client_api, 10.2, [("dog", (0.12, 0.11, 0.2, 0.2))]),
                 now=10.2)
    boxes = t.active(now=10.25)
    assert len(boxes) == 1 and boxes[0].bbox[0] == 0.12
    t.add_result(_result(client_api, 10.3, [("cat", (0.12, 0.11, 0.2, 0.2))]),
                 now=10.3)
    t.add_result(_result(client_api, 10.4, [("dog", (0.7, 0.11, 0.1, 0.2))]),
                 now=10.4)
    assert len(t.active(now=10.45)) == 3
    t.add_result(_result(client_api, 10.1, [("cow", (0.5, 0.5, 0.2, 0.2))]),
                 now=10.46)   # stale: older than the last result
    assert len(t.active(now=10.47)) == 3
    assert len(t.active(now=10.85)) == 1
    assert len(t.active(now=10.95)) == 0

    q = BoxTracker(retain=0.5)
    q.add_result(_result(client_api, 40.0, [("dog", (0.1, 0.1, 0.2, 0.2))]),
                 now=40.0)
    q.add_result(_result(client_api, 40.1, [("dog", (0.7, 0.7, 0.1, 0.1))]),
                 now=40.1)
    boxes = q.active(now=40.2)
    assert len(boxes) == 1 and boxes[0].bbox[0] == 0.7

    a = BoxTracker(retain=0.5)
    a.add_result(_result(client_api, 30.0, [("dog", (0.0, 0.0, 0.1, 0.1))]),
                 now=30.0)
    a.add_result(_result(client_api, 30.1, [("dog", (0.0, 0.0, 0.9, 0.9))]),
                 now=30.1)
    boxes = a.active(now=30.2)
    assert len(boxes) == 1 and boxes[0].bbox[2] == 0.9


def test_box_tracker_equals_jax_on_a_random_stream():
    rng = np.random.RandomState(0)
    ours, theirs = BoxTracker(retain=0.5), jax_client_api.BoxTracker(retain=0.5)
    now = 100.0
    for _ in range(200):
        now += rng.uniform(0.0, 0.2)
        sent = now - rng.uniform(0.0, 0.6)   # some arrive out of order
        objs = [(["dog", "cat", "cow"][rng.randint(3)],
                 tuple(float(v) for v in rng.uniform(0, 0.6, 4)))
                for _ in range(rng.randint(0, 4))]
        ours.add_result(_result(client_api, sent, objs), now=now)
        theirs.add_result(_result(jax_client_api, sent, objs), now=now)
        got = [(b.label, b.bbox, b.deadline) for b in ours.active(now=now)]
        want = [(b.label, b.bbox, b.deadline)
                for b in theirs.active(now=now)]
        assert got == want


# ---------------------------------------------------------------------------
# DummyDetector
# ---------------------------------------------------------------------------

def test_dummy_detector_events():
    det = DummyDetector()
    got = []
    det.on_result = got.append
    reqid = det.process_image(_frame(), detect_area=(0.2, 0.2, 0.6, 0.6))
    assert det.num_pending_requests == 1
    det.update()
    assert det.num_pending_requests == 0
    assert len(got) == 1 and got[0].request_id == reqid
    o = got[0].objects[0]
    assert (o.klass, o.label, o.conf) == (16, "cat", 1.0)
    np.testing.assert_allclose(o.bbox, (0.2 + 0.5 * 0.6, 0.2 + 0.5 * 0.6,
                                        0.4 * 0.6, 0.4 * 0.6), rtol=1e-6)
    # the JAX package's dummy delivers the same object
    jdet = jax_client_api.DummyDetector()
    jgot = []
    jdet.on_result = jgot.append
    jdet.process_image(_frame(), detect_area=(0.2, 0.2, 0.6, 0.6))
    jdet.update()
    jo = jgot[0].objects[0]
    assert (o.label, o.klass, o.conf, o.bbox) == (jo.label, jo.klass,
                                                  jo.conf, jo.bbox)


def test_dummy_submit_from_callback_terminates():
    det = DummyDetector()
    delivered = []

    def resubmit(result):
        delivered.append(result.request_id)
        det.process_image(_frame())

    det.on_result = resubmit
    det.process_image(_frame())
    det.update()
    assert len(delivered) == 1
    det.update()
    assert len(delivered) == 2


def test_timeout_event(monkeypatch):
    det = DummyDetector()
    timeouts = []
    det.on_timeout = timeouts.append
    reqid = det.process_image(_frame())
    det._queue.clear()   # drop the queued reply: forces the timeout path
    det.update()
    assert timeouts == []
    monkeypatch.setattr(client_api, "REQUEST_TIMEOUT", 0.0)
    time.sleep(0.01)
    det.update()
    assert timeouts == [reqid]
    assert det.num_pending_requests == 0


def test_class_zero_and_out_of_range_filtered():
    det = DummyDetector()
    got = []
    det.on_result = got.append
    reqid = det.process_image(_frame())
    det._queue.clear()
    det._deliver(reqid, 0.0, [(0, 0.9, 1, 1, 2, 2), (81, 0.9, 1, 1, 2, 2),
                              (3, 0.5, 208, 104, 41.6, 20.8)])
    (r,) = got
    assert [(o.klass, o.label) for o in r.objects] == [(3, "car")]
    np.testing.assert_allclose(r.objects[0].bbox, (0.5, 0.25, 0.1, 0.05))


# ---------------------------------------------------------------------------
# Engine-backed detectors
# ---------------------------------------------------------------------------

def test_local_detector_matches_jax(port_engine, tiny_f32_engine):
    frames = [_frame(1), _frame(2, (416, 416, 3)), _frame(3, (300, 500, 3))]
    areas = [(0.0, 0.0, 1.0, 1.0), (0.1, 0.2, 0.5, 0.6),
             (0.2, 0.0, 0.6, 1.0)]
    out = {}
    for key, det in (("port", LocalDetector(port_engine)),
                     ("jax", jax_client_api.LocalDetector(tiny_f32_engine))):
        got = []
        det.on_result = got.append
        for f, a in zip(frames, areas):
            det.process_image(f, detect_area=a, threshold=0.3)
        while det.num_pending_requests:
            det.update()
        out[key] = got
    assert [r.request_id for r in out["port"]] == [1, 2, 3]
    assert sum(len(r.objects) for r in out["port"]) > 0
    for r, jr in zip(out["port"], out["jax"]):
        assert r.request_id == jr.request_id
        # back from detect-area UV to 416-space pixels of each request
        a = areas[r.request_id - 1]
        to_px = [(o.klass, o.conf,
                  (o.bbox[0] - a[0]) / a[2] * 416,
                  (o.bbox[1] - a[1]) / a[3] * 416,
                  o.bbox[2] / a[2] * 416, o.bbox[3] / a[3] * 416)
                 for o in r.objects]
        jto_px = [(o.klass, o.conf,
                   (o.bbox[0] - a[0]) / a[2] * 416,
                   (o.bbox[1] - a[1]) / a[3] * 416,
                   o.bbox[2] / a[2] * 416, o.bbox[3] / a[3] * 416)
                  for o in jr.objects]
        _assert_close(to_px, jto_px)
        assert [o.label for o in r.objects] == [o.label for o in jr.objects]


def test_local_detector_objects_are_engine_records(port_engine):
    """Each object is the engine's own record for the letterboxed frame,
    mapped into detect-area UV."""
    frame, area = _frame(4), (0.1, 0.2, 0.5, 0.6)
    det = LocalDetector(port_engine)
    got = []
    det.on_result = got.append
    det.process_image(frame, detect_area=area, threshold=0.3)
    det.update()
    (r,) = got
    recs = port_engine.detect([letterbox(frame, area)], [0.3])[0]
    ax, ay, aw, ah = area
    assert [(o.klass, o.conf, o.bbox) for o in r.objects] == [
        (k, c, (ax + x / 416 * aw, ay + y / 416 * ah, w / 416 * aw,
                h / 416 * ah)) for k, c, x, y, w, h in recs]


@pytest.mark.parametrize("name", ["scene1.jpg", "scene2.jpg",
                                  "adv_night.jpg"])
def test_engine_detector_matches_tpu_detector(port_engine, tiny_f32_engine,
                                              name, tmp_path):
    data = (TESTDATA / name).read_bytes()
    dump = tmp_path / "dbg.jpg"
    det = EngineDetector(port_engine, path="synthetic:tiny",
                         dbgout=str(dump))
    got = det.perform(data, threshold=0.3)
    want = TPUDetector(tiny_f32_engine).perform(data, threshold=0.3)
    assert len(got) > 0
    _assert_close(got, want)
    assert dump.read_bytes() == data
    assert (det.image_size, det.num_classes) == ((416, 416), 80)
    assert "EngineDetector" in repr(det)


def test_engine_detector_rejects_other_sizes(port_engine):
    from fastdet_tpu_torch.runtime import jpeg

    det = EngineDetector(port_engine)
    with pytest.raises(ValueError, match="invalid image size"):
        det.perform(jpeg.encode_rgb(_frame(0, (224, 224, 3))))


# ---------------------------------------------------------------------------
# RemoteDetector
# ---------------------------------------------------------------------------

def test_remote_detector_against_port_dummy_server():
    with serving(build_services([])) as port:
        det = RemoteDetector(f"rtsp://127.0.0.1:{port}/detect")
        try:
            got = []
            det.on_result = got.append
            det.process_image(_frame(3), detect_area=(0.0, 0.0, 1.0, 1.0))
            deadline = time.time() + 5
            while not got and time.time() < deadline:
                det.update()
                time.sleep(0.01)
        finally:
            det.close()
    assert len(got) == 1
    o = got[0].objects[0]
    assert o.klass == 16 and abs(o.conf - 1.0) < 0.01
    # the reference's dummy puts CENTER coordinates on the wire
    np.testing.assert_allclose(o.bbox, (0.5, 0.5, 0.4, 0.4), atol=0.01)


def test_remote_detector_bad_url():
    with pytest.raises(ValueError):
        RemoteDetector("http://nope")


def test_remote_detector_reconnects_after_server_restart(monkeypatch):
    monkeypatch.setattr(client_api, "REQUEST_TIMEOUT", 0.3)
    frame = _frame(0)
    got = []
    with serving(build_services([])) as port:
        det = RemoteDetector(f"rtsp://127.0.0.1:{port}/detect")
        det.on_result = got.append
        det.process_image(frame)
        deadline = time.time() + 5
        while not got and time.time() < deadline:
            det.update()
            time.sleep(0.02)
    try:
        assert len(got) == 1
        # server gone: requests time out; after RECONNECT_AFTER timeouts
        # the client re-opens, against a new server on the same port
        for _ in range(RemoteDetector.RECONNECT_AFTER):
            det.process_image(frame)
            t0 = time.time()
            while det.num_pending_requests and time.time() - t0 < 2:
                det.update()
                time.sleep(0.02)
        with serving(build_services([]), port=port):
            deadline = time.time() + 10
            recovered = False
            while time.time() < deadline and not recovered:
                det.process_image(frame)
                t0 = time.time()
                while time.time() - t0 < 1.5:
                    det.update()
                    if got[-1].request_id >= 2 and det.reconnects > 0:
                        recovered = True
                        break
                    time.sleep(0.02)
            assert recovered, (det.reconnects, len(got))
    finally:
        det.close()
