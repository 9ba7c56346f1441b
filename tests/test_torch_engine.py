"""The port's whole slice on the CPU: fastdet_tpu_torch's DetectionEngine
(device="cpu", f32, synthetic:tiny, buckets (1, 2)) against the JAX
package's engine (the shared tiny_f32_engine fixture) on every
testdata/*.jpg, and the port's server answering the port's client.

Frames must take the same ingest tiers; results must have the same count
and classes, boxes at IoU >= 0.999 and confidences within 1/255 — the
convolutions sum in another order than XLA's (and the JAX engine also
rewrites its stem to space-to-depth), so float results differ by ulps."""

import asyncio
import pathlib
import struct
import threading

import numpy as np
import pytest

from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.runtime.client import DetectClient
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from fastdet_tpu_torch.runtime.server import DetectionServer, build_services

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))


@pytest.fixture(scope="module")
def port_engine():
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1, 2),
                          device="cpu")
    yield eng
    eng.close()


def _records(blob):
    return [struct.unpack(">BBhhhh", blob[i:i + 10])
            for i in range(0, len(blob), 10)]


def _iou(a, b):
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    iw = max(0, min(ax + aw, bx + bw) - max(ax, bx))
    ih = max(0, min(ay + ah, by + bh) - max(ay, by))
    union = aw * ah + bw * bh - iw * ih
    return 1.0 if union <= 0 else iw * ih / union


def _assert_close(got, want):
    """Result tuples (klass, conf, x, y, w, h) of one frame."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert abs(g[1] - w[1]) <= 1.0 / 255.0
        assert _iou(g[2:], w[2:]) >= 0.999


def _dispatch(eng, datas, thr=0.3):
    eng._tier_hint.clear()
    res = eng.detect_async_sparse(datas, [thr] * len(datas))
    return res, eng.fetch(res, len(datas)), eng.fetch_wire(res, len(datas))


@pytest.mark.parametrize("name", FIXTURES)
def test_engine_matches_jax_engine(port_engine, tiny_f32_engine, native_ready,
                                   name):
    data = (TESTDATA / name).read_bytes()
    res, got, wire = _dispatch(port_engine, [data])
    jres, want, jwire = _dispatch(tiny_f32_engine, [data])
    assert res.counts == jres.counts
    assert res.unresolved == jres.unresolved == ()
    assert len(got[0]) > 0
    _assert_close(got[0], want[0])
    # the wire records carry the same detections (8-bit conf, i16 coords)
    assert len(wire[0]) == len(jwire[0])
    for g, w in zip(_records(wire[0]), _records(jwire[0])):
        assert g[0] == w[0] and abs(g[1] - w[1]) <= 1
        assert _iou(g[2:], w[2:]) >= 0.99


def test_mixed_batch_overflow_row_zeroed(port_engine, tiny_f32_engine,
                                         native_ready):
    """A std-tier batch where one frame overflows: its row is zeroed and
    it re-routes (dense tier or planes) while the other keeps its std
    row; tiers and results equal the JAX engine's."""
    datas = [(TESTDATA / n).read_bytes() for n in ("adv_noise.jpg",
                                                    "scene1.jpg")]
    res, got, _ = _dispatch(port_engine, datas)
    jres, want, _ = _dispatch(tiny_f32_engine, datas)
    assert res.counts == jres.counts == {"sparse": 1, "planes": 1}
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_tier_memory_follows_jax(port_engine, tiny_f32_engine, native_ready):
    """Mostly-dense traffic sets the dense tier hint in both engines."""
    datas = [(TESTDATA / n).read_bytes() for n in ("adv_night.jpg",
                                                    "adv_night.jpg")]
    res, _, _ = _dispatch(port_engine, datas)
    jres, _, _ = _dispatch(tiny_f32_engine, datas)
    assert res.counts == jres.counts == {"sparse_dense": 2}
    assert port_engine._tier_hint == tiny_f32_engine._tier_hint == {
        (2, 2): "dense"}
    port_engine._tier_hint.clear()
    tiny_f32_engine._tier_hint.clear()


def test_pixel_path_pads_and_rejects_wrong_size(port_engine):
    img = np.full((416, 416, 3), 90, np.uint8)
    assert port_engine.detect([img, img], [2.0, 2.0]) == [[], []]
    with pytest.raises(ValueError):
        port_engine.detect([np.zeros((8, 8, 3), np.uint8)], [0.5])


def test_int8_mode_serves(native_ready):
    """The server's int8 mode builds an int8 engine (tiny: no s2d stem to
    rewrite) that answers frames through the sparse ingest."""
    from fastdet_tpu_torch.models import quantize
    from fastdet_tpu_torch.runtime import jpeg

    data = (TESTDATA / "scene1.jpg").read_bytes()
    services = build_services(["tiny:80:synthetic:tiny"], mode="int8",
                              warmup=False, device="cpu", buckets=(1,),
                              calibration_images=jpeg.decode_rgb(data)[None])
    eng = services["tiny"].engine
    try:
        assert isinstance(eng.net, quantize.Int8Net)
        assert eng.spec.layers == weights.load_model(
            "synthetic:tiny", num_classes=80)[0].layers
        assert eng.calibration_s > 0 and set(eng.act_scales) == {
            l.name for l in eng.spec.conv_specs()}
        res, got, wire = _dispatch(eng, [data])
        assert res.counts == {"sparse": 1}
        assert len(wire[0]) == 10 * len(got[0])
    finally:
        eng.close()


def test_server_answers_client_and_stops(port_engine, native_ready):
    before = set(threading.enumerate())
    services = build_services(["tiny:80:synthetic:tiny"], mode="f32",
                              warmup=False, device="cpu", buckets=(1, 2))
    eng = services["tiny"].engine
    server = DetectionServer(services, port=0, host="127.0.0.1")
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
    assert ready.wait(30)
    names = ["scene2.jpg", "adv_ui.jpg", "scene3.jpg"]
    client = DetectClient("127.0.0.1", server.bound_port, path="tiny")
    try:
        client.open(timeout=10)
        for i, n in enumerate(names):
            client.request(i + 1, 0.3, (TESTDATA / n).read_bytes())
        replies = [client.wait_response(i + 1, timeout=30)
                   for i in range(len(names))]
    finally:
        client.close()
        state["loop"].call_soon_threadsafe(server.request_shutdown)
        state["loop"].call_soon_threadsafe(state["task"].cancel)
        thread.join(30)
        eng.close()
    assert not thread.is_alive()
    # every thread the server, its engine and its executors started is gone
    assert [t for t in threading.enumerate() if t not in before] == []
    for n, (_, recs) in zip(names, replies):
        _, want, _ = _dispatch(port_engine, [(TESTDATA / n).read_bytes()])
        assert len(recs) == len(want[0]) > 0
        for r, w in zip(recs, want[0]):
            assert r[0] == w[0]
