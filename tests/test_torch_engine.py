"""The port's whole slice on the CPU: fastdet_tpu_torch's DetectionEngine
(device="cpu", f32, synthetic:tiny, buckets (1, 2)) against the JAX
package's engine (the shared tiny_f32_engine fixture) on every
testdata/*.jpg, and the port's server answering the port's client.

Frames must take the same ingest tiers; results must have the same count
and classes, boxes at IoU >= 0.999 and confidences within 1/255 — the
convolutions sum in another order than XLA's (and the JAX engine also
rewrites its stem to space-to-depth), so float results differ by ulps."""

import asyncio
import contextlib
import logging
import pathlib
import re
import struct
import threading

import numpy as np
import pytest

from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.runtime.client import DetectClient
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from fastdet_tpu_torch.runtime.server import (DetectionServer, ModelService,
                                              build_services)
from fastdet_tpu_torch.utils import profiling
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES

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


@contextlib.contextmanager
def _serving(services):
    """A DetectionServer over ``services`` on 127.0.0.1 (a free port), on
    a thread with its own event loop; shut down and joined on exit."""
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
    try:
        yield server
    finally:
        # one callback: after request_shutdown the serve task may end
        # and the loop close before a second call could be scheduled
        task = state["task"]
        state["loop"].call_soon_threadsafe(
            lambda: (server.request_shutdown(), task.cancel()))
        thread.join(30)
    assert not thread.is_alive()


def test_server_answers_client_and_stops(port_engine, native_ready):
    before = set(threading.enumerate())
    services = build_services(["tiny:80:synthetic:tiny"], mode="f32",
                              warmup=False, device="cpu", buckets=(1, 2))
    eng = services["tiny"].engine
    names = ["scene2.jpg", "adv_ui.jpg", "scene3.jpg"]
    try:
        with _serving(services) as server:
            client = DetectClient("127.0.0.1", server.bound_port,
                                  path="tiny")
            try:
                client.open(timeout=10)
                for i, n in enumerate(names):
                    client.request(i + 1, 0.3, (TESTDATA / n).read_bytes())
                replies = [client.wait_response(i + 1, timeout=30)
                           for i in range(len(names))]
            finally:
                client.close()
    finally:
        eng.close()
    # every thread the server, its engine and its executors started is gone
    assert [t for t in threading.enumerate() if t not in before] == []
    for n, (_, recs) in zip(names, replies):
        _, want, _ = _dispatch(port_engine, [(TESTDATA / n).read_bytes()])
        assert len(recs) == len(want[0]) > 0
        for r, w in zip(recs, want[0]):
            assert r[0] == w[0]


#: spans of one request, and of one batch or one part of it
REQUEST_SPANS = ("session.reassembly", "service.queue_wait",
                 "session.respond", "request_e2e")
BATCH_SPANS = ("service.pipeline_wait", "dispatch_batch", "engine.xfer_wait",
               "engine.xfer_run", "fetch_batch", "infer_batch")


def test_server_spans_partition_each_request(native_ready, monkeypatch,
                                            caplog):
    """Through the wire on the CPU engine: each answered request's spans
    share their stamps, so queue_wait + pipeline_wait + infer_batch +
    respond is its request_e2e, and ``msec`` is request_e2e truncated to
    ms; every span carries its request or batch id, and every part run
    on the transfer worker belongs to a batch that answered a request.
    The service's periodic log line prints the terms' means over the
    requests answered, which sum to request_e2e's."""
    monkeypatch.setattr(ModelService, "STATS_EVERY", 1)
    caplog.set_level(logging.INFO, logger="fastdet_tpu_torch.runtime.server")
    services = build_services(["tiny:80:synthetic:tiny"], mode="f32",
                              warmup=False, device="cpu", buckets=(1, 2))
    eng = services["tiny"].engine
    names = ["scene2.jpg", "adv_ui.jpg", "scene3.jpg", "scene1.jpg",
             "adv_night.jpg"]
    try:
        with _serving(services) as server:
            STAGES.reset()
            client = DetectClient("127.0.0.1", server.bound_port,
                                  path="tiny")
            try:
                client.open(timeout=10)
                # three at once (batches of two and a carried one), then
                # one at a time
                for i, n in enumerate(names[:3]):
                    client.request(i + 1, 0.3, (TESTDATA / n).read_bytes())
                msecs = [client.wait_response(i + 1, timeout=30)[0]
                         for i in range(3)]
                for i, n in enumerate(names[3:], 4):
                    client.request(i, 0.3, (TESTDATA / n).read_bytes())
                    msecs.append(client.wait_response(i, timeout=30)[0])
            finally:
                client.close()
            snap = STAGES.snapshot()
    finally:
        eng.close()
    events = snap[profiling.EVENTS]
    for e in events:
        assert e["name"] in REQUEST_SPANS + BATCH_SPANS, e
        assert e["start_us"] <= e["end_us"], e
        if e["name"] in REQUEST_SPANS:
            assert e["rid"] is not None, e
        if e["name"] not in ("session.reassembly",):
            assert e["bid"] is not None, e
    by_rid = {}
    for e in events:
        if e["name"] in REQUEST_SPANS:
            by_rid.setdefault(e["rid"], {})[e["name"]] = e
    by_bid = {(e["name"], e["bid"]): e for e in events
              if e["name"] in ("service.pipeline_wait", "infer_batch")}
    # rids rise in the order one session's requests were reassembled
    assert sorted(by_rid) == sorted(by_rid, key=lambda r: by_rid[r][
        "session.reassembly"]["end_us"])
    assert len(by_rid) == len(names) == snap["request_e2e"]["count"]
    answered, terms = set(), {}
    for rid, msec in zip(sorted(by_rid), msecs):
        spans = by_rid[rid]
        assert set(spans) == set(REQUEST_SPANS)
        e2e, qw, rs = (spans["request_e2e"], spans["service.queue_wait"],
                       spans["session.respond"])
        bid = e2e["bid"]
        assert qw["bid"] == rs["bid"] == bid
        answered.add(bid)
        pw = by_bid[("service.pipeline_wait", bid)]
        ib = by_bid[("infer_batch", bid)]
        chain = [e2e["start_us"], qw["start_us"], qw["end_us"],
                 pw["start_us"], pw["end_us"], ib["start_us"],
                 ib["end_us"], rs["start_us"], rs["end_us"], e2e["end_us"]]
        assert chain[0] == chain[1] and chain[-2] == chain[-1]
        assert chain[2:8:2] == chain[3:9:2]
        # the reassembly ends at the stamp the request starts from
        assert spans["session.reassembly"]["end_us"] == e2e["start_us"]
        assert msec == int((e2e["end_us"] - e2e["start_us"]) // 1000)
        terms[rid] = [s["end_us"] - s["start_us"] for s in (qw, pw, ib, rs)]
    runs = [e for e in events if e["name"] == "engine.xfer_run"]
    assert runs and {e["bid"] for e in runs} <= answered
    assert {e["thread"] for e in runs} == {"fd-xfer0_0"}
    assert all(e["part"] for e in runs)
    assert snap["engine.xfer_run"]["count"] == snap[
        "engine.xfer_wait"]["count"] >= snap["infer_batch"]["count"]
    lines = [r.getMessage() for r in caplog.records
             if "request mean ms" in r.getMessage()]
    assert len(lines) == snap["infer_batch"]["count"]
    m = re.search(r"request mean ms over (\d+) answered: queue ([0-9.]+) "
                  r"\+ pipeline ([0-9.]+) \+ infer ([0-9.]+) \+ respond "
                  r"([0-9.]+) = ([0-9.]+) \(request_e2e\)$", lines[-1])
    assert m, lines[-1]
    # the last line is logged as the last request's batch finishes: the
    # requests before it are answered (the last two went one at a time)
    n = int(m.group(1))
    assert n == len(names) - 1
    want = [sum(terms[r][i] for r in sorted(terms)[:n]) / n / 1e3
            for i in range(4)]
    got = [float(m.group(i)) for i in range(2, 7)]
    assert got[:4] == pytest.approx(want, abs=0.006)
    assert got[4] == pytest.approx(sum(want), abs=0.006)
