"""The held-out accuracy gate through the port's server, beside the JAX
engine on the same frames.

The reference's gate (tests/test_trained_detector.py,
tests/test_trained_detector80.py): held-out synthetic scenes, JPEG
encoded at quality 90, sent one at a time at threshold 0.2 over loopback;
a frame is ok when every planted object is matched (IoU >= 0.5, right
class). Here the port's ``build_services`` serves on the CPU in f32 and
the JAX engine runs the same frames; the per-frame ok lists and the
matched-object counts must be equal (the engines differ by conv
summation order only, tests/test_torch_engine.py).

The tier-1 test uses the committed 3-class tiny checkpoint over that
gate's 20 held-out seeds (30000-30019; 19 frames ok and 33 of 34 objects
on both sides when written). The full 48-frame ``detect80_full`` gate in bf16
and int8 (chip_smoke.py [10] runs it on the card) is here too, for the
port and the JAX package side by side, marked slow.
"""

import asyncio
import contextlib
import pathlib
import struct
import threading

import pytest

from fastdet_tpu.runtime.engine import DetectionEngine as JaxEngine
from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu_torch.data import synth
from fastdet_tpu_torch.runtime import jpeg
from fastdet_tpu_torch.runtime.client import DetectClient
from fastdet_tpu_torch.runtime.server import DetectionServer, build_services

REPO = pathlib.Path(__file__).resolve().parent.parent
THRESHOLD = 0.2
REQUIRED_FRAME_RATE = 0.9


@contextlib.contextmanager
def _serving(services):
    """A DetectionServer on 127.0.0.1 in a thread; yields its port and
    stops it, and the engines' workers, on exit."""
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
    try:
        assert ready.wait(60)
        yield server.bound_port
    finally:
        if "task" in state:
            state["loop"].call_soon_threadsafe(server.request_shutdown)
            state["loop"].call_soon_threadsafe(state["task"].cancel)
        thread.join(60)
        for svc in services.values():
            svc.engine.close()
    assert not thread.is_alive()


def _frame_scores(records_per_frame, boxes, labels):
    """Per frame: is every planted object matched? -> (ok list, matched,
    total)."""
    ok, matched, total = [], 0, 0
    for recs, bx, lb in zip(records_per_frame, boxes, labels):
        dets = [(k, c / 255.0, x, y, w, h) for (k, c, x, y, w, h) in recs]
        m, t, _fp = synth.match_detections(dets, bx, lb)
        ok.append(m == t)
        matched += m
        total += t
    return ok, matched, total


def _held_out(seeds, num_classes):
    imgs, boxes, labels = synth.make_dataset(seeds, num_classes=num_classes)
    return [jpeg.encode_rgb(im, quality=90) for im in imgs], boxes, labels


def _port_served(ckpt, num_classes, jpegs, mode, calib=None):
    """Each frame through the port's server (device CPU) -> (records per
    frame, the service's ingest counts)."""
    services = build_services([f"shapes:{num_classes}:{ckpt}"], mode=mode,
                              warmup=False, device="cpu", buckets=(1, 2),
                              calibration_images=calib)
    svc = services["shapes"]
    results = []
    with _serving(services) as port:
        c = DetectClient("127.0.0.1", port, "shapes")
        c.open(timeout=10)
        try:
            for i, data in enumerate(jpegs, start=1):
                c.request(i, THRESHOLD, data)
                results.append(c.wait_response(i, timeout=300)[1])
        finally:
            c.close()
    return results, dict(svc.ingest)


def _jax_engine_records(ckpt, jpegs, mode, calib=None):
    """Each frame through the JAX engine's sparse route, as its server
    sends it -> wire records per frame."""
    spec, params = jax_weights.load_npz(str(ckpt))
    eng = JaxEngine(spec, params, mode=mode, buckets=(1, 2),
                    calibration_images=calib)
    out = []
    for data in jpegs:
        res = eng.detect_async_sparse([data], [THRESHOLD])
        assert res is not None and not res.unresolved
        blob = eng.fetch_wire(res, 1)[0]
        out.append([struct.unpack(">BBhhhh", blob[i:i + 10])
                    for i in range(0, len(blob), 10)])
    return out


def test_detect3_tiny_gate_matches_jax_engine(native_ready):
    ckpt = REPO / "weights" / "detect3_tiny.npz"
    jpegs, boxes, labels = _held_out(range(30000, 30020), 3)
    records, ingest = _port_served(ckpt, 3, jpegs, "f32")
    assert ingest["pixels"] == 0, ingest
    ok, matched, total = _frame_scores(records, boxes, labels)
    jok, jmatched, jtotal = _frame_scores(
        _jax_engine_records(ckpt, jpegs, "f32"), boxes, labels)
    assert (ok, matched, total) == (jok, jmatched, jtotal)
    assert sum(ok) / len(ok) >= REQUIRED_FRAME_RATE, (ok, matched, total)


@pytest.mark.slow
def test_detect80_full_gate_port_and_jax_side_by_side(native_ready):
    """tests/test_trained_detector80.py's gate through the port's server
    on the CPU, with the JAX engine on the same frames: each mode clears
    0.9, no frame takes the pixel route, the modes disagree on at most
    max(1, 48 // 10) frames, and the port's ok lists and matched counts
    equal the JAX engine's."""
    ckpt = REPO / "weights" / "detect80_full.npz"
    jpegs, boxes, labels = _held_out(range(230100, 230148), 80)
    calib = synth.make_dataset(range(240500, 240506), num_classes=80)[0]
    ok_by_mode = {}
    for mode in ("bf16", "int8"):
        c = calib if mode == "int8" else None
        records, ingest = _port_served(ckpt, 80, jpegs, mode, c)
        assert ingest["pixels"] == 0, ingest
        ok, matched, total = _frame_scores(records, boxes, labels)
        jok, jmatched, jtotal = _frame_scores(
            _jax_engine_records(ckpt, jpegs, mode, c), boxes, labels)
        failing = [i for i, o in enumerate(ok) if not o]
        jfailing = [i for i, o in enumerate(jok) if not o]
        assert (failing, matched, total) == (jfailing, jmatched, jtotal), (
            mode, failing, jfailing, matched, jmatched)
        assert sum(ok) / len(ok) >= REQUIRED_FRAME_RATE, (
            f"{mode}: only {sum(ok)}/{len(ok)} held-out frames fully "
            f"localized ({matched}/{total} objects); failing {failing}")
        ok_by_mode[mode] = ok
    diff = sum(a != b for a, b in zip(ok_by_mode["bf16"], ok_by_mode["int8"]))
    assert diff <= max(1, len(jpegs) // 10), diff
