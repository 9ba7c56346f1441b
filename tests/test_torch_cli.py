"""The port's client-side CLIs on the CPU: detector, client, demo,
httpserver and inspect_weights, held against the JAX package's tools
where they print the same thing.

- ``cli.detector`` (``device="cpu"``, f32, synthetic:tiny): per image one
  ``(wall_seconds, results)`` line whose results equal the JAX
  ``TPUDetector``'s on the shared JAX engine at the engine tolerance of
  tests/test_torch_engine.py;
- ``cli.client -n``: exits 0 once the port's dummy server has answered;
- ``cli.demo``: oneshot and stream modes write annotated frames (dummy,
  remote and local backends); its helpers equal the JAX demo's;
- ``cli.httpserver``: GET / echo, 404, HEAD answered with zero bytes;
- ``cli.inspect_weights``: the text equals the JAX tool's line for line.
"""

import ast
import asyncio
import contextlib
import io
import pathlib
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fastdet_tpu.runtime.detector import TPUDetector
from fastdet_tpu_torch.cli import client as client_cli
from fastdet_tpu_torch.cli import demo, detector, httpserver, inspect_weights
from fastdet_tpu_torch.runtime import jpeg
from fastdet_tpu_torch.runtime.server import build_services
from tests.test_torch_client_api import _assert_close, serving

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDATA = REPO / "testdata"


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# detector and client
# ---------------------------------------------------------------------------

def test_detector_cli_matches_tpu_detector(tiny_f32_engine):
    names = ["scene1.jpg", "scene3.jpg"]
    paths = [str(TESTDATA / n) for n in names]
    before = set(threading.enumerate())
    rc, out = _stdout(detector.main, ["detector", "-m", "f32", "-t", "0.3",
                                      "synthetic:tiny"] + paths,
                      device="cpu")
    assert rc == 0
    assert [t for t in threading.enumerate() if t not in before] == []
    lines = out.strip().splitlines()
    assert len(lines) == len(names)
    jdet = TPUDetector(tiny_f32_engine)
    for line, p in zip(lines, paths):
        dt, _, rest = line.partition(" ")
        assert 0 < float(dt) < 60
        got = ast.literal_eval(rest)
        assert len(got) > 0
        _assert_close(got, jdet.perform(pathlib.Path(p).read_bytes(), 0.3))


def test_detector_cli_usage():
    rc, out = _stdout(detector.main, ["detector"], device="cpu")
    assert rc == 100 and out.startswith("usage:")
    rc, _ = _stdout(detector.main, ["detector", "-x"], device="cpu")
    assert rc == 100


def test_client_cli_bounded_run():
    services = build_services([])
    seen = []
    real = services["detect"].detector.perform
    services["detect"].detector.perform = \
        lambda data, threshold=0.1: seen.append(threshold) or real(data)
    with serving(services) as port:
        rc = client_cli.main(["client", "-t", "0.01", "-n", "3",
                              f"rtsp://127.0.0.1:{port}/detect",
                              str(TESTDATA / "scene1.jpg")])
    assert rc == 0
    assert len(seen) == 3
    rc, out = _stdout(client_cli.main, ["client", "http://x"])
    assert rc == 100 and out.startswith("usage:")


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def _scene(tmp_path):
    img = np.zeros((200, 320, 3), np.uint8)
    img[:] = (40, 80, 120)
    src = tmp_path / "cam.jpg"
    src.write_bytes(jpeg.encode_rgb(img))
    return img, src


def test_demo_helpers_equal_jax():
    from fastdet_tpu.cli import demo as jax_demo

    for w, h in ((640, 480), (480, 640), (416, 416), (200, 320)):
        assert demo.centered_square_area(w, h) == \
            jax_demo.centered_square_area(w, h)
    for labels in ("auto", "coco", "rsu", "shapes", "shapes9", "shapes80"):
        for n in (3, 9, 80, 4):
            args = SimpleNamespace(labels=labels)
            assert demo._names_for(args, n) == jax_demo._names_for(args, n)


def test_demo_oneshot_dummy(tmp_path):
    img, src = _scene(tmp_path)
    out = tmp_path / "out"
    assert demo.main(["demo", "--dummy", "-o", str(out), str(src)]) == 0
    drawn = jpeg.decode_rgb((out / "cam.jpg").read_bytes())
    assert drawn.shape == img.shape
    assert (np.abs(drawn.astype(int) - img.astype(int)).sum(axis=2)
            > 30).any()


def test_demo_stream_dummy(tmp_path, caplog):
    img, src = _scene(tmp_path)
    out = tmp_path / "out"
    with caplog.at_level("INFO"):
        assert demo.main(["demo", "--dummy", "--stream", "-n", "6",
                          "--interval", "0.05", "-o", str(out),
                          str(src)]) == 0
    frames = sorted(out.glob("frame_*.jpg"))
    assert len(frames) == 6
    last = jpeg.decode_rgb(frames[-1].read_bytes())
    assert (np.abs(last.astype(int) - img.astype(int)).sum(axis=2)
            > 30).any()
    assert "Total" in caplog.text and "Inference" in caplog.text


def test_demo_oneshot_remote(tmp_path):
    """Remote mode (-u) against the port's dummy server: the dummy's cat
    box drawn on the frame."""
    img, src = _scene(tmp_path)
    out = tmp_path / "out"
    with serving(build_services([])) as port:
        assert demo.main(["demo", "-u", f"rtsp://127.0.0.1:{port}/detect",
                          "-o", str(out), str(src)]) == 0
    drawn = jpeg.decode_rgb((out / "cam.jpg").read_bytes())
    assert (np.abs(drawn.astype(int) - img.astype(int)).sum(axis=2)
            > 30).any()


def test_demo_oneshot_local_engine(tmp_path):
    """Local mode on a CPU engine: every image annotated, and the engine
    the demo built is closed when it ends."""
    out = tmp_path / "out"
    paths = [str(TESTDATA / n) for n in ("scene1.jpg", "scene2.jpg")]
    before = set(threading.enumerate())
    assert demo.main(["demo", "-w", "synthetic:tiny", "-m", "f32", "-t",
                      "0.3", "-o", str(out)] + paths, device="cpu") == 0
    assert [t for t in threading.enumerate() if t not in before] == []
    for p in paths:
        src = jpeg.decode_rgb(pathlib.Path(p).read_bytes())
        drawn = jpeg.decode_rgb((out / pathlib.Path(p).name).read_bytes())
        assert drawn.shape == src.shape
        assert (drawn != src).any()


def test_model_clis_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.main(["detector", "synthetic:tiny",
                       str(TESTDATA / "scene1.jpg")])
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["demo", "-o", str(tmp_path),
                   str(TESTDATA / "scene1.jpg")])


# ---------------------------------------------------------------------------
# httpserver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _diag():
    srv = httpserver.DiagServer(host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()

    def runner():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(srv.serve())
        except asyncio.CancelledError:
            pass

    thread = threading.Thread(target=runner, daemon=True)
    thread.start()
    try:
        for _ in range(500):
            if srv.bound_port is not None:
                break
            time.sleep(0.01)
        assert srv.bound_port is not None
        yield srv.bound_port
    finally:
        loop.call_soon_threadsafe(
            lambda: [t.cancel() for t in asyncio.all_tasks(loop)])
        thread.join(5)
        if not thread.is_alive():
            loop.close()
    assert not thread.is_alive()


def test_httpserver_contract():
    with _diag() as port:
        base = f"http://127.0.0.1:{port}"
        req = urllib.request.Request(base + "/", headers={"X-Probe": "hi"})
        body = urllib.request.urlopen(req, timeout=5).read().decode()
        assert body.startswith("('GET / HTTP/1.1'")
        assert "'X-Probe': 'hi'" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert e.value.code == 404 and e.value.read() == b"not found"
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        try:
            s.sendall(b"HEAD / HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(1024) == b""
        finally:
            s.close()
        assert urllib.request.urlopen(base + "/", timeout=5).status == 200


def test_httpserver_usage():
    rc, out = _stdout(httpserver.main, ["httpserver", "-x"])
    assert rc == 100 and out.startswith("usage:")


# ---------------------------------------------------------------------------
# inspect_weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_onnx(tmp_path_factory):
    from fastdet_tpu_torch.models import onnx_io, weights

    spec, params = weights.load_model("synthetic:tiny", num_classes=4)
    path = tmp_path_factory.mktemp("onnx") / "tiny4.onnx"
    onnx_io.save_onnx(str(path), spec, params)
    return str(path)


@pytest.mark.parametrize("argv", [
    ["-g", "tiny"], ["-g", "full", "-c", "9"], ["-c", "4", "synthetic:tiny"],
    [str(REPO / "weights" / "detect3_tiny.npz")], ["-c", "4", "onnx"],
    ["-r", "onnx"],
    [], ["-q"]], ids=["graph-tiny", "graph-full9", "synthetic", "npz",
                      "onnx", "raw-onnx", "usage", "bad-flag"])
def test_inspect_weights_text_equals_jax(argv, tiny_onnx):
    from fastdet_tpu.cli import inspect_weights as jax_inspect

    argv = ["inspect_weights"] + [tiny_onnx if a == "onnx" else a
                                  for a in argv]
    rc, out = _stdout(inspect_weights.main, argv)
    jrc, jout = _stdout(jax_inspect.main, argv)
    assert rc == jrc
    assert out.splitlines() == jout.splitlines()
    assert len(out.splitlines()) > 0
