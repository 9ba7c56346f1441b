"""The port's host JPEG decode (fastdet_tpu_torch.runtime.jpeg) against
the JAX package's: the same FASTDET_JPEG_BACKEND values and default
order, the same pixels on the fixtures."""

import logging
import pathlib

import numpy as np
import pytest

from fastdet_tpu.runtime import jpeg as jax_jpeg
from fastdet_tpu_torch.runtime import jpeg as port_jpeg

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))


@pytest.mark.parametrize("backend,decoder", [("auto", "cv2"),
                                             ("cv2", "cv2"),
                                             ("native", "native")])
def test_decode_rgb_equals_jax(monkeypatch, backend, decoder):
    monkeypatch.setattr(jax_jpeg, "_BACKEND", backend)
    monkeypatch.setattr(port_jpeg, "_BACKEND", backend)
    if backend != "native":
        # the JAX module imports cv2 at import only for auto/cv2
        assert jax_jpeg._cv2 is not None
    for name in FIXTURES:
        data = (TESTDATA / name).read_bytes()
        got = port_jpeg.decode_rgb(data)
        assert port_jpeg.LAST_DECODER == decoder, name
        np.testing.assert_array_equal(got, jax_jpeg.decode_rgb(data),
                                      err_msg=name)


def test_default_backend_is_auto():
    assert port_jpeg._BACKEND == jax_jpeg._BACKEND == "auto"


def test_without_cv2_and_pil_auto_decodes_natively(monkeypatch, caplog):
    """On a machine with neither OpenCV nor PIL, ``auto`` decodes with
    the native decoder and says so once."""
    monkeypatch.setattr(port_jpeg, "_BACKEND", "auto")
    monkeypatch.setattr(port_jpeg, "_cv2", lambda: None)
    monkeypatch.setattr(port_jpeg, "_pil_image", lambda: None)
    monkeypatch.setattr(port_jpeg, "_NATIVE_NOTED", False)
    data = (TESTDATA / "scene1.jpg").read_bytes()
    with caplog.at_level(logging.WARNING, logger=port_jpeg.__name__):
        a = port_jpeg.decode_rgb(data)
        b = port_jpeg.decode_rgb(data)
    assert port_jpeg.LAST_DECODER == "native"
    assert sum("native decoder" in r.getMessage()
               for r in caplog.records) == 1
    np.testing.assert_array_equal(a, b)
    from fastdet_tpu_torch.runtime import native_jpeg
    np.testing.assert_array_equal(a, native_jpeg.decode_rgb(data))
    # the reference's pixels differ by a few levels on this fixture
    ref = jax_jpeg.decode_rgb(data).astype(np.int16)
    assert 0 < np.abs(a.astype(np.int16) - ref).max() <= 3


def test_invalid_bytes_raise(monkeypatch):
    for backend in ("auto", "native"):
        monkeypatch.setattr(port_jpeg, "_BACKEND", backend)
        with pytest.raises(port_jpeg.JpegError):
            port_jpeg.decode_rgb(b"\xff\xd8not a jpeg")
