"""The port's coefficient path against the JAX package's.

- ``jpeg_device.decode420`` / ``decode420_batch`` equal the JAX functions
  EXACTLY on the host decoder's coefficients of seeded JPEGs: both run
  the same f32 dequant, (64, 64) IDCT product, integer upsample and
  colour transform (the JAX side at f32 matmul precision, as its tests
  run it).
- The port's CPU engine (synthetic:tiny, f32, buckets (1, 2)) through
  ``detect_async_jpeg`` gives the JAX engine's records within
  tests/test_torch_engine.py's tolerance (same count and classes, IoU >=
  0.999, confidence within 1/255: the convs sum in another order).
- On one engine the coefficient route equals the sparse route exactly:
  both reach the same coefficients, then the same decode.
- ``detect_async_jpeg`` returns None where the JAX method does.
"""

import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet_tpu.ops import jpeg_device as jax_jpeg_device
from fastdet_tpu.runtime import jpeg as jax_jpeg
from fastdet_tpu.runtime import native_jpeg as jax_native_jpeg
from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.ops import jpeg_device
from fastdet_tpu_torch.runtime import native_jpeg
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from tests.test_torch_engine import _assert_close

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))


def _jpeg(seed, quality=90):
    """tests/test_engine_coeffs.py's frames: 8x8-blocky noise at 416,
    q90 unless asked, 4:2:0."""
    rng = np.random.RandomState(seed)
    img = np.kron(rng.randint(0, 255, (52, 52, 3), np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    return jax_jpeg.encode_rgb(img, quality)


def _coeffs(data):
    ci = native_jpeg.decode_coefficients(data)
    jci = jax_native_jpeg.decode_coefficients(data)
    for k in ("ycoef", "cbcoef", "crcoef", "qy", "qc"):
        np.testing.assert_array_equal(getattr(ci, k), getattr(jci, k))
    assert ci.is_420
    return ci


@pytest.fixture(scope="module")
def port_engine():
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1, 2),
                          device="cpu")
    yield eng
    eng.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode420_equals_jax(native_ready, seed):
    ci = _coeffs(_jpeg(seed))
    args = (ci.ycoef, ci.cbcoef, ci.crcoef, ci.qy, ci.qc)
    want = np.asarray(jax_jpeg_device.decode420(
        *[jnp.asarray(a) for a in args], 416, 416))
    got = jpeg_device.decode420(*[torch.from_numpy(a) for a in args],
                                416, 416).numpy()
    assert got.shape == (416, 416, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode420_batch_equals_jax(native_ready):
    """Three frames in one batch, each with its own quant tables."""
    datas = [_jpeg(3, quality=60), (TESTDATA / "scene1.jpg").read_bytes(),
             _jpeg(4, quality=95)]
    cis = [_coeffs(d) for d in datas]
    args = [np.stack([getattr(ci, k) for ci in cis])
            for k in ("ycoef", "cbcoef", "crcoef", "qy", "qc")]
    assert len({a.tobytes() for a in args[3]}) == 3
    assert len({a.tobytes() for a in args[4]}) == 3
    want = np.asarray(jax_jpeg_device.decode420_batch(
        *[jnp.asarray(a) for a in args], 416, 416))
    got = jpeg_device.decode420_batch(*[torch.from_numpy(a) for a in args],
                                      416, 416).numpy()
    assert got.shape == (3, 416, 416, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_coeff_route_matches_jax_engine(port_engine, tiny_f32_engine,
                                        native_ready, name):
    data = (TESTDATA / name).read_bytes()
    res = port_engine.detect_async_jpeg([data], [0.3])
    jres = tiny_f32_engine.detect_async_jpeg([data], [0.3])
    assert res is not None and jres is not None
    got = port_engine.fetch(res, 1)[0]
    want = tiny_f32_engine.fetch(jres, 1)[0]
    assert len(got) > 0
    _assert_close(got, want)


def test_coeff_route_batch_matches_jax_engine(port_engine, tiny_f32_engine,
                                              native_ready):
    """Two frames in one bucket-2 batch."""
    datas = [_jpeg(0), (TESTDATA / "scene2.jpg").read_bytes()]
    got = port_engine.fetch(port_engine.detect_async_jpeg(datas, [0.4] * 2),
                            2)
    want = tiny_f32_engine.fetch(
        tiny_f32_engine.detect_async_jpeg(datas, [0.4] * 2), 2)
    for g, w in zip(got, want):
        _assert_close(g, w)


@pytest.mark.parametrize("names", [("scene1.jpg",),
                                   ("scene3.jpg", "adv_night.jpg")])
def test_coeff_route_equals_sparse_route(port_engine, native_ready, names):
    datas = [(TESTDATA / n).read_bytes() for n in names]
    thr = [0.3] * len(datas)
    port_engine._tier_hint.clear()
    sparse = port_engine.detect_async_sparse(datas, thr)
    assert set(sparse.counts) <= {"sparse", "sparse_dense"}
    coeff = port_engine.detect_async_jpeg(datas, thr)
    assert port_engine.fetch(coeff, len(datas)) == port_engine.fetch(
        sparse, len(datas))
    assert port_engine.fetch_wire(coeff, len(datas)) == \
        port_engine.fetch_wire(sparse, len(datas))
    port_engine._tier_hint.clear()


def test_coeff_route_rejects_non420(port_engine, tiny_f32_engine,
                                    native_ready):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((416, 416, 3), np.uint8)).save(
        buf, format="JPEG", quality=90, subsampling=0)
    for eng in (port_engine, tiny_f32_engine):
        assert eng.detect_async_jpeg([buf.getvalue()], [0.5]) is None


def test_coeff_route_rejects_wrong_size(port_engine, tiny_f32_engine,
                                        native_ready):
    data = jax_jpeg.encode_rgb(np.zeros((224, 224, 3), np.uint8))
    for eng in (port_engine, tiny_f32_engine):
        assert eng.detect_async_jpeg([data], [0.5]) is None
    # one bad frame sends the whole batch elsewhere
    good = (TESTDATA / "scene1.jpg").read_bytes()
    assert port_engine.detect_async_jpeg([good, data], [0.5] * 2) is None


def test_coeff_route_rejects_corrupt_bytes(port_engine, native_ready):
    assert port_engine.detect_async_jpeg([b"\xff\xd8 not a jpeg"],
                                         [0.5]) is None
