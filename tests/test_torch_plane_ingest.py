"""Kernel B2 (fastdet_tpu_torch/ops/plane_ingest.py) against the JAX
package's fused plane ingest (fastdet_tpu/ops/pallas/plane_ingest.py,
interpret=True as its own tests run it) and its XLA formulation
(upsample2x_triangle + ycbcr_to_rgb01), bit for bit at 32, 64 and 416.

On the CPU the port's wrapper takes its plain version; the CUDA kernel
itself is held against that plain version by tests/test_torch_kernels_gpu.py
and chip_smoke.py on the card."""

import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fastdet_tpu.ops import jpeg_device as jax_jd
from fastdet_tpu.ops.pallas import plane_ingest as jax_pi
from fastdet_tpu_torch.ops import plane_ingest as pi
from fastdet_tpu_torch.runtime import native_jpeg

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"


def _planes(size, seed, b=2):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (b, size, size)).astype(np.uint8)
    cb = rng.randint(0, 256, (b, size // 2, size // 2)).astype(np.uint8)
    cr = rng.randint(0, 256, (b, size // 2, size // 2)).astype(np.uint8)
    return y, cb, cr


def _xla(y, cb, cr):
    return np.stack([np.asarray(jax_jd.ycbcr_to_rgb01(
        jnp.asarray(y[i], jnp.float32),
        jax_jd.upsample2x_triangle(jnp.asarray(cb[i], jnp.float32)),
        jax_jd.upsample2x_triangle(jnp.asarray(cr[i], jnp.float32))))
        for i in range(y.shape[0])])


@pytest.mark.parametrize("size", [32, 64, 416])
def test_plain_matches_pallas_interpret_and_xla(size):
    y, cb, cr = _planes(size, seed=size)
    got = pi.plane_ingest_batch(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    got = got.numpy()
    xla = _xla(y, cb, cr)
    np.testing.assert_array_equal(got, xla)
    want = np.asarray(jax_pi.plane_ingest_batch(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), interpret=True))
    if size < 416:
        np.testing.assert_array_equal(got, want)
    else:
        # At 416 the JAX kernel in interpret mode and the JAX XLA path
        # themselves disagree on 2 of 1,038,336 values (one uint8 level
        # each, seed 416); the port equals the XLA path exactly, so every
        # difference from the kernel must be one of the kernel's own.
        diff = got != want
        assert np.array_equal(diff, want != xla)
        assert diff.sum() <= 4
        assert np.abs(got - want).max() <= 1.0 / 255.0 + 1e-7


def test_plain_matches_on_fixture_planes():
    data = (TESTDATA / "adv_ui.jpg").read_bytes()
    y, cb, cr = native_jpeg.decode_planes420(data)
    got = pi.plane_ingest_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)[None])
          for a in (y, cb, cr))).numpy()
    np.testing.assert_array_equal(got, _xla(y[None], cb[None], cr[None]))


def test_wrapper_takes_row_views():
    """The engine hands B2 views into one packed [Y | Cb | Cr | thr] row
    per frame (batch stride = row length); the result must equal that of
    contiguous planes."""
    y, cb, cr = _planes(32, seed=5)
    yb, cw = 32 * 32, 16 * 16
    packed = np.concatenate(
        [y.reshape(2, -1), cb.reshape(2, -1), cr.reshape(2, -1),
         np.zeros((2, 4), np.uint8)], axis=1)
    p = torch.from_numpy(packed)
    views = (p[:, :yb].view(2, 32, 32), p[:, yb:yb + cw].view(2, 16, 16),
             p[:, yb + cw:yb + 2 * cw].view(2, 16, 16))
    np.testing.assert_array_equal(
        pi.plane_ingest_batch(*views).numpy(), _xla(y, cb, cr))


def _rect_planes(h, w, seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (b, h, w)).astype(np.uint8),
            rng.randint(0, 256, (b, h // 2, w // 2)).astype(np.uint8),
            rng.randint(0, 256, (b, h // 2, w // 2)).astype(np.uint8))


@pytest.mark.parametrize("h,w", [(32, 34), (6, 2), (18, 530)])
def test_plain_matches_xla_at_widths_not_multiple_of_4(h, w):
    """Any even H and W: widths that end a row in a 2-pixel group (the
    kernel's ragged tail) and one wider than the kernel's 512-column
    chunk."""
    y, cb, cr = _rect_planes(h, w, seed=h + w)
    got = pi.plane_ingest_batch(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.shape == (2, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), _xla(y, cb, cr))


def test_wrapper_takes_packed_rows_at_odd_frames():
    """The planes tier packs each 416x416 frame as one [Y | Cb | Cr | thr]
    row of 259,588 bytes, so frame b's planes start at 4*b mod 16 bytes:
    views cut at odd batch indices give the same result as contiguous
    planes."""
    b, size = 4, 416
    y, cb, cr = _planes(size, seed=7, b=b)
    yb, cw = size * size, (size // 2) ** 2
    row = yb + 2 * cw + 4
    assert row == 259588
    packed = np.concatenate(
        [y.reshape(b, -1), cb.reshape(b, -1), cr.reshape(b, -1),
         np.zeros((b, 4), np.uint8)], axis=1)
    p = torch.from_numpy(packed)
    views = (p[:, :yb].view(b, size, size),
             p[:, yb:yb + cw].view(b, size // 2, size // 2),
             p[:, yb + cw:yb + 2 * cw].view(b, size // 2, size // 2))
    want = pi.plane_ingest_plain(*(torch.from_numpy(a) for a in (y, cb, cr)))
    for sel in (slice(1, 2), slice(1, 4, 2), slice(0, 4)):
        got = pi.plane_ingest_batch(*(v[sel] for v in views))
        torch.testing.assert_close(got, want[sel], rtol=0, atol=0)
