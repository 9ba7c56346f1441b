"""The port's plain JPEG tail (fastdet_tpu_torch/ops/jpeg_device.py)
against the JAX package's ops/jpeg_device.py, bit for bit: stream
unpacking, both DC chains, the gather formulation of the sparse
reconstruction, every chroma layout, the colour transform and the whole
dequant + IDCT + upsample + colour tail on the committed fixtures.

Inputs are made with numpy (seeded) or decoded from testdata/*.jpg by the
native decoder, and handed to both packages as numpy arrays."""

import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fastdet_tpu.ops import jpeg_device as jax_jd
from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.ops import jpeg_device as jd
from fastdet_tpu_torch.runtime import engine as eng_mod
from fastdet_tpu_torch.runtime import native_jpeg

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_stream_unpacking_bitexact():
    rng = np.random.RandomState(0)
    b = rng.randint(0, 256, (3, 96)).astype(np.uint8)
    for port_fn, jax_fn in ((jd.unpack_3bit, jax_jd.unpack_3bit),
                            (jd.unpack_nibbles, jax_jd.unpack_nibbles),
                            (jd.unpack_nibbles_u, jax_jd.unpack_nibbles_u)):
        np.testing.assert_array_equal(port_fn(_t(b)).numpy(),
                                      np.asarray(jax_fn(jnp.asarray(b))))


def _row_fields(name, tier):
    budgets = eng_mod.sparse_budgets()
    caps = eng_mod.sparse_caps(416, (2, 2), budgets["fmt"][tier],
                               budgets[tier])
    row = np.zeros((eng_mod.sparse_row_bytes(caps),), np.uint8)
    views = eng_mod.sparse_row_views(row, caps)
    fn = (native_jpeg.decode_sparse6_into if caps.fmt == 6
          else native_jpeg.decode_sparse5_into)
    try:
        fn((TESTDATA / name).read_bytes(), *views[:-1])
    except native_jpeg.SparseCapacityExceeded:
        pass  # a truncated row: the gather formulation clamps every index
    return caps, [np.array(v) for v in views[:-1]]


@pytest.mark.parametrize("name,tier", [
    ("scene1.jpg", "std"), ("adv_night.jpg", "dense"),
    ("adv_noise.jpg", "std"),   # truncated at the std caps
])
def test_sparse_gather_formulation_bitexact(name, tier):
    caps, f = _row_fields(name, tier)
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    if caps.fmt == 6:
        plen, ms, dc4, tri, e8, e16, de8, de16 = f
        got = jd.sparse6_to_coeffs(
            *(_t(a[None]) for a in (plen, ms, dc4)),
            jd.unpack_3bit(_t(tri[None])),
            *(_t(a[None]) for a in (e8, e16, de8, de16)), yb, cb)[0]
        want = jax_jd.sparse6_to_coeffs(
            plen, ms, dc4, jax_jd.unpack_3bit(jnp.asarray(tri)), e8, e16,
            de8, de16, yb, cb)
        got_dc = jd.dc_reconstruct6(_t(dc4[None]), _t(de8[None]),
                                    _t(de16[None]), yb, cb)[0]
        want_dc = jax_jd.dc_reconstruct6(dc4, de8, de16, yb, cb)
    else:
        plen, ms, dc8, nib, e8, e16, dce = f
        got = jd.sparse5_to_coeffs(
            *(_t(a[None]) for a in (plen, ms, dc8)),
            jd.unpack_nibbles(_t(nib[None])),
            *(_t(a[None]) for a in (e8, e16, dce)), yb, cb)[0]
        want = jax_jd.sparse5_to_coeffs(
            plen, ms, dc8, jax_jd.unpack_nibbles(jnp.asarray(nib)), e8,
            e16, dce, yb, cb)
        got_dc = jd.dc_reconstruct(_t(dc8[None]), _t(dce[None]), yb, cb)[0]
        want_dc = jax_jd.dc_reconstruct(dc8, dce, yb, cb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_dc.numpy(), np.asarray(want_dc))
    assert np.abs(np.asarray(want)).max() > 0


def test_dc_chains_with_escapes_bitexact():
    """Both DC chains on random deltas with both escape levels."""
    rng = np.random.RandomState(1)
    yb, cb = 40, 12
    nb = yb + 2 * cb
    dc8 = rng.randint(-127, 128, nb).astype(np.int8)
    dc8[rng.rand(nb) < 0.2] = -128
    dce = rng.randint(-2000, 2000, 64).astype(np.int16)
    np.testing.assert_array_equal(
        jd.dc_reconstruct(_t(dc8[None]), _t(dce[None]), yb, cb)[0].numpy(),
        np.asarray(jax_jd.dc_reconstruct(dc8, dce, yb, cb)))
    dc4 = rng.randint(0, 256, (nb + 1) // 2).astype(np.uint8)
    de8 = rng.randint(-128, 128, 64).astype(np.int8)
    de16 = rng.randint(-2000, 2000, 64).astype(np.int16)
    np.testing.assert_array_equal(
        jd.dc_reconstruct6(_t(dc4[None]), _t(de8[None]), _t(de16[None]),
                           yb, cb)[0].numpy(),
        np.asarray(jax_jd.dc_reconstruct6(dc4, de8, de16, yb, cb)))


@pytest.mark.parametrize("layout", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_upsample_chroma_bitexact(layout):
    hs, vs = layout
    rng = np.random.RandomState(2)
    c = rng.randint(0, 256, (48 // vs, 64 // hs)).astype(np.uint8)
    got = jd.upsample_chroma(_t(c[None]), hs, vs)[0].numpy()
    want = np.asarray(jax_jd.upsample_chroma(
        jnp.asarray(c, jnp.float32), hs, vs))
    assert got.shape == (48, 64)
    np.testing.assert_array_equal(got, want)


def test_ycbcr_to_rgb01_bitexact():
    rng = np.random.RandomState(3)
    y, cb, cr = (rng.randint(0, 256, (1, 40, 56)).astype(np.float32)
                 for _ in range(3))
    got = jd.ycbcr_to_rgb01(_t(y), _t(cb), _t(cr))[0].numpy()
    want = np.asarray(jax_jd.ycbcr_to_rgb01(
        jnp.asarray(y[0]), jnp.asarray(cb[0]), jnp.asarray(cr[0])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_coeffs_to_rgb01_bitexact_on_fixtures(name):
    ci = native_jpeg.decode_coefficients((TESTDATA / name).read_bytes())
    assert ci.is_420
    coeff = np.concatenate([ci.ycoef, ci.cbcoef, ci.crcoef]).astype(np.int32)
    q = [ci.qy, ci.qc, ci.qc]
    got = jd.coeffs_to_rgb01(_t(coeff[None]), *(_t(a[None]) for a in q),
                             416, 416, 2, 2)[0].numpy()
    want = np.asarray(jax_jd.coeffs_to_rgb01(
        jnp.asarray(coeff), *(jnp.asarray(a) for a in q), 416, 416, 2, 2))
    np.testing.assert_array_equal(got, want)


def test_idct_runs_in_true_f32():
    """strict_fp32 turns TF32 off for cuDNN and cuBLAS (the card's
    analogue of the TPU default-precision matmul that truncated f32
    integers past 256)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    device_mod.strict_fp32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    # dequantized coefficients reach thousands; the basis is irrational
    rng = np.random.RandomState(4)
    c = rng.randint(-900, 900, (1, 256, 64)).astype(np.int32)
    q = rng.randint(1, 40, (1, 64)).astype(np.float32)
    got = jd.blocks_to_pixels(_t(c), _t(q))[0].numpy()
    want = np.asarray(jax.jit(jax_jd.blocks_to_pixels)(c[0], q[0]))
    np.testing.assert_array_equal(got, want)
