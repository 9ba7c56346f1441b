"""Kernel B1 (fastdet_tpu_torch/ops/sparse_ingest.py) against the JAX
package's batched sparse ingest, fastdet_tpu/ops/pallas/sparse_ingest.py,
run as its own CPU tests run it (interpret=True): bit-exact on the case
classes of tools/bisect_kernel_tpu.py, on real 416x416 fixture rows of
both wire formats, on a zeroed row and on truncated overflow rows.

On the CPU the port's wrapper takes its plain version; the CUDA kernel
itself is held against that plain version by tests/test_torch_kernels_gpu.py
and chip_smoke.py on the card."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fastdet_tpu.ops import jpeg_device as jax_jd
from fastdet_tpu.ops.pallas import sparse_ingest as jax_si
from fastdet_tpu_torch.ops import jpeg_device as jd
from fastdet_tpu_torch.ops import sparse_ingest as si
from fastdet_tpu_torch.runtime import engine as eng_mod
from fastdet_tpu_torch.runtime import native_jpeg

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDATA = REPO / "testdata"


def _bisect_tool():
    spec = importlib.util.spec_from_file_location(
        "bisect_kernel_tpu", REPO / "tools" / "bisect_kernel_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the five case classes of tools/bisect_kernel_tpu.py
CASES = {
    "no-esc small-nnz": dict(esc1_p=0.0, esc2_p=0.0, max_nnz=8),
    "no-esc": dict(esc1_p=0.0, esc2_p=0.0),
    "esc8-only": dict(esc1_p=0.25, esc2_p=0.0),
    "esc16-32k": dict(esc1_p=0.25, esc2_p=0.08),
    "dense-nnz": dict(esc1_p=0.25, esc2_p=0.08, max_nnz=40, NCAPB=2048),
}


@pytest.mark.parametrize("name", list(CASES))
def test_v5_case_classes_match_pallas_interpret(name):
    kw = dict(CASES[name])
    ncapb = kw.pop("NCAPB", 640)
    rng = np.random.RandomState(13)
    b, nb, yb, cb = 2, 64, 32, 16
    plen, ms, dc8, nib, esc8, esc16, dcesc = _bisect_tool().build_case(
        rng, b, nb, NCAPB=ncapb, **kw)
    if name == "esc16-32k":
        # push the int16 escapes out to the int16 extremes
        n16 = int((esc8 == -128).sum(axis=1).max())
        esc16[:, :n16] = np.where(np.arange(n16) % 2, 32767, -32767)
    want = np.asarray(jax_si.sparse5_to_coeffs_batch(
        *(jnp.asarray(a) for a in (plen, ms, dc8, nib, esc8, esc16, dcesc)),
        yb, cb, interpret=True))
    got = si.sparse5_to_coeffs_batch(
        *(torch.from_numpy(a) for a in (plen, ms, dc8, nib, esc8, esc16,
                                        dcesc)), yb, cb).numpy()
    np.testing.assert_array_equal(got, want)
    if name != "no-esc small-nnz":
        assert np.abs(want).max() > 7  # the case does reach the escapes


def _rows(names, tier):
    """Packed 416x416 4:2:0 rows of the engine's ``tier`` caps, one per
    fixture (a truncated row when the fixture overflows), and fit flags."""
    budgets = eng_mod.sparse_budgets()
    caps = eng_mod.sparse_caps(416, (2, 2), budgets["fmt"][tier],
                               budgets[tier])
    rows, fits = [], []
    for n in names:
        row = np.zeros((eng_mod.sparse_row_bytes(caps),), np.uint8)
        views = eng_mod.sparse_row_views(row, caps)
        fn = (native_jpeg.decode_sparse6_into if caps.fmt == 6
              else native_jpeg.decode_sparse5_into)
        try:
            fn((TESTDATA / n).read_bytes(), *views[:-1])
            fits.append(True)
        except native_jpeg.SparseCapacityExceeded:
            fits.append(False)
        rows.append(row)
    return caps, rows, fits


def _fields(caps, rows):
    views = [eng_mod.sparse_row_views(r, caps)[:-1] for r in rows]
    return [np.stack([v[k] for v in views]) for k in range(len(views[0]))]


def _port(caps, f):
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    port_fn = (si.sparse6_to_coeffs_batch if caps.fmt == 6
               else si.sparse5_to_coeffs_batch)
    return port_fn(*(torch.from_numpy(a) for a in f), yb, cb).numpy()


def _pallas(caps, f):
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    jax_fn = (jax_si.sparse6_to_coeffs_batch if caps.fmt == 6
              else jax_si.sparse5_to_coeffs_batch)
    return np.asarray(jax_fn(*(jnp.asarray(a) for a in f), yb, cb,
                             interpret=True))


@functools.lru_cache(maxsize=None)
def _row_set(tier, names, zeroed=False):
    """(caps, fields, fit flags, the Pallas kernel's output) of the
    fixtures ``names`` at ``tier``'s caps, a zeroed row appended when
    ``zeroed``; the interpret-mode run is the slow part, so each set runs
    it once."""
    caps, rows, fits = _rows(list(names), tier)
    if zeroed:
        rows.append(np.zeros_like(rows[0]))
    f = _fields(caps, rows)
    return caps, f, fits, _pallas(caps, f)


ROW_SETS = [
    ("std", ("scene1.jpg",), False),        # a v6 row that fits
    ("dense", ("adv_night.jpg",), False),   # a v5 row that fits
    ("std", ("adv_noise.jpg",), True),      # a truncated row + a zeroed row
]


@pytest.mark.parametrize("tier,names", [
    ("std", ["scene1.jpg"]),         # a v6 row that fits
    ("dense", ["adv_night.jpg"]),    # a v5 row that fits
])
def test_fixture_rows_match_pallas_interpret(tier, names):
    caps, f, fits, want = _row_set(tier, tuple(names))
    assert all(fits)
    np.testing.assert_array_equal(_port(caps, f), want)


def test_zeroed_and_truncated_rows_match_pallas_interpret():
    """The engine zeroes overflow rows before dispatch; the reconstruction
    must still stay in bounds on a zeroed row and on a row the emitter
    truncated at the std caps (every stream read past its capacity
    reads 0, as the TPU kernel's zero pad rows do)."""
    caps, f, fits, want = _row_set("std", ("adv_noise.jpg",), True)
    assert fits == [False]
    got = _port(caps, f)
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()


def _b1_args(caps, f):
    """Kernel B1's inputs (offs, maskstream, vals, esc8, esc16, sentinel)
    and the DC column of fixture-row fields ``f``."""
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    t = [torch.from_numpy(a) for a in f]
    if caps.fmt == 6:
        vals, sentinel = jd.unpack_3bit(t[3]), -4
        dc = jd.dc_reconstruct6(t[2], t[6], t[7], yb, cb)
    else:
        vals, sentinel = jd.unpack_nibbles(t[3]), -8
        dc = jd.dc_reconstruct(t[2], t[6], yb, cb)
    offs = si.stream_offsets(t[0], t[1], vals, t[4], caps.nb, sentinel)
    return (offs, t[1], vals, t[4], t[5], sentinel), dc


@pytest.mark.parametrize("tier,names,zeroed", ROW_SETS)
def test_plain_with_dc_matches_pallas_interpret(tier, names, zeroed):
    """reconstruct_plain(..., dc) is the whole batch entry: it equals the
    JAX package's sparse6/sparse5_to_coeffs_batch (Pallas interpret=True)
    on rows that fit, a truncated row and a zeroed row, and equals the
    DC lane written as a separate pass (_with_dc)."""
    caps, f, _, want = _row_set(tier, names, zeroed)
    args, dc = _b1_args(caps, f)
    got = si.reconstruct_plain(*args, dc=dc)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(
        got, si._with_dc(si.reconstruct_plain(*args), dc), rtol=0, atol=0)
    # without dc, position 0 is 0 on every row the emitter writes
    assert not si.reconstruct(*args)[..., 0].any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "frames"])
def test_wrapper_rejects_bad_dc(bad):
    caps, f, _, _ = _row_set("std", ("scene1.jpg",))
    args, dc = _b1_args(caps, f)
    dc = {"dtype": dc.to(torch.int64), "shape": dc[:, :-1],
          "frames": torch.cat([dc, dc])}[bad]
    with pytest.raises(ValueError, match="dc"):
        si.reconstruct(*args, dc=dc)


@pytest.mark.parametrize("nframes,nb,sms,want", [
    (1, 4056, 132, 16), (2, 4056, 132, 32), (4, 4056, 132, 64),
    (16, 4056, 132, 64), (1, 37, 132, 8), (44, 37, 132, 16),
    (132, 37, 132, 64), (1, 4056, 16, 64)])
def test_tile_is_largest_that_covers_every_sm(nframes, nb, sms, want):
    """The server's buckets at 416x416 4:2:0 (NB = 4056) on an H100's 132
    SMs reach tiles 16, 32 and 64; tiny frames reach 8."""
    bt = si.tile(nframes, nb, sms)
    assert bt == want and bt in si.TILES
    assert want == si.TILES[0] or -(-nb // bt) * nframes >= sms
    larger = [t for t in si.TILES if t > bt]
    assert all(-(-nb // t) * nframes < sms for t in larger)


def test_fixture_rows_match_gather_formulation():
    """On rows the emitter completed, B1 equals the gather formulation
    (jpeg_device.sparse6_to_coeffs, every index clamped into its
    stream) in both packages."""
    caps, rows, fits = _rows(["scene3.jpg"], "std")
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    f = _fields(caps, rows)
    got = si.sparse6_to_coeffs_batch(*(torch.from_numpy(a) for a in f),
                                     yb, cb).numpy()
    port_gather = jd.sparse6_to_coeffs(
        *(torch.from_numpy(a) for a in f[:3]),
        jd.unpack_3bit(torch.from_numpy(f[3])),
        *(torch.from_numpy(a) for a in f[4:]), yb, cb).numpy()
    jax_gather = np.asarray(jax_jd.sparse6_to_coeffs(
        *(jnp.asarray(a[0]) for a in f[:3]),
        jax_jd.unpack_3bit(jnp.asarray(f[3][0])),
        *(jnp.asarray(a[0]) for a in f[4:]), yb, cb))
    np.testing.assert_array_equal(got, port_gather)
    np.testing.assert_array_equal(got[0], jax_gather)


def test_wrapper_rejects_mixed_devices():
    caps, rows, _ = _rows(["scene1.jpg"], "std")
    f = [torch.from_numpy(a) for a in _fields(caps, rows)]
    vals = jd.unpack_3bit(f[3])
    offs = si.stream_offsets(f[0], f[1], vals, f[4], caps.nb, -4)
    with pytest.raises(ValueError):
        si.reconstruct(offs.to("meta"), f[1], vals, f[4], f[5], -4)
