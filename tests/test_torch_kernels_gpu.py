"""Kernels B1, B2, D1 and D2 on the card against their plain PyTorch
versions (D2 on every sub-tile size it takes), and the int8
convolution's card route (torch._int_mm) against its plain 4-bit split
route.

Marked ``gpu``: they skip without a CUDA card. This file imports no JAX
(the card machine has none), so on the card it runs on its own:

    python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from fastdet_tpu_torch.models import quantize
from fastdet_tpu_torch.ops import ingest_stages as st
from fastdet_tpu_torch.ops import jpeg_device as jd
from fastdet_tpu_torch.ops import plane_ingest as pi
from fastdet_tpu_torch.ops import sparse_ingest as si
from fastdet_tpu_torch.runtime import engine as eng_mod
from fastdet_tpu_torch.runtime import native_jpeg

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(tier):
    """The fixtures' packed rows at the engine's ``tier`` caps (truncated
    where a fixture overflows them) plus a zeroed row."""
    budgets = eng_mod.sparse_budgets()
    caps = eng_mod.sparse_caps(416, (2, 2), budgets["fmt"][tier],
                               budgets[tier])
    rows = []
    for n in FIXTURES:
        row = np.zeros((eng_mod.sparse_row_bytes(caps),), np.uint8)
        views = eng_mod.sparse_row_views(row, caps)
        fn = (native_jpeg.decode_sparse6_into if caps.fmt == 6
              else native_jpeg.decode_sparse5_into)
        try:
            fn((TESTDATA / n).read_bytes(), *views[:-1])
        except native_jpeg.SparseCapacityExceeded:
            pass
        rows.append(row)
    rows.append(np.zeros_like(rows[0]))
    views = [eng_mod.sparse_row_views(r, caps)[:-1] for r in rows]
    return caps, [np.stack([v[k] for v in views])
                  for k in range(len(views[0]))]


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["std", "dense"])
def test_b1_kernel_matches_plain_version(tier):
    dev = _card()
    caps, fields = _rows(tier)
    f = [torch.from_numpy(a).to(dev) for a in fields]
    if caps.fmt == 6:
        vals, sentinel = jd.unpack_3bit(f[3]), -4
    else:
        vals, sentinel = jd.unpack_nibbles(f[3]), -8
    offs = si.stream_offsets(f[0], f[1], vals, f[4], caps.nb, sentinel)
    args = (offs, f[1].contiguous(), vals.contiguous(), f[4].contiguous(),
            f[5].contiguous(), sentinel)
    launches = si.LAUNCHES
    got = si.reconstruct(*args)
    assert si.LAUNCHES == launches + 1
    torch.testing.assert_close(got, si.reconstruct_plain(*args),
                               rtol=0, atol=0)


def _fixture_b1(dev, tier, nframes):
    """Kernel B1's inputs and DC column for ``nframes`` of the fixtures'
    rows (cycled) at ``tier``'s caps."""
    caps, fields = _rows(tier)
    idx = [i % fields[0].shape[0] for i in range(nframes)]
    f = [torch.from_numpy(a[idx]).to(dev) for a in fields]
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    if caps.fmt == 6:
        vals, sentinel = jd.unpack_3bit(f[3]), -4
        dc = jd.dc_reconstruct6(f[2], f[6], f[7], yb, cb)
    else:
        vals, sentinel = jd.unpack_nibbles(f[3]), -8
        dc = jd.dc_reconstruct(f[2], f[6], yb, cb)
    offs = si.stream_offsets(f[0], f[1], vals, f[4], caps.nb, sentinel)
    return (offs, f[1].contiguous(), vals.contiguous(), f[4].contiguous(),
            f[5].contiguous(), sentinel), dc


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["std", "dense"])
@pytest.mark.parametrize("nframes", [1, 16])
def test_b1_kernel_with_dc_matches_plain_version(tier, nframes):
    dev = _card()
    args, dc = _fixture_b1(dev, tier, nframes)
    launches = si.LAUNCHES
    got = si.reconstruct(*args, dc=dc)
    assert si.LAUNCHES == launches + 1
    want = si.reconstruct_plain(*args)
    torch.testing.assert_close(got, si._with_dc(want, dc), rtol=0, atol=0)
    torch.testing.assert_close(got, si.reconstruct_plain(*args, dc=dc),
                               rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _synthetic_rows(nframes, nb, ncapb, **kw):
    return st.build_case(np.random.RandomState(3), nframes, nb, MCAP=8 * nb,
                         NCAPB=ncapb, E8CAP=64 * nb, E16CAP=32 * nb, **kw)


def _synthetic_b1(dev, nframes, nb, ncapb=None, **kw):
    """Kernel B1's inputs for synthetic v5 rows (st.build_case)."""
    rows = _synthetic_rows(nframes, nb, ncapb or 32 * nb, **kw)
    plen, ms, dc8, nib, esc8, esc16, dcesc = (torch.from_numpy(a).to(dev)
                                              for a in rows)
    vals = jd.unpack_nibbles(nib).contiguous()
    offs = si.stream_offsets(plen, ms, vals, esc8, nb, -8)
    return (offs, ms, vals, esc8, esc16, -8), dc8.to(torch.int32)


def _frames_for_tile(dev, nb, bt):
    """The smallest batch at which the wrapper picks tile ``bt`` for
    frames of ``nb`` blocks on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return next(b for b in range(1, 4 * sms + 1)
                if si.tile(b, nb, sms) == bt)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,bt", [(37, 8), (37, 16), (37, 32), (37, 64),
                                   (4056, 16), (4056, 32), (4056, 64)])
def test_b1_ragged_tiles_match_plain_version(nb, bt):
    """NB not a multiple of the tile: the last tile of every frame is
    ragged, with escapes of both levels in the rows. The batch is the
    one that makes the wrapper pick ``bt``."""
    dev = _card()
    assert nb % bt
    args, dc = _synthetic_b1(dev, _frames_for_tile(dev, nb, bt), nb,
                             esc1_p=0.25, esc2_p=0.05)
    for d in (None, dc):
        got = si.reconstruct(*args, dc=d)
        torch.testing.assert_close(got, si.reconstruct_plain(*args, dc=d),
                                   rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,bt", [(37, 8), (4056, 16), (4056, 32),
                                   (4056, 64)])
def test_b1_global_route_on_dense_rows(nb, bt):
    """Dense-tier-like rows (40-63 values per block): every tile's value
    span overruns the bt*32 entries staged in shared memory, so values
    past the staged segment come from global memory."""
    dev = _card()
    args, dc = _synthetic_b1(dev, _frames_for_tile(dev, nb, bt), nb,
                             esc1_p=0.2, esc2_p=0.05, min_nnz=40, max_nnz=63,
                             ncapb=40 * nb)
    voff = args[0][:, 1].long()
    span = voff[:, bt::bt] - voff[:, 0:nb - bt + 1:bt]
    assert (span > bt * 32).all()
    got = si.reconstruct(*args, dc=dc)
    torch.testing.assert_close(got, si.reconstruct_plain(*args, dc=dc),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_b1_rejects_bad_dc_on_card():
    dev = _card()
    args, dc = _fixture_b1(dev, "std", 1)
    with pytest.raises(ValueError, match="dc"):
        si.reconstruct(*args, dc=dc.to(torch.int64))
    with pytest.raises(ValueError, match="dc"):
        si.reconstruct(*args, dc=dc.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(32, 34), (6, 2), (18, 530), (416, 416)])
def test_b2_kernel_any_even_width(h, w):
    """Widths that end a row in a 2-pixel group, one wider than the
    kernel's 512-column chunk, and the served size."""
    dev = _card()
    rng = np.random.RandomState(h + w)
    y = torch.from_numpy(rng.randint(0, 256, (3, h, w)).astype(
        np.uint8)).to(dev)
    cb, cr = (torch.from_numpy(rng.randint(
        0, 256, (3, h // 2, w // 2)).astype(np.uint8)).to(dev)
        for _ in range(2))
    torch.testing.assert_close(pi.plane_ingest_batch(y, cb, cr),
                               pi.plane_ingest_plain(y, cb, cr),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_b2_kernel_on_packed_rows_at_odd_frames():
    """The planes tier's rows are 259,588 bytes, so frame b's planes start
    at 4*b mod 16: views at odd batch indices (misaligned starts)."""
    dev = _card()
    b, size = 6, 416
    yb, cw = size * size, (size // 2) ** 2
    rng = np.random.RandomState(11)
    packed = torch.from_numpy(rng.randint(
        0, 256, (b, yb + 2 * cw + 4)).astype(np.uint8)).to(dev)
    assert packed.shape[1] == 259588
    views = (packed[:, :yb].view(b, size, size),
             packed[:, yb:yb + cw].view(b, size // 2, size // 2),
             packed[:, yb + cw:yb + 2 * cw].view(b, size // 2, size // 2))
    for sel in (slice(1, 2), slice(3, 4), slice(1, 6, 2), slice(0, 6)):
        v = [t[sel] for t in views]
        torch.testing.assert_close(
            pi.plane_ingest_batch(*v),
            pi.plane_ingest_plain(*(t.contiguous() for t in v)),
            rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [32, 416])
def test_b2_kernel_matches_plain_version(size):
    dev = _card()
    rng = np.random.RandomState(size)
    y = torch.from_numpy(rng.randint(0, 256, (4, size, size)).astype(
        np.uint8)).to(dev)
    cb, cr = (torch.from_numpy(rng.randint(
        0, 256, (4, size // 2, size // 2)).astype(np.uint8)).to(dev)
        for _ in range(2))
    launches = pi.LAUNCHES
    got = pi.plane_ingest_batch(y, cb, cr)
    assert pi.LAUNCHES == launches + 1
    torch.testing.assert_close(got, pi.plane_ingest_plain(y, cb, cr),
                               rtol=0, atol=0)


def _stage_case(label, dev, B=2, NB=64):
    from fastdet_tpu_torch.tools import debug_ingest

    rows = st.build_case(np.random.RandomState(13), B, NB,
                         **debug_ingest.CASES[label])
    plen, ms, _, nib = (torch.from_numpy(a).to(dev) for a in rows[:4])
    return st.prepare_streams(plen, ms, nib, NB)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["tool", "escapes", "dense span"])
def test_d1_d2_kernels_match_plain_versions(label):
    dev = _card()
    s = _stage_case(label, dev)
    args = (s.ms32, s.vals32, s.moffx, s.probe)
    launches = dict(st.LAUNCHES)
    got = st.stages(*args, s.bt)
    nat2 = st.nat_gated(*args, s.eoff1, s.bt)
    assert st.LAUNCHES == {"D1": launches["D1"] + 1,
                           "D2": launches["D2"] + 1}
    for g, w in zip(got, st.stages_plain(*args, s.bt)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(
        nat2, st.nat_gated_plain(*args, s.eoff1, s.bt), rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _mixed_rows(nframes, nb):
    from fastdet_tpu_torch.tools import debug_ingest

    return debug_ingest.mixed_rows(np.random.RandomState(7), nframes, nb)


def _mixed_d2(dev, nframes, nb):
    """D2's inputs for the mixed rows (debug_ingest.mixed_rows) on ``dev``
    and the sub-tile the wrapper picks for them."""
    plen, ms, nib = (torch.from_numpy(a).to(dev)
                     for a in _mixed_rows(nframes, nb))
    s = st.prepare_streams(plen, ms, nib, nb)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return ((s.ms32, s.vals32, s.moffx, s.probe, s.eoff1, s.bt),
            st.sub_tile(nframes, nb, s.bt, sms))


def _check_d2(args):
    launches = st.LAUNCHES["D2"]
    got = st.nat_gated(*args)
    assert st.LAUNCHES["D2"] == launches + 1
    torch.testing.assert_close(got, st.nat_gated_plain(*args),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_d2_kernel_on_mixed_batch():
    """Tool tiles of both routes, with and without escapes, in each frame
    of one batch (NB = 512, bt = 128: sub-tiles of 8 on 132 SMs)."""
    args, _ = _mixed_d2(_card(), 2, 512)
    _check_d2(args)


@pytest.mark.gpu
@pytest.mark.parametrize("sub", [16, 32, 64])
def test_d2_sub_tiles_match_plain_version(sub):
    """At NB = 4096 (bt = 128), each sub-tile the wrapper picks there, on
    the mixed rows at the smallest batch that makes it pick ``sub``."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nframes = next(b for b in range(1, 4 * sms + 1)
                   if st.sub_tile(b, 4096, 128, sms) == sub)
    args, picked = _mixed_d2(dev, nframes, 4096)
    assert picked == sub
    _check_d2(args)


@pytest.mark.gpu
@pytest.mark.parametrize("c,o,k,stride,pad", [
    (3, 24, 3, 1, None), (64, 128, 3, 2, None), (128, 64, 1, 1, None),
    (128, 64, 2, 1, ((1, 0), (1, 0))), (1024, 512, 3, 1, None)])
def test_int_mm_route_matches_split_route(c, o, k, stride, pad):
    dev = _card()
    rng = np.random.RandomState(c + o)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, c, 13, 13)).astype(
        np.int8)).to(dev).contiguous(memory_format=torch.channels_last)
    w_q = torch.from_numpy(rng.randint(-127, 128, (k, k, c, o)).astype(
        np.int8)).to(dev)
    got = quantize.conv_int8_mm(xq, quantize.mm_weight(w_q), k, stride, pad,
                                o)
    want = quantize.conv_int8_split(xq, w_q, stride, pad)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_coeff_route_equals_sparse_route_on_card(mode):
    """The coefficient route (host coefficients, device decode420_batch)
    and the sparse route (B1 on the packed rows) reach the same
    coefficients, so their records are equal, batched and one at a
    time."""
    from fastdet_tpu_torch.models import weights

    dev = _card()
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = eng_mod.DetectionEngine(spec, params, mode=mode, buckets=(1, 4),
                                  device=dev)
    try:
        datas = [(TESTDATA / f"scene{i}.jpg").read_bytes() for i in (1, 2, 3)]
        for batch in [datas] + [[d] for d in datas]:
            thr = [0.3] * len(batch)
            eng._tier_hint.clear()
            launches = si.LAUNCHES
            sparse = eng.detect_async_sparse(batch, thr)
            want = eng.fetch_wire(sparse, len(batch))
            assert sparse.counts == {"sparse": len(batch)}
            assert si.LAUNCHES > launches
            got = eng.fetch_wire(eng.detect_async_jpeg(batch, thr),
                                 len(batch))
            assert got == want
    finally:
        eng.close()


@pytest.mark.gpu
def test_verify_kernel_tool_exits_zero_on_card():
    """The card counterpart of tests/test_kernel_hw.py: the standalone
    parity tool (B1 on the esc16-extreme case and a q95 scene against the
    plain reconstruction) exits 0 in a process of its own."""
    import subprocess
    import sys

    _card()
    repo = TESTDATA.parent
    proc = subprocess.run(
        [sys.executable, "-m", "fastdet_tpu_torch.tools.verify_kernel"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "OK: randomized case bit-exact" in out
    assert "OK: scene case bit-exact" in out
