"""Kernels B1, B2, D1 and D2 on the card against their plain PyTorch
versions, and the int8 convolution's card route (torch._int_mm) against
its plain 4-bit split route.

Marked ``gpu``: they skip without a CUDA card. This file imports no JAX
(the card machine has none), so on the card it runs on its own:

    python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

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
