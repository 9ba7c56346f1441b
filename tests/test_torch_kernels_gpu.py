"""Kernels B1 and B2 on the card against their plain PyTorch versions.

Marked ``gpu``: they skip without a CUDA card. This file imports no JAX
(the card machine has none), so on the card it runs on its own:

    python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

import pathlib

import numpy as np
import pytest
import torch

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
