"""Kernels D1 and D2 (fastdet_tpu_torch/ops/ingest_stages.py) against the
JAX package's kernel-debug tool, tools/debug_kernel_tpu.py.

That tool no longer traces against the current sparse_ingest helpers, so
it is not run: its host stream preparation (:37-59) and its numpy
expectation loops (:60-70, :173-222) are copied here and hold the port's
inputs and plain stage versions bit for bit. D1's ``nat`` is also held
against the JAX package's kernel B1 (Pallas, interpret=True) and its XLA
reconstruction on the same rows. On the CPU the wrappers take their
plain versions; the CUDA kernels are held against those on the card by
tests/test_torch_kernels_gpu.py, chip_smoke.py and the debug tool."""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fastdet_tpu.ops import jpeg_device as jax_jd
from fastdet_tpu.ops.pallas import sparse_ingest as jax_si
from fastdet_tpu_torch.ops import ingest_stages as st
from fastdet_tpu_torch.tools import debug_ingest

REPO = pathlib.Path(__file__).resolve().parent.parent
LANES = 128


def _bisect_tool():
    spec = importlib.util.spec_from_file_location(
        "bisect_kernel_tpu", REPO / "tools" / "bisect_kernel_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, NB, build_case keywords): the debug tool's three cases (its own,
# escapes, a value span past bt*32 per tile), near-full blocks, and the
# engine-scale tile (bt = 128)
CASES = {
    **{name: (2, 64, kw) for name, kw in debug_ingest.CASES.items()},
    "max_nnz 63": (2, 64, dict(esc1_p=0.0, esc2_p=0.0, max_nnz=63,
                               NCAPB=2048)),
    "bt128": (1, 256, dict(esc1_p=0.0, esc2_p=0.0, MCAP=2048,
                           NCAPB=2560)),
}
# build_case's min_nnz is the port's addition: the JAX copy lacks it
JAX_CASES = [n for n, (_, _, kw) in CASES.items() if "min_nnz" not in kw]


def _case(name, port=True):
    b, nb, kw = CASES[name]
    rng = np.random.RandomState(13)
    if port:
        return b, nb, st.build_case(rng, b, nb, **kw)
    return b, nb, _bisect_tool().build_case(rng, b, nb, **kw)


def _tool_prep(B, nb, plen, ms, nib):
    """tools/debug_kernel_tpu.py:37-59, verbatim but for names."""
    ln = np.asarray(jax_jd.unpack_nibbles_u(jnp.asarray(plen)))[:, :nb]
    moff = np.cumsum(ln, -1) - ln
    moffx = np.concatenate([moff, moff[:, -1:] + ln[:, -1:]],
                           -1).astype(np.int32)
    vals = np.asarray(jax_jd.unpack_nibbles(jnp.asarray(nib)))
    pc = np.unpackbits(ms, axis=-1).reshape(B, -1, 8).sum(-1)
    s = np.cumsum(pc, -1)
    probe = np.where(moffx > 0,
                     np.take_along_axis(
                         s, np.clip(moffx - 1, 0, s.shape[-1] - 1), -1),
                     0).astype(np.int32)
    off = probe[:, :-1]
    nnz = probe[:, 1:] - probe[:, :-1]
    bt = jax_si._pick_bt(nb)
    ms32 = np.asarray(jax_si._rows128(jnp.asarray(ms.astype(np.int32)),
                                      extra_rows=bt // 16 + 1))
    vals32 = np.asarray(jax_si._rows128(jnp.asarray(vals),
                                        extra_rows=bt // 4 + 1))
    return dict(moffx=moffx, probe=probe, off=off, nnz=nnz, vals=vals,
                ms32=ms32, vals32=vals32, bt=bt)


def _tool_expectations(B, nb, bt, moffx, off, nnz, ms32, vals32):
    """The tool's numpy expectations (:60-70, :173-181, :183-208)."""
    ms_flat = ms32.reshape(B, -1)
    vals_flat = vals32.reshape(B, -1)
    exp_mwin = np.zeros((B, nb, 8), np.int32)
    exp_win = np.zeros((B, nb, 64), np.int32)
    for i in range(B):
        for b in range(nb):
            m0, m1 = moffx[i, b], moffx[i, b + 1]
            exp_mwin[i, b, :m1 - m0] = ms_flat[i, m0:m1]
            v0, n = off[i, b], nnz[i, b]
            exp_win[i, b, :n] = vals_flat[i, v0:v0 + min(n, 64)]
    exp_seg = np.zeros((B, nb * 32 // LANES, LANES), np.int32)
    for i in range(B):
        for t in range(nb // bt):
            s0 = off[i, t * bt]
            chunk = vals_flat[i, s0:s0 + bt * 32]
            exp_seg[i, t * (bt * 32 // LANES):(t + 1) * (bt * 32 // LANES)] \
                = np.pad(chunk, (0, bt * 32 - len(chunk))).reshape(-1, LANES)
    exp_bits = np.zeros((B, nb, 64), np.int64)
    for i in range(B):
        for b in range(nb):
            word = int.from_bytes(
                bytes(exp_mwin[i, b].astype(np.uint8)), "little")
            for p in range(64):
                exp_bits[i, b, p] = (word >> p) & 1
    exp_rank = np.cumsum(exp_bits, axis=-1) - exp_bits
    exp_acc = np.zeros((B, nb, 64), np.int64)
    for i in range(B):
        for b in range(nb):
            for p in range(64):
                if exp_bits[i, b, p]:
                    v = exp_win[i, b, exp_rank[i, b, p]] & 15
                    exp_acc[i, b, p] = v - ((v >> 3) << 4)
    nat2zz = np.zeros(64, np.int64)
    for j in range(64):
        nat2zz[jax_jd.ZIGZAG[j]] = j
    exp_nat = exp_acc[:, :, nat2zz]
    return dict(mwin=exp_mwin, win=exp_win, seg=exp_seg, bits=exp_bits,
                rank=exp_rank, acc=exp_acc, nat=exp_nat)


def _streams(plen, ms, nib, nb):
    return st.prepare_streams(torch.from_numpy(plen), torch.from_numpy(ms),
                              torch.from_numpy(nib), nb)


@pytest.mark.parametrize("name", JAX_CASES)
def test_build_case_equals_jax_tool(name):
    _, _, ours = _case(name)
    _, _, theirs = _case(name, port=False)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_stream_prep_equals_tool(name):
    b, nb, (plen, ms, dc8, nib, *_) = _case(name)
    want = _tool_prep(b, nb, plen, ms, nib)
    got = _streams(plen, ms, nib, nb)
    assert got.bt == want["bt"] == st.pick_bt(nb)
    for key in ("moffx", "probe", "off", "nnz", "vals"):
        g = getattr(got, key).numpy()
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, want[key], err_msg=key)
    for key in ("ms32", "vals32"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      want[key].reshape(b, -1), err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_d1_plain_stages_equal_tool_expectations(name):
    b, nb, (plen, ms, dc8, nib, *_) = _case(name)
    s = _streams(plen, ms, nib, nb)
    launches = dict(st.LAUNCHES)
    got = st.stages(s.ms32, s.vals32, s.moffx, s.probe, s.bt)
    assert st.LAUNCHES == launches   # CPU tensors: the plain version
    want = _tool_expectations(b, nb, s.bt, s.moffx.numpy(), s.off.numpy(),
                              s.nnz.numpy(), s.ms32.numpy(),
                              s.vals32.numpy())
    for key in st.Stages._fields:
        g = getattr(got, key).numpy()
        assert g.dtype == np.int32, key
        np.testing.assert_array_equal(g, want[key].reshape(g.shape),
                                      err_msg=key)
    assert np.abs(want["nat"]).max() > 0


@pytest.mark.parametrize("name", ["tool", "dense span"])
def test_d1_nat_equals_jax_b1_and_xla(name):
    """Escape-free rows: D1's nat is B1's AC output (DC lane 0), both for
    the Pallas kernel (interpret=True) and the XLA gather formulation."""
    b, nb, rows = _case(name)
    plen, ms, dc8, nib, esc8, esc16, dcesc = rows
    yb = nb // 2
    cb = nb // 4
    s = _streams(plen, ms, nib, nb)
    nat = st.stages(s.ms32, s.vals32, s.moffx, s.probe, s.bt).nat.numpy()
    assert (nat[..., 0] == 0).all()
    pallas = np.asarray(jax_si.sparse5_to_coeffs_batch(
        *(jnp.asarray(a) for a in rows), yb, cb, interpret=True))
    np.testing.assert_array_equal(nat[..., 1:], pallas[..., 1:])
    for i in range(b):
        xla = np.asarray(jax_jd.sparse5_to_coeffs(
            jnp.asarray(plen[i]), jnp.asarray(ms[i]), jnp.asarray(dc8[i]),
            jax_jd.unpack_nibbles(jnp.asarray(nib[i])),
            jnp.asarray(esc8[i]), jnp.asarray(esc16[i]),
            jnp.asarray(dcesc[i]), yb, cb))
        np.testing.assert_array_equal(nat[i, :, 1:], xla[:, 1:])


def _d2(name, eoff1=None):
    b, nb, (plen, ms, dc8, nib, *_) = _case(name)
    s = _streams(plen, ms, nib, nb)
    e = s.eoff1 if eoff1 is None else eoff1(s)
    nat = st.stages_plain(s.ms32, s.vals32, s.moffx, s.probe, s.bt).nat
    launches = dict(st.LAUNCHES)
    got = st.nat_gated(s.ms32, s.vals32, s.moffx, s.probe, e, s.bt)
    assert st.LAUNCHES == launches
    return s, nat, got


def test_d2_plain_fast_route():
    s, nat, got = _d2("tool")
    spans = s.probe[:, s.bt::s.bt] - s.probe[:, :-1:s.bt]
    assert (spans <= s.bt * 32).all()       # every tile fits its segment
    assert (s.eoff1 == 0).all()
    torch.testing.assert_close(got, nat, rtol=0, atol=0)


def test_d2_plain_dense_route():
    s, nat, got = _d2("dense span")
    spans = s.probe[:, s.bt::s.bt] - s.probe[:, :-1:s.bt]
    assert (spans > s.bt * 32).any()        # a tile takes the dense route
    torch.testing.assert_close(got, nat, rtol=0, atol=0)


def test_d2_plain_escape_gate():
    s, nat, got = _d2("escapes")
    assert (s.eoff1[:, -1] > 0).all()        # every frame has escapes
    torch.testing.assert_close(got, nat + st.GATE, rtol=0, atol=0)


def test_d2_plain_gate_is_per_tile():
    """Escapes in the second tile of each frame only: the first tile's
    outputs stay ungated."""
    def second_tile_only(s):
        e = torch.zeros_like(s.eoff1)
        e[:, s.bt + 1:] = 1
        return e

    s, nat, got = _d2("bt128", second_tile_only)
    assert s.bt == 128 and nat.shape[1] == 256
    torch.testing.assert_close(got[:, :128], nat[:, :128], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 128:], nat[:, 128:] + st.GATE,
                               rtol=0, atol=0)


def test_d2_plain_mixed_batch():
    """One batch whose tool tiles take both routes, with and without
    escapes, inside each frame (debug_ingest.mixed_rows): D2's plain
    version is the tool's numpy ``nat`` plus GATE on exactly the tiles
    whose level-1 escape offsets grow."""
    b, nb = 2, 512
    plen, ms, nib = debug_ingest.mixed_rows(np.random.RandomState(13), b, nb)
    s = _streams(plen, ms, nib, nb)
    bt = s.bt
    assert bt == 128
    p, e = s.probe.numpy().astype(np.int64), s.eoff1.numpy()
    kinds = set()
    gate = np.zeros((b, nb), np.int64)
    for i in range(b):
        for t in range(nb // bt):
            lo, hi = t * bt, (t + 1) * bt
            escapes = e[i, hi] > e[i, lo]
            kinds.add((p[i, hi] - p[i, lo] <= bt * 32, bool(escapes)))
            gate[i, lo:hi] = st.GATE if escapes else 0
    assert kinds == {(True, False), (True, True), (False, False),
                     (False, True)}
    want = _tool_expectations(b, nb, bt, s.moffx.numpy(), s.off.numpy(),
                              s.nnz.numpy(), s.ms32.numpy(),
                              s.vals32.numpy())["nat"] + gate[..., None]
    launches = dict(st.LAUNCHES)
    got = st.nat_gated(s.ms32, s.vals32, s.moffx, s.probe, s.eoff1, bt)
    assert st.LAUNCHES == launches
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_d2_sub_tile_picker():
    """The sub-tile divides bt, gives every SM a CTA where the batch
    allows (the largest size that does), and takes the values its
    docstring states at NB = 4096, bt = 128 on 132 SMs."""
    for nframes, want in ((1, 16), (2, 32), (3, 64), (8, 64), (16, 64)):
        assert st.sub_tile(nframes, 4096, 128, 132) == want
    assert ("16 at one frame, 32 at two and 64 from three (so 64 at 8 "
            "and at 16)") in " ".join(st.sub_tile.__doc__.split())
    for sms in (1, 16, 132):
        for bt in (8, 16, 48, 64, 128, 256):
            for nb in (bt, 4 * bt, 32 * bt):
                for nframes in (1, 2, 5, 16, 64):
                    sub = st.sub_tile(nframes, nb, bt, sms)
                    fits = [f for f in st.SUB_TILES if bt % f == 0]
                    assert sub in fits and bt % sub == 0
                    covering = [f for f in fits
                                if nb // f * nframes >= sms]
                    assert sub == (max(covering) if covering
                                   else min(fits))
    with pytest.raises(ValueError, match="multiple of 8"):
        st.sub_tile(1, 96, 12, 132)


def test_debug_tool_runs_every_case_on_the_cpu(capsys):
    """The tool's cases and lines, here through the plain versions
    alone (its entry point takes the card)."""
    results = debug_ingest.run(torch.device("cpu"))
    assert [r["case"] for r in results] == list(debug_ingest.CASES)
    assert all(r["ok"] and r["max_abs_err"] == 0 for r in results)
    out = capsys.readouterr().out
    for stage in st.Stages._fields + ("nat2[full]", "nat==B1"):
        assert f"{stage}: OK" in out
    assert "FAIL" not in out
    assert "2 of 2 tiles on D2's dense route" in out
    assert "2 escape-gated" in out


def test_debug_tool_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        debug_ingest.main([])


def test_bt_must_divide_nb():
    b, nb, (plen, ms, dc8, nib, *_) = _case("tool")
    s = _streams(plen, ms, nib, nb)
    with pytest.raises(ValueError, match="divide"):
        st.stages(s.ms32, s.vals32, s.moffx, s.probe, 48)
