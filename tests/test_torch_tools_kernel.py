"""The port's kernel tools (fastdet_tpu_torch/tools/verify_kernel.py,
bisect_kernel.py, measure_sparse_stats.py) against the JAX package's
tools/verify_kernel_tpu.py, bisect_kernel_tpu.py, measure_sparse_stats.py
and the JAX test helpers they use, on the CPU.

- ``build_case`` equals the JAX tool's on the same seeds, for all five
  case classes; ``random_v5_case`` equals tests/test_sparse_path.py's
  ``_random_v5_case``; ``scene`` and ``SparseFrame`` give the JAX
  helpers' bytes and streams.
- On the esc16-extreme case and the q95 scene, the port's
  ``jpeg_device.sparse5_to_coeffs`` and ``verify_kernel``'s plain path
  (the wrapper of kernel B1 on CPU tensors) both equal the JAX
  ``jpeg_device.sparse5_to_coeffs``, exactly.
- ``verify_kernel.main`` on ``device="cpu"`` returns 0 and prints the JAX
  tool's lines; asked for the card without one it returns 2.
  ``bisect_kernel.main`` on the CPU prints OK on all five classes.
- ``measure_sparse_stats`` prints, after its card line, the JAX tool's
  output byte for byte; its statistics equal the JAX tool's on every
  testdata/*.jpg.
- bisect_kernel and measure_sparse_stats raise without a card; the
  repository's BENCH_*.json and bench_baseline.json are byte-unchanged.
"""

import contextlib
import hashlib
import importlib.util
import io
import os
import pathlib
import types

import numpy as np
import pytest
import torch

from fastdet_tpu.ops import jpeg_device as jax_jd
from fastdet_tpu_torch.runtime import native_jpeg
from fastdet_tpu_torch.tools import (bisect_kernel, measure_sparse_stats,
                                     verify_kernel)

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOT_FILES = ("BENCH_DETAIL.json", "BENCH_SATURATION.json",
              "bench_baseline.json")


def _digests():
    return {n: hashlib.sha256((REPO / n).read_bytes()).hexdigest()
            for n in ROOT_FILES}


@pytest.fixture(autouse=True)
def _root_files_untouched():
    before = _digests()
    yield
    assert _digests() == before


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bisect():
    return _load("jax_bisect_kernel_tpu", REPO / "tools" / "bisect_kernel_tpu.py")


@pytest.fixture(scope="module")
def jax_helpers():
    """tests/test_sparse_path.py, the JAX verify tool's helper module."""
    return _load("jax_test_sparse_path", REPO / "tests" / "test_sparse_path.py")


def _jax_coeffs(streams, yb, cb):
    """The JAX sparse5_to_coeffs, frame by frame, as the JAX tool's
    reference runs it."""
    plen, ms, dc8, nib, esc8, esc16, dcesc = streams
    return np.stack([
        np.asarray(jax_jd.sparse5_to_coeffs(
            plen[i], ms[i], dc8[i], jax_jd.unpack_nibbles(nib[i]), esc8[i],
            esc16[i], dcesc[i], yb, cb))
        for i in range(plen.shape[0])])


@pytest.mark.parametrize("name,kw", bisect_kernel.CASES,
                         ids=[c[0] for c in bisect_kernel.CASES])
def test_build_case_equals_jax_tool(jax_bisect, name, kw):
    kw = dict(kw)
    ncapb = kw.pop("NCAPB", 640)
    for seed in (13, 5):
        got = bisect_kernel.build_case(np.random.RandomState(seed), 2, 64,
                                       NCAPB=ncapb, **kw)
        want = jax_bisect.build_case(np.random.RandomState(seed), 2, 64,
                                     NCAPB=ncapb, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed,b,nb", [(7, 2, 64), (3, 1, 128), (11, 3, 32)])
def test_random_v5_case_equals_jax_helper(jax_helpers, seed, b, nb):
    caps = dict(MCAP=8 * nb, NCAPB=10 * nb, E8CAP=8 * nb, E16CAP=4 * nb,
                DCECAP=4 * nb)
    got = verify_kernel.random_v5_case(np.random.RandomState(seed), b, nb,
                                       **caps)
    want = jax_helpers._random_v5_case(np.random.RandomState(seed), b, nb,
                                       **caps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_extreme_case_is_the_jax_tools(jax_helpers):
    """The JAX tool's case: _random_v5_case at seed 7, its int16 escapes
    moved to 31000-31999 in magnitude."""
    rng = np.random.RandomState(7)
    arrs = list(jax_helpers._random_v5_case(
        rng, 2, 64, MCAP=512, NCAPB=640, E8CAP=512, E16CAP=256, DCECAP=256))
    e16 = arrs[5]
    arrs[5] = np.where(e16 != 0, (np.sign(e16) * (np.abs(e16) % 1000 + 31000))
                       .astype(np.int16), e16).astype(np.int16)
    for g, w in zip(verify_kernel.extreme_case(), arrs):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int(np.abs(arrs[5]).max()) >= 31000


def test_extreme_case_plain_paths_equal_jax(native_ready):
    case = verify_kernel.extreme_case()
    want = _jax_coeffs(case, verify_kernel.YB, verify_kernel.CB)
    assert int(np.count_nonzero(np.abs(want) > 256)) > 0
    ref = verify_kernel.reference(case, verify_kernel.YB, verify_kernel.CB)
    plain = verify_kernel.kernel(case, verify_kernel.YB, verify_kernel.CB,
                                 torch.device("cpu"))
    assert np.array_equal(ref, want)
    assert np.array_equal(plain, want)


def test_scene_frame_equals_jax_helpers(jax_helpers, native_ready):
    pytest.importorskip("PIL")
    data = verify_kernel.scene(0, quality=95)
    assert data == jax_helpers._scene(0, quality=95)
    fr = verify_kernel.SparseFrame(native_jpeg, data)
    jfr = jax_helpers.SparseFrame(native_ready, data)
    for g, w in zip(fr.streams(), (jfr.plen, jfr.maskstream, jfr.dc8,
                                   jfr.nib, jfr.esc8, jfr.esc16, jfr.dcesc)):
        assert np.array_equal(g, w)
    one = [a[None] for a in fr.streams()]
    want = jfr.device_coeffs()
    assert np.array_equal(verify_kernel.reference(one, fr.yb, fr.cb)[0], want)
    assert np.array_equal(
        verify_kernel.kernel(one, fr.yb, fr.cb, torch.device("cpu"))[0], want)


def test_verify_kernel_on_cpu_returns_0(capsys):
    assert verify_kernel.main(["verify_kernel"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert lines[1] == ("OK: randomized case bit-exact on cpu (8192 coeffs, "
                        "209 with |v| > 256)")
    assert lines[2] == "OK: scene case bit-exact (4056 blocks)"


def test_verify_kernel_without_card_returns_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert verify_kernel.main(["verify_kernel"]) == 2
    assert capsys.readouterr().out.startswith("SKIP: no CUDA card")


def test_bisect_kernel_on_cpu_all_classes_ok(capsys):
    assert bisect_kernel.main(["bisect_kernel"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["cpu", "devices: ['cpu']"]
    assert lines[2:] == [f"{name}: OK" for name, _ in bisect_kernel.CASES]


@pytest.mark.parametrize("tool", [bisect_kernel, measure_sparse_stats],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_raise_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([tool.__name__])


@pytest.fixture(scope="module")
def jax_stats():
    return _load("jax_measure_sparse_stats",
                 REPO / "tools" / "measure_sparse_stats.py")


def test_measure_sparse_stats_output_equals_jax_tool(jax_stats, native_ready,
                                                     monkeypatch, capsys):
    """Both tools on the bench frames (the JAX tool's fixed reference
    photo directory hidden from it, FASTDET_REFERENCE_TESTDATA unset)."""
    monkeypatch.delenv("FASTDET_REFERENCE_TESTDATA", raising=False)
    assert measure_sparse_stats.main(["measure_sparse_stats"],
                                     device="cpu") == 0
    got = capsys.readouterr().out
    card, rest = got.split("\n", 1)
    assert card == "cpu"

    real = os.path
    hidden = types.SimpleNamespace(
        join=real.join,
        exists=lambda p: ("reference" not in p) and real.exists(p))
    monkeypatch.setattr(jax_stats, "os", types.SimpleNamespace(path=hidden))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_stats.main()
    assert rest == buf.getvalue()
    assert rest.count("== bench") == measure_sparse_stats.BENCH_FRAMES


def test_measure_sparse_stats_reads_reference_photos(monkeypatch, tmp_path,
                                                     capsys):
    """FASTDET_REFERENCE_TESTDATA adds its photos after the bench rows."""
    (tmp_path / "rsu2.jpg").write_bytes(
        (REPO / "testdata" / "adv_night.jpg").read_bytes())
    monkeypatch.setenv("FASTDET_REFERENCE_TESTDATA", str(tmp_path))
    names = [n for n, _ in measure_sparse_stats.frames()]
    assert names == [f"bench{i}" for i in range(6)] + ["rsu2.jpg"]


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        (REPO / "testdata").glob("*.jpg")))
def test_frame_stats_equal_jax_tool(jax_stats, native_ready, name):
    data = (REPO / "testdata" / name).read_bytes()
    try:
        want = jax_stats.frame_stats(data)
    except Exception as e:   # the JAX tool skips such a frame too
        with pytest.raises(type(e)):
            measure_sparse_stats.frame_stats(data)
        return
    got = measure_sparse_stats.frame_stats(data)
    assert got == want
    assert measure_sparse_stats.fmt_bytes(got) == jax_stats.fmt_bytes(want)
