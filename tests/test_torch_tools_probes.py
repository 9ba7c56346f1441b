"""The port's probe and A/B tools (fastdet_tpu_torch/tools/bench_sparse.py,
bench_int8.py, probe_hostcpu.py, profile_legs.py, probe_rpc_split.py,
probe_overlap.py, profile_serving.py, ab_serving.py) on the CPU at tiny
sizes (synthetic:tiny through their ARCH constants, shrunk counts),
against the JAX package's tools/ where they compute the same thing.

- bench_sparse's layout line (tier, sparse row bytes, planes and pixel
  bytes) equals the one the JAX engine's ``_sparse_caps`` /
  ``_sparse_row_bytes`` and the JAX tool's ``_sparse_tier`` give for the
  fixture; it times the three routes and the host staging.
- bench_int8's JSON line has the JAX tool's keys (tiny, batch 1).
- The prepack dispatch of probe_hostcpu / profile_legs / probe_rpc_split
  gives the wire bytes detect_async_sparse gives on the same frames;
  each tool runs with its tags.
- probe_overlap prints its legs; profile_serving and ab_serving answer
  every frame (no client error, no stall).
- Each tool raises without a card; the repository's BENCH_*.json and
  bench_baseline.json are byte-unchanged.
"""

import hashlib
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from fastdet_tpu_torch import bench
from fastdet_tpu_torch.tools import (ab_serving, bench_int8, bench_sparse,
                                     probe_hostcpu, probe_overlap,
                                     probe_rpc_split, profile_legs,
                                     profile_serving)

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOT_FILES = ("BENCH_DETAIL.json", "BENCH_SATURATION.json",
              "bench_baseline.json")
TINY = ("tiny", 80)


def _digests():
    return {n: hashlib.sha256((REPO / n).read_bytes()).hexdigest()
            for n in ROOT_FILES}


@pytest.fixture(autouse=True)
def _root_files_untouched():
    before = _digests()
    yield
    assert _digests() == before


@pytest.fixture
def tiny(monkeypatch):
    """Every tool's model shrunk to synthetic:tiny."""
    for mod in (bench_sparse, probe_hostcpu, profile_serving, ab_serving):
        monkeypatch.setattr(mod, "ARCH", TINY)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_sparse_bytes_and_tier_equal_jax_engine(tiny, native_ready,
                                                      capsys):
    from fastdet_tpu.models import weights as jax_weights
    from fastdet_tpu.runtime.engine import DetectionEngine as JaxEngine

    fixture = REPO / "testdata" / "scene1.jpg"
    assert bench_sparse.main(["bench_sparse", "--batch", "2", "--iters", "1",
                              "--fixture", str(fixture)], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"

    data = fixture.read_bytes()
    spec, params = jax_weights.load_model("synthetic:tiny", num_classes=80)
    jeng = JaxEngine(spec, params, mode="bf16", buckets=(2,))
    tier = _jax_tool("bench_sparse")._sparse_tier(jeng, native_ready,
                                                  [data, data])
    w, h, hs, vs = native_ready.scan_layout(data)
    row = jeng._sparse_row_bytes(jeng._sparse_caps((hs, vs), tier or "std"))
    planes = h * w + 2 * (h // vs) * (w // hs)
    assert tier == "std"
    assert out[1] == (f"layout={hs}{vs} tier={tier} sparse_row={row}B "
                      f"planes_row={planes}B pixels_row={h*w*3}B "
                      f"ratio={planes/row:.2f}x")
    for i, label in enumerate(("sparse", "planes", "pixels")):
        assert re.match(rf"{label} +p50= *[0-9.]+ ms/batch", out[2 + i])
    assert [l.split()[:2] for l in out[5:]] == [
        ["host", "sparse"], ["host", "planes"], ["host", "pixels"]]


def test_bench_int8_keys_equal_jax_tool(capsys, monkeypatch):
    from fastdet_tpu.utils import compile_cache

    argv = ["--arch", "tiny", "--batches", "1", "--iters", "1"]
    assert bench_int8.main(["bench_int8"] + argv, device="cpu") == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])

    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    monkeypatch.setattr("sys.argv", ["bench_int8.py"] + argv)
    assert _jax_tool("bench_int8").main() == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])

    assert list(got) == list(want)
    for mode in ("bf16", "int8", "f32"):
        assert list(got[mode]) == list(want[mode]) == [
            "b1_ms_per_img", "b1_compile_s"]
        assert got[mode]["b1_ms_per_img"] > 0
    assert got["arch"] == "tiny" and got["backend"] == "cpu"
    assert got["int8_speedup_b1"] == round(
        got["bf16"]["b1_ms_per_img"] / got["int8"]["b1_ms_per_img"], 3)


@pytest.fixture(scope="module")
def int8_engine():
    probe_arch = probe_hostcpu.ARCH
    probe_hostcpu.ARCH = TINY
    try:
        eng = probe_hostcpu.build_engine(2, "cpu")
    finally:
        probe_hostcpu.ARCH = probe_arch
    yield eng
    eng.close()


def test_prepack_dispatch_wire_equals_detect_async_sparse(int8_engine):
    eng = int8_engine
    jpegs = bench.make_jpegs(2)
    thrs = [0.02, 0.015]   # below the calibrated objectness: records
    want = eng.fetch_wire(eng.detect_async_sparse(jpegs, thrs), 2)
    assert any(want)
    layout, idxs, packed, thr, fn = probe_hostcpu.stage_prepacked(
        eng, jpegs, np.asarray(thrs, np.float32))
    assert layout == (2, 2) and list(idxs) == [0, 1]
    assert np.array_equal(thr, np.asarray(thrs, np.float32))
    res = bench.submit_prepacked(eng, fn, packed, idxs)
    assert eng.fetch_wire(res, 2) == want
    # the on-thread call of profile_legs / probe_rpc_split
    with torch.inference_mode():
        res = eng._run_program(fn, eng._to_device(packed, eng.devices[0]))
    assert eng.fetch_wire(res, 2) == want


def test_probe_hostcpu_runs(tiny, capsys):
    assert probe_hostcpu.main(["probe_hostcpu", "--frames", "4",
                               "--batch", "2"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    assert [l.split()[0] for l in out[1:]] == ["full", "prepack", "packonly"]
    assert all(" f/s (" in l for l in out[1:])


def test_profile_legs_runs(tiny, capsys, monkeypatch):
    monkeypatch.setattr(probe_hostcpu, "ARCH", TINY)
    monkeypatch.setattr(profile_legs, "LINES", 4)
    assert profile_legs.main(["profile_legs", "--batches", "1",
                              "--batch", "2"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "===== packonly x1 (b=2) =====" in out
    assert "===== prepack x1 (b=2) [sync, on-thread] =====" in out
    assert "_pipeline_sparse" in out


def test_probe_rpc_split_runs(tiny, capsys, monkeypatch):
    monkeypatch.setattr(probe_rpc_split, "PIPE_ITERS", 2)
    assert probe_rpc_split.main(["probe_rpc_split", "--sync", "--iters", "1",
                                 "--batch", "2"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "row bytes: 47708 x b2 = 0.10 MB h2d per batch"
    tags = [re.split(r"\s{2,}", l)[0] for l in out[2:]]
    assert tags == ["put packed (blocked)", "put thr (blocked)",
                    "exec resident (blocked)", "fetch result (np.asarray)",
                    "full sync chain", "put tiny (96B)", "put packed (1.2MB)",
                    "exec resident", "put+exec chain"]


def test_probe_overlap_runs(capsys, monkeypatch):
    monkeypatch.setattr(probe_overlap, "N", 64)
    assert probe_overlap.main(["probe_overlap", "--mb", "0.01", "--iters", "3",
                               "--flops-ms", "0.01"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["cpu", "backend=cpu device=cpu"]
    assert [l.split(":")[0] for l in out[2:]] == [
        "compute", "put", "exec", "execp", "fetch", "pipe"]


def test_profile_serving_answers_every_frame(tiny, capsys, monkeypatch):
    monkeypatch.setattr(profile_serving, "BUCKETS", (1, 2))
    monkeypatch.setattr(profile_serving, "PHASE_A_WARM_FRAMES", 2)
    monkeypatch.setattr(profile_serving, "WARM_PER_CLIENT", 1)
    assert profile_serving.main(
        ["profile_serving", "--frames", "8", "--clients", "2", "--window",
         "2", "--profile"], device="cpu") == 0
    out = capsys.readouterr().out
    assert re.search(r"^A engine batched +: +[0-9.]+ f/s +\(bucket=2, "
                     r"inflight=3\)$", out, re.M)
    assert re.search(r"^B service direct +: +[0-9.]+ f/s +\(outstanding=4, "
                     r"avg_batch=[0-9.]+\)$", out, re.M)
    assert re.search(r"^C sockets +: +[0-9.]+ f/s +\(clients=2, window=2, "
                     r"avg_batch=[0-9.]+, errors=\[\]\)$", out, re.M)
    assert "event-loop thread profile (top 25 by cumulative)" in out


def test_ab_serving_answers_every_frame(tiny, capsys, monkeypatch):
    monkeypatch.setattr(ab_serving, "VARIANTS", (
        ("b2/w2", (1, 2), 2), ("b2/w1", (1, 2), 1)))
    monkeypatch.setattr(ab_serving, "WARM_PER_CLIENT", 1)
    assert ab_serving.main(["ab_serving", "--passes", "1", "--clients", "2",
                            "--per-client", "2"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"pass 0 b2/w2: [0-9.]+ f/s avg_batch [0-9.]+ "
                    r"errors=\[\]$", out[1])
    assert re.match(r"pass 0 b2/w1: [0-9.]+ f/s avg_batch [0-9.]+ "
                    r"errors=\[\]$", out[2])
    assert out[4] == "summary (median over passes):"
    assert [l.split(":")[0].strip() for l in out[5:]] == ["b2/w2", "b2/w1"]


@pytest.mark.parametrize("tool", [
    bench_sparse, bench_int8, probe_hostcpu, profile_legs, probe_rpc_split,
    probe_overlap, profile_serving, ab_serving],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_raise_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([tool.__name__])
