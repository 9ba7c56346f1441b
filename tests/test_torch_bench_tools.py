"""The port's measurement tools (fastdet_tpu_torch/tools/client_load.py,
profile_device.py, eval_map.py) against the JAX package's tools/ on the
CPU.

- client_load, run as a process of its own against the port's server on
  the CPU (synthetic:tiny, f32), answers every frame; the JAX
  tools/client_load.py against the same server prints the same keys and
  answers every frame too.
- profile_device._bucket on kernel names the card's profiler reports
  (the port's CUDA kernels, cuDNN / CUTLASS / cuBLAS convolutions and
  GEMMs, torch._int_mm's, sort / top-k / radix, copies, elementwise);
  _union_us on overlapping intervals; profile_engine on a CPU engine
  returns the JAX tool's keys (no device event on the CPU: 0 ms).
- eval_map in f32 on weights/detect3_tiny.npz over 8 held-out scenes:
  mAP@0.5, mAP@[.5:.95] and each class's AP within 1e-4 of the JAX
  tool's.
- saturation, eval_map and profile_device raise without a card.
- The repository's BENCH_*.json and bench_baseline.json byte-unchanged.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from fastdet_tpu_torch import bench
from fastdet_tpu_torch.tools import client_load, eval_map, profile_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_FILES = ("BENCH_DETAIL.json", "BENCH_SATURATION.json",
              "bench_baseline.json")


def _digests():
    out = {}
    for name in ROOT_FILES:
        with open(os.path.join(REPO, name), "rb") as fp:
            out[name] = hashlib.sha256(fp.read()).hexdigest()
    return out


@pytest.fixture(autouse=True)
def _root_files_untouched():
    before = _digests()
    yield
    assert _digests() == before


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_client_load_answers_every_frame(native_ready):
    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import ModelService

    spec, params = weights.load_model("synthetic:tiny")
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1, 2, 4),
                          device="cpu")
    svc = ModelService(eng, name="full")
    try:
        with bench.serving({"full": svc}) as server:
            out = client_load.run_in_subprocess(
                server.bound_port, path="full", clients=3, per_client=4,
                window=2, threshold=0.1, timeout=300)
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools", "client_load.py"),
                 "--port", str(server.bound_port), "--path", "full",
                 "--clients", "2", "--per-client", "3", "--window", "2"],
                capture_output=True, text=True, timeout=300, env=env)
    finally:
        eng.close()
    assert out["errors"] == [] and out["frames"] == 12
    assert out["frames_requested"] == 12 and out["fps"] > 0
    assert out["p50_ms"] <= out["p99_ms"]
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(jax_out) == set(out)
    assert jax_out["frames"] == 6 and jax_out["errors"] == []
    assert svc.frames == 12 + 6


def test_client_load_reports_a_refused_server():
    import socket

    with socket.socket() as s:   # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = client_load.run_in_subprocess(port, path="full", clients=2,
                                        per_client=2, window=1,
                                        threshold=0.1, timeout=120)
    assert out["frames"] == 0 and len(out["errors"]) == 2
    assert out["fps"] == 0.0


@pytest.mark.parametrize("name,cat,want", [
    ("sparse_tile_kernel(int const*, unsigned char const*, int)", "kernel",
     "ingest-kernel"),
    ("plane_ingest_kernel(unsigned char const*, unsigned char const*)",
     "kernel", "ingest-kernel"),
    ("ingest_stages_kernel(int const*, int const*)", "kernel",
     "ingest-kernel"),
    ("nat_gated_kernel(int const*, int const*)", "kernel", "ingest-kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel"
     "__5x_cudnn", "kernel", "conv/matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3"
     "_tn_align16>(cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_"
     "align16::Params)", "kernel", "conv/matmul"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_32x5_nn", "kernel",
     "conv/matmul"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, "
     "false, false, true>(int, int, int, float const*)", "kernel",
     "conv/matmul"),
    ("void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long>",
     "kernel", "postprocess"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>",
     "kernel", "postprocess"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_"
     "detail::cub::DeviceRadixSortPolicy<float, long, int>::Policy900>",
     "kernel", "postprocess"),
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", "layout/copy"),
    ("Memset (Device)", "gpu_memset", "layout/copy"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, "
     "float, false, true, (cudnnKernelDataType_t)0>", "kernel",
     "layout/copy"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "(anonymous namespace)::leaky_relu_kernel(at::TensorIteratorBase&, "
     "c10::Scalar const&)::{lambda()#1}>", "kernel", "other"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::"
     "native::(anonymous namespace)::OpaqueType<1u>, unsigned int, 4, 64, "
     "64>", "kernel", "other"),
    ("void at::native::tensor_kernel_scan_innermost_dim<long, std::plus<long>"
     " >(long*, long const*)", "kernel", "other"),
])
def test_bucket_of_card_kernel_names(name, cat, want):
    assert profile_device._bucket(name, cat) == want


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
])
def test_union_of_device_intervals(spans, want):
    assert profile_device._union_us(spans) == want


def test_profile_engine_keys_on_the_cpu(native_ready):
    import shutil

    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params = weights.load_model("synthetic:tiny")
    eng = DetectionEngine(spec, params, mode="f32", buckets=(2,),
                          device="cpu")
    try:
        prof = profile_device.profile_engine(eng, bench.make_jpegs(2),
                                             [0.3, 0.3], iters=2)
    finally:
        eng.close()
    assert os.path.isdir(prof["trace_dir"])
    shutil.rmtree(prof["trace_dir"])
    assert {"buckets", "top_ops", "total_ms_per_batch", "device_only_fps",
            "trace_dir"} <= set(prof)
    # the CPU has no device events: the sums say 0, not a CPU time
    assert prof["total_ms_per_batch"] == 0 and prof["buckets"] == {}
    assert prof["device_only_fps"] is None and prof["busy_share"] == 0
    assert prof["wall_ms_per_batch"] > 0


def test_eval_map_f32_equals_jax(tmp_path, capsys):
    weights_path = os.path.join(REPO, "weights", "detect3_tiny.npz")
    argv = ["eval_map", "--weights", weights_path, "--n", "8",
            "--modes", "f32", "--batch", "4"]
    _jax_tool("eval_map").main(argv + ["--out", str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as fp:
        want = json.load(fp)
    capsys.readouterr()
    got = eval_map.main(argv + ["--out", str(tmp_path / "port.json")],
                        device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["mode"] == "f32"
    with open(tmp_path / "port.json") as fp:
        assert json.load(fp) == json.loads(json.dumps(got))
    g, w = got["modes"]["f32"], want["modes"]["f32"]
    assert abs(g["map50"] - w["map50"]) <= 1e-4
    assert abs(g["map50_95"] - w["map50_95"]) <= 1e-4
    assert set(g["per_class"]) == set(w["per_class"])
    for k, row in w["per_class"].items():
        for t, v in row.items():
            assert abs(g["per_class"][k][t] - v) <= 1e-4, (k, t)
    assert set(got) == set(want) and got["seed_base"] == 140000


@pytest.mark.parametrize("tool,argv", [
    ("saturation", ["saturation", "--clients", "1"]),
    ("eval_map", ["eval_map", "--n", "1"]),
    ("profile_device", ["profile_device", "--batch", "1"]),
])
def test_tools_raise_without_a_card(tool, argv, monkeypatch):
    import importlib

    import torch

    mod = importlib.import_module(f"fastdet_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
