"""fastdet_tpu_torch and chip_smoke.py stand alone: no module imports JAX
or the JAX package (the card machine has neither), nothing reads outside
the repository, and entry points asked for the (default) CUDA device on
a machine without a card raise instead of falling back to the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "fastdet_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "fastdet_tpu")


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    assert not _top_level_imports(path) & set(BLOCKED)
    text = path.read_text()
    # the port loads registry paths through its own
    # fastdet_tpu_torch.parallel.checkpoint.cached_import; naming the JAX
    # package's module (fastdet_tpu.parallel.checkpoint) is refused
    assert "/root/" not in text and "fastdet_tpu.parallel" not in text


def test_every_module_imports_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {BLOCKED!r}
        for m in list(sys.modules):
            if m.split(".")[0] in BLOCKED:
                del sys.modules[m]
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        import fastdet_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            fastdet_tpu_torch.__path__, "fastdet_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        for m in ("ops.ingest_stages", "models.quantize", "models.s2d",
                  "tools.debug_ingest", "parallel.checkpoint",
                  "models.onnx_io", "data.synth", "ops.metrics",
                  "client_api", "utils.labels", "utils.draw",
                  "parallel.train", "cli.detector", "cli.client",
                  "cli.demo", "cli.httpserver", "cli.inspect_weights",
                  "cli.train", "bench", "tools.client_load",
                  "tools.profile_device", "tools.saturation",
                  "tools.eval_map"):
            assert "fastdet_tpu_torch." + m in mods, m
        import chip_smoke
        try:
            chip_smoke.main(["chip_smoke.py", "--help"])
        except SystemExit as e:
            assert e.code == 0
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(len(mods), "modules")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-2]) >= 20


def test_chip_smoke_refuses_without_repo(tmp_path):
    """Alone in a directory, chip_smoke.py exits nonzero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    from fastdet_tpu_torch import device
    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import build_services

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionEngine(spec, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_services(["tiny:80:synthetic:tiny"], warmup=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    assert device.resolve("cpu").type == "cpu"


def test_device_tensors_never_take_the_plain_versions(monkeypatch):
    """Only CPU tensors take a kernel's plain version: tensors on another
    device go to the kernel library or raise (here, with no card and the
    build made to fail, they raise)."""
    from fastdet_tpu_torch.ops import _build, plane_ingest, sparse_ingest

    def no_build():
        raise _build.BuildError("nvcc not found")

    monkeypatch.setattr(_build, "_KERNELS", None)
    monkeypatch.setattr(_build, "build_kernels", no_build)
    meta = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    half = torch.empty((1, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises((ValueError, _build.BuildError)):
        plane_ingest.plane_ingest_batch(meta, half, half)
    offs = torch.zeros((1, 4, 3), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, _build.BuildError)):
        sparse_ingest.reconstruct(
            offs, torch.empty((1, 8), dtype=torch.uint8, device="meta"),
            torch.empty((1, 8), dtype=torch.int32, device="meta"),
            torch.empty((1, 8), dtype=torch.int8, device="meta"),
            torch.empty((1, 8), dtype=torch.int16, device="meta"), -4)
