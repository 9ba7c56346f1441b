"""utils/profiling.device_trace, the port's counterpart of the JAX
package's jax.profiler scope: a no-op without a directory, a Chrome
trace of the scope's work with one (or with FASTDET_TRACE_DIR)."""

import json

import torch

from fastdet_tpu_torch.utils import profiling


def test_device_trace_is_a_noop_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("FASTDET_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace():
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("FASTDET_TRACE_DIR", raising=False)
    out = tmp_path / "given"
    with profiling.device_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = out.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

    env = tmp_path / "env"
    monkeypatch.setenv("FASTDET_TRACE_DIR", str(env))
    with profiling.device_trace():
        torch.ones(8).sum()
    assert len(list(env.iterdir())) == 1
