"""utils/profiling: device_trace, the port's counterpart of the JAX
package's jax.profiler scope (a no-op without a directory, a Chrome
trace of the scope's work with one or with FASTDET_TRACE_DIR), and the
span recorder: whole-window counts and percentiles, the event ring, its
thread safety, and its conversion to the device trace's clock.

The ``gpu`` test skips without a card; on the card this file runs on its
own (it imports no JAX):

    python -m pytest -q -m gpu --noconftest tests/test_torch_profiling.py
"""

import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
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


def _span_ns(timer, name, durations):
    t = 1_000_000
    for d in durations:
        timer.record(name, t, t + int(d))
        t += int(d) + 1


def test_percentiles_within_one_percent_and_counts_exact():
    rng = np.random.default_rng(20261018)
    xs = np.rint(rng.lognormal(np.log(5e6), 1.0, 10_000)).astype(np.int64)
    timer = profiling.StageTimer()
    _span_ns(timer, "s", xs)
    got = timer.summary("s")
    for q in (50, 90, 95, 99):
        want = np.percentile(xs, q) / 1e6
        assert abs(got[f"p{q}_ms"] - want) <= 0.01 * want, q
    # every sample counts, far past the old 2048-sample window
    assert got["count"] == 10_000
    assert got["mean_ms"] == pytest.approx(int(xs.sum()) / 10_000 / 1e6,
                                           rel=1e-12)
    assert timer.snapshot()["s"] == got
    assert timer.summary("absent") == {}


def test_reset_empties_spans_and_ring():
    timer = profiling.StageTimer()
    _span_ns(timer, "a", [5, 6])
    assert len(timer.snapshot()[profiling.EVENTS]) == 2
    before = timer.anchor
    timer.reset()
    assert timer.snapshot() == {profiling.EVENTS: []}
    assert timer.anchor >= before
    _span_ns(timer, "b", [7])
    snap = timer.snapshot()
    assert set(snap) == {"b", profiling.EVENTS}
    assert [e["name"] for e in snap[profiling.EVENTS]] == ["b"]


def test_ring_keeps_the_newest_events_with_their_tags():
    timer = profiling.StageTimer()
    for i in range(profiling.RING + 5):
        timer.record("r", i, i + 1, rid=i, bid=-i, part="p")
    snap = timer.snapshot()
    events = snap[profiling.EVENTS]
    assert len(events) == profiling.RING
    assert [e["rid"] for e in events[:2]] == [5, 6]
    assert events[-1]["bid"] == -(profiling.RING + 4)
    assert {e["part"] for e in events} == {"p"}
    assert {e["thread"] for e in events} == {
        threading.current_thread().name}
    assert snap["r"]["count"] == profiling.RING + 5


def test_counts_exact_under_four_threads():
    timer = profiling.StageTimer()
    n = 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_span_ns,
                                    args=(timer, "x", [k + 1] * n))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = timer.summary("x")
    assert got["count"] == 4 * n
    assert got["mean_ms"] * 1e6 == pytest.approx((1 + 2 + 3 + 4) / 4,
                                                 rel=1e-12)


def test_trace_clock_arithmetic():
    base = 227 * profiling.TRIMESTER_NS    # a trimester boundary
    anchor = (5_000, base + 1_234_567)     # (perf_counter_ns, time_ns)
    assert profiling.trace_us(5_000, anchor) == 1234.567
    assert profiling.trace_us(7_000, anchor) == 1236.567
    assert profiling.trace_us(4_000, anchor) == 1233.567
    # torch.profiler's own base: the Unix time floored to the trimester
    unix = 1_792_296_838_504_828_697
    assert profiling.trace_us(0, (0, unix)) * 1e3 == pytest.approx(
        unix - 1_790_857_026_000_000_000, abs=1)


def test_main_thread_op_lies_inside_its_span_on_the_trace_clock():
    """The profiler's host ops (its own thread) on the recorder's
    converted clock: a marked op lies inside the span around it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    timer = profiling.StageTimer()
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = profiling.now_ns()
        with record_function("fastdet.mark"):
            a @ a
        timer.record("mark", t0, profiling.now_ns())
    ev = _export(prof, "fastdet.mark")
    (span,) = timer.snapshot()[profiling.EVENTS]
    assert span["start_us"] - 50 <= ev["ts"]
    assert ev["ts"] + ev["dur"] <= span["end_us"] + 50


def _export(prof, name, cat=None):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as fp:
            events = json.load(fp)["traceEvents"]
    hits = [e for e in events if e.get("ph") == "X"
            and name in e.get("name", "")
            and (cat is None or e.get("cat") == cat)]
    assert len(hits) == 1, hits
    return hits[0]


@pytest.mark.gpu
def test_worker_launch_lies_inside_its_span_on_the_trace_clock():
    """torch.profiler on the main thread; a recorder span on a worker
    thread around one CUDA launch: the launch's ``cuda_runtime`` event,
    on the recorder's converted clock, lies inside the span within
    50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum()
    torch.cuda.synchronize()
    timer = profiling.StageTimer()

    def launch():
        t0 = profiling.now_ns()
        torch.mul(x, 3)
        timer.record("launch", t0, profiling.now_ns())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        worker = threading.Thread(target=launch, name="fd-test-worker")
        worker.start()
        worker.join(30)
        assert not worker.is_alive()
        torch.cuda.synchronize()
    ev = _export(prof, "LaunchKernel", cat="cuda_runtime")
    (span,) = timer.snapshot()[profiling.EVENTS]
    assert span["start_us"] - 50 <= ev["ts"]
    assert ev["ts"] + ev["dur"] <= span["end_us"] + 50
