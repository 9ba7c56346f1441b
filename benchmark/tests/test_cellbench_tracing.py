"""The readers of the program's spans and of their join with the device
trace, on hand-built windows and traces with known intervals."""

import os
from types import SimpleNamespace

import pytest

from benchmark.generators import Window
from benchmark.harness import load_reader
from benchmark.tracing import Trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(spans=None, trace=None):
    w = Window(t0=0.0, t1=51.0, deadline_s=3.0, spans=spans or {},
               trace=trace)
    return SimpleNamespace(window=w)


def _summary(p50, p95, count):
    return {"p50_ms": p50, "p90_ms": p95 - 1, "p95_ms": p95,
            "p99_ms": p95 + 1, "mean_ms": p50 + 0.5, "count": count}


def _event(name, start, end, bid=1):
    return {"name": name, "start_us": float(start), "end_us": float(end),
            "thread": "fd-xfer0_0", "rid": None, "bid": bid,
            "part": "sparse:22"}


@pytest.mark.parametrize("metric,span,key", [
    ("sessions.reassembly_ms.p95.stream", "session.reassembly", "p95_ms"),
    ("batcher.queue_wait_ms.p95.stream", "service.queue_wait", "p95_ms"),
    ("batcher.pipeline_wait_ms.p95.stream", "service.pipeline_wait",
     "p95_ms"),
    ("engine.xfer_wait_ms.p95.stream", "engine.xfer_wait", "p95_ms"),
    ("engine.xfer_run_ms.p50.stream", "engine.xfer_run", "p50_ms"),
])
def test_span_readers_read_their_span(metric, span, key):
    read = load_reader(BENCH, metric)
    spans = {span: _summary(3.25, 17.5, 40),
             "request_e2e": _summary(100.0, 400.0, 40), "events": []}
    assert read(_run(spans)) == spans[span][key]
    # the parent's program records no such span
    assert read(_run({"request_e2e": _summary(100.0, 400.0, 40)})) is None
    assert read(_run()) is None


def test_forwards_per_batch_counts_parts_over_batches():
    read = load_reader(BENCH, "engine.forwards_per_batch.stream")
    spans = {"engine.xfer_run": _summary(5.0, 9.0, 12),
             "infer_batch": _summary(50.0, 90.0, 8)}
    assert read(_run(spans)) == 1.5
    assert read(_run({"infer_batch": _summary(50.0, 90.0, 8)})) is None
    assert read(_run()) is None


def _trace():
    """A traced window of 100..200 us: kernels at 120-125 and 160-170;
    launch calls at 106, 110 (driver), 116, 150 (outside every span),
    95 (inside a span that starts before the window) and 198 (inside one
    that ends after it), a copy at 112."""
    return Trace(100.0, 200.0,
                 device=[("k1", 120.0, 5.0), ("k2", 160.0, 10.0)],
                 host=[("runtime cudaLaunchKernel", 106.0, 107.0),
                       ("driver cuLaunchKernel", 110.0, 111.0),
                       ("runtime cudaMemcpyAsync", 112.0, 113.0),
                       ("runtime cudaLaunchKernelExC", 116.0, 117.0),
                       ("runtime cudaLaunchKernel", 150.0, 151.0),
                       ("runtime cudaLaunchKernel", 141.0, 142.0),
                       ("runtime cudaLaunchKernel", 95.0, 96.0),
                       ("runtime cudaLaunchKernel", 198.0, 199.0)])


def test_launches_per_forward_counts_launches_inside_whole_spans():
    read = load_reader(BENCH, "engine.launches_per_forward.stream")
    events = [_event("engine.xfer_run", 90, 102),     # starts before
              _event("engine.xfer_run", 105, 118),    # 3 launches
              _event("infer_batch", 100, 200),        # not a forward
              _event("engine.xfer_run", 140, 148),    # 1 launch
              _event("engine.xfer_run", 190, 205)]    # ends after
    assert read(_run({"events": events}, _trace())) == (3 + 1) / 2
    assert read(_run({"events": events})) is None
    assert read(_run({}, _trace())) is None
    assert read(_run({"events": events[2:3]}, _trace())) is None
    assert read(_run({"events": events}, Trace(100.0, 200.0))) is None


def test_idle_in_xfer_run_is_the_share_of_idle_time_inside_spans():
    read = load_reader(BENCH, "device.idle_in_xfer_run.stream")
    tr = Trace(0.0, 100.0, device=[("k", 10.0, 20.0), ("k", 50.0, 10.0)])
    # idle: 0-10, 30-50, 60-100 (70 us); spans: -10-2 (2 us of idle in
    # the window), 5-40 (5 + 10), 55-70 (10); 35-38 overlaps 5-40
    events = [_event("engine.xfer_run", -10, 2),
              _event("engine.xfer_run", 5, 40),
              _event("engine.fetch_batch", 3, 100),
              _event("engine.xfer_run", 35, 38),
              _event("engine.xfer_run", 55, 70)]
    assert read(_run({"events": events}, tr)) == pytest.approx(
        100.0 * 27 / 70)
    # the ring no longer reaches the window's start
    assert read(_run({"events": events[1:]}, tr)) is None
    assert read(_run({"events": events})) is None
    assert read(_run({}, tr)) is None
    assert read(_run({"events": events}, Trace(0.0, 100.0))) is None
    busy = Trace(0.0, 100.0, device=[("k", 0.0, 100.0)])
    assert read(_run({"events": events}, busy)) is None
