"""Tracing / profiling subsystem: the port's one tracer.

The reference's only instrumentation is two hand-rolled wall-clocks: the
per-request msec reported in the YOLO response header and the client-side
SentTime/RecvTime delta (SURVEY.md §5). Here:

- :class:`StageTimer`, process-wide as :data:`GLOBAL` — named spans, each
  cut from two ``time.perf_counter_ns()`` stamps that the caller takes
  once per boundary (so adjacent spans share their stamps). Per span
  name it keeps, over every sample since the last ``reset()``, an exact
  count and sum and a log-bucketed histogram whose percentiles are
  within 0.5 % of the samples' own (memory bounded whatever the
  traffic); the newest :data:`RING` spans are also kept as events (name,
  start, end, thread, request id, batch id, part) that ``snapshot()``
  puts on the device trace's clock (:func:`trace_us`);
- :func:`new_id`, :func:`call_in_batch`, :func:`current_batch` — the
  request and batch ids the serving path tags its spans with, and the
  batch a thread is working for;
- :func:`device_trace` — a ``torch.profiler`` scope (host and CUDA
  activity) that writes a Chrome trace, the counterpart of the JAX
  package's ``jax.profiler`` scope.

The wire-level msec field stays bit-compatible (DetectSession reports it
exactly like the reference); this module is additive observability.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import logging
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: histogram buckets per factor e of duration: bucket i >= 1 holds
#: [exp((i-1)/K), exp(i/K)) ns and reads as its geometric centre, so a
#: percentile is off by at most exp(0.5/K) - 1 = 0.5 %; bucket 0 holds 0
_PER_E = 1.0 / math.log(1.01)
#: durations up to 10**13 ns (2.8 h) get their own bucket; longer ones
#: share the last
_NBUCKETS = int(math.log(1e13) * _PER_E) + 2
#: events kept: >= 18 s of a 180 frames/s stream at one frame a batch
#: (10 spans a frame), ~40 s at its usual batches of 8
RING = 1 << 15
#: the key of ``snapshot()``'s event list (no span takes this name)
EVENTS = "events"
#: libkineto's ChromeTraceBaseTime: a Chrome trace's ``ts`` counts
#: microseconds from the Unix time floored to a multiple of this
TRIMESTER_NS = 7_889_238 * 1_000_000_000

now_ns = time.perf_counter_ns

_ids = itertools.count(1)
_batch = threading.local()


def new_id() -> int:
    """A fresh id for a request or a batch (one sequence for both, unique
    in the process)."""
    return next(_ids)


def call_in_batch(bid: Optional[int], fn, *args):
    """``fn(*args)`` with ``bid`` as this thread's :func:`current_batch`:
    the engine tags the device work it queues with it."""
    _batch.bid = bid
    try:
        return fn(*args)
    finally:
        _batch.bid = None


def current_batch() -> Optional[int]:
    """The batch id of the :func:`call_in_batch` this thread is in."""
    return getattr(_batch, "bid", None)


def clock_anchor() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the perf counter's value
    is the midpoint of two reads around the Unix clock's."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, unix


def trace_us(stamp_ns: int, anchor: Tuple[int, int]) -> float:
    """A ``perf_counter_ns`` stamp in the time base of the Chrome trace
    ``torch.profiler`` writes: microseconds since the trimester base
    (:data:`TRIMESTER_NS`) below the Unix time, through ``anchor``
    (:func:`clock_anchor`)."""
    perf0, unix0 = anchor
    return (unix0 - unix0 // TRIMESTER_NS * TRIMESTER_NS
            + stamp_ns - perf0) / 1e3


class _Span:
    __slots__ = ("count", "sum_ns", "buckets")

    def __init__(self):
        self.count = 0
        self.sum_ns = 0
        self.buckets = [0] * _NBUCKETS


def _bucket_ns(i: int) -> float:
    return 0.0 if i == 0 else math.exp((i - 0.5) / _PER_E)


def _summary(count: int, sum_ns: int, buckets: List[int],
             qs=(50, 90, 95, 99)) -> Dict[str, float]:
    """Percentiles as ``numpy.percentile``'s linear rule takes them
    between order statistics, each order statistic read from its bucket."""
    cum = list(itertools.accumulate(buckets))

    def order_stat(k: int) -> float:   # the k-th smallest, from 0
        return _bucket_ns(bisect.bisect_right(cum, k))

    out = {}
    for q in qs:
        h = (count - 1) * q / 100.0
        lo = math.floor(h)
        v = order_stat(lo)
        if h > lo:
            v += (h - lo) * (order_stat(lo + 1) - v)
        out[f"p{q}_ms"] = v / 1e6
    out["mean_ms"] = sum_ns / count / 1e6
    out["count"] = count
    return out


class StageTimer:
    """Whole-window span statistics and a ring of span events; every
    method may be called from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, _Span] = {}
        self._ring: collections.deque = collections.deque(maxlen=RING)
        self.anchor = clock_anchor()

    def record(self, name: str, start_ns: int, end_ns: int, *,
               rid: Optional[int] = None, bid: Optional[int] = None,
               part: Optional[str] = None) -> None:
        """One span of ``name`` from ``start_ns`` to ``end_ns``
        (``perf_counter_ns`` stamps), tagged with its request id, batch
        id and part."""
        d = max(end_ns - start_ns, 0)
        i = min(int(math.log(d) * _PER_E) + 1, _NBUCKETS - 1) if d else 0
        ev = (name, start_ns, end_ns, threading.get_ident(), rid, bid, part)
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                s = self._spans[name] = _Span()
            s.count += 1
            s.sum_ns += d
            s.buckets[i] += 1
            self._ring.append(ev)

    def summary(self, name: str) -> Dict[str, float]:
        """{p50_ms, p90_ms, p95_ms, p99_ms, mean_ms, count} of ``name``;
        empty without samples."""
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                return {}
            count, sum_ns, buckets = s.count, s.sum_ns, list(s.buckets)
        return _summary(count, sum_ns, buckets)

    def snapshot(self) -> Dict[str, object]:
        """:meth:`summary` of every span name, and under :data:`EVENTS`
        the ring's events, oldest first, as dicts of name, ``start_us``
        and ``end_us`` (:func:`trace_us`), thread (its name, or its ident
        once it has ended), rid, bid and part."""
        with self._lock:
            spans = {n: (s.count, s.sum_ns, list(s.buckets))
                     for n, s in self._spans.items()}
            ring = list(self._ring)
            anchor = self.anchor
        threads = {t.ident: t.name for t in threading.enumerate()}
        out: Dict[str, object] = {n: _summary(*v) for n, v in spans.items()}
        out[EVENTS] = [
            {"name": n, "start_us": trace_us(t0, anchor),
             "end_us": trace_us(t1, anchor),
             "thread": threads.get(th, str(th)),
             "rid": rid, "bid": bid, "part": part}
            for n, t0, t1, th, rid, bid, part in ring]
        return out

    def reset(self) -> None:
        """Drop all samples and events and take the clock anchor again —
        measurement harnesses call this so that a window (or a sweep
        row) holds exactly its own samples."""
        with self._lock:
            self._spans.clear()
            self._ring.clear()
            self.anchor = clock_anchor()


#: process-global timer used by the serving runtime
GLOBAL = StageTimer()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace scope. No-op unless a directory is given or
    FASTDET_TRACE_DIR is set; otherwise traces the host and, where a
    card is present, its CUDA activity, and writes one Chrome trace
    (``trace-<pid>-<ns>.json``) into the directory."""
    trace_dir = trace_dir or os.environ.get("FASTDET_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
