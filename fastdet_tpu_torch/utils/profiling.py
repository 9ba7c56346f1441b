"""Tracing / profiling subsystem.

The reference's only instrumentation is two hand-rolled wall-clocks: the
per-request msec reported in the YOLO response header and the client-side
SentTime/RecvTime delta (SURVEY.md §5). Here:

- :class:`StageTimer` — lock-free per-stage duration histograms (decode /
  infer / fetch / batch-wait / e2e), cheap enough for the hot path, with
  p50/p90/p99 summaries and periodic log emission;
- :func:`device_trace` — a ``torch.profiler`` scope (host and CUDA
  activity) that writes a Chrome trace, the counterpart of the JAX
  package's ``jax.profiler`` scope.

The wire-level msec field stays bit-compatible (DetectSession reports it
exactly like the reference); this module is additive observability.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)


class StageTimer:
    """Rolling per-stage latency stats (seconds in, ms out)."""

    def __init__(self, window: int = 2048, log_every: Optional[int] = None):
        self._samples: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._counts: Dict[str, int] = defaultdict(int)
        self.log_every = log_every

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)
        self._counts[name] += 1
        if self.log_every and self._counts[name] % self.log_every == 0:
            logger.info("stage %s: %s", name, self.summary_line(name))

    def percentiles(self, name: str, qs=(50, 90, 99)) -> Dict[str, float]:
        xs = np.asarray(self._samples[name], dtype=np.float64)
        if xs.size == 0:
            return {}
        out = {f"p{q}_ms": float(np.percentile(xs, q) * 1e3) for q in qs}
        out["mean_ms"] = float(xs.mean() * 1e3)
        out["count"] = self._counts[name]
        return out

    def summary_line(self, name: str) -> str:
        p = self.percentiles(name)
        if not p:
            return "no samples"
        return (
            f"n={p['count']} mean={p['mean_ms']:.2f}ms "
            f"p50={p['p50_ms']:.2f} p90={p['p90_ms']:.2f} p99={p['p99_ms']:.2f}"
        )

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: self.percentiles(name) for name in self._samples}

    def reset(self) -> None:
        """Drop all samples/counts — measurement harnesses call this so
        a sweep row's percentiles reflect only that row's traffic
        (advisor r4: the rolling deques otherwise mix warmup + every
        earlier row into each row's numbers)."""
        self._samples.clear()
        self._counts.clear()

    def log_all(self) -> None:
        for name in sorted(self._samples):
            logger.info("stage %s: %s", name, self.summary_line(name))


def _log_every_env() -> Optional[int]:
    """FASTDET_STAGE_LOG_EVERY, tolerantly: a typo'd value must not
    crash the whole serving stack at import time (this module is
    imported by runtime/server.py)."""
    raw = os.environ.get("FASTDET_STAGE_LOG_EVERY", "0")
    try:
        return int(raw) or None
    except ValueError:
        logger.warning(
            "FASTDET_STAGE_LOG_EVERY=%r is not an integer; disabled", raw)
        return None


#: process-global timer used by the serving runtime
GLOBAL = StageTimer(log_every=_log_every_env())


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
