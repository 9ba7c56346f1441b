"""A device trace of part of the window, and its arithmetic.

The trace comes from ``torch.profiler`` (host ops and CUDA activity)
written as a Chrome trace under ``TMPDIR`` and deleted once read. A
``record_function`` marker spans the traced part of the window; every
number is taken inside it. The arithmetic is the benchmark's copy of
the program's ``tools/profile_device.py`` (``_union_us``): device events
are those of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, and
busy time is the union of their intervals.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host events that name an idle gap: CUDA runtime and driver calls (of
#: every thread) and the profiling thread's own ops
HOST_CATS = {"cuda_runtime": "runtime ", "cuda_driver": "driver ",
             "cpu_op": "op "}
MARKER = "benchmark.traced_window"


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """The traced window: its bounds (us), device events (name, start,
    duration, us) inside it, and the host ops (name, start, end, us)."""
    t0: float
    t1: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def clipped(self) -> List[Tuple[float, float]]:
        return [(max(s, self.t0), min(s + d, self.t1))
                for _, s, d in self.device
                if s < self.t1 and s + d > self.t0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.clipped())) / 1e6

    def kernel_us(self, needle: str) -> Tuple[float, int]:
        """Summed device time and count of the events whose name holds
        ``needle``."""
        hits = [d for n, _, d in self.device if needle in n]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, _, d in self.device:
            by[n] = by.get(n, 0.0) + d
        return [[n[:160], us / 1e6] for n, us in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time inside the window, by the host event that
        overlapped each gap most (the innermost on a tie); "host: no
        CUDA call" where none did (Python, decode, the batcher)."""
        busy = merged(self.clipped())
        gaps, cur = [], self.t0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        longest = max((h[2] - h[1] for h in host), default=0.0)
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            best, key = "host: no CUDA call", (0.0, 0.0)
            for i in range(bisect.bisect_left(starts, g0 - longest),
                           len(host)):
                name, h0, h1 = host[i]
                if h0 >= g1:
                    break
                ov = min(h1, g1) - max(h0, g0)
                if ov > 0 and (ov, -(h1 - h0)) > key:
                    best, key = "host: " + name[:120], (ov, -(h1 - h0))
            by[best] = by.get(best, 0.0) + (g1 - g0)
        return [[n, us / 1e6] for n, us in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read_chrome_trace(path: str) -> Optional[Trace]:
    with open(path) as fp:
        events = json.load(fp).get("traceEvents", [])
    mark = [e for e in events if e.get("ph") == "X"
            and e.get("name") == MARKER and "dur" in e]
    if not mark:
        return None
    t0 = float(mark[0]["ts"])
    tr = Trace(t0, t0 + float(mark[0]["dur"]))
    kernels = launches = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            if s < tr.t1 and s + d > tr.t0:
                tr.device.append((e.get("name", ""), s, d))
                kernels += cat == "kernel"
        elif cat in HOST_CATS and s < tr.t1 and s + d > tr.t0:
            tr.host.append((HOST_CATS[cat] + e.get("name", ""), s, s + d))
            launches += "LaunchKernel" in e.get("name", "")
    if launches and not kernels:
        # kernels were launched in the window but none was recorded: the
        # trace is incomplete, and an idle share read from it would lie
        return None
    return tr


class Profiler:
    """``torch.profiler`` around the traced part of a window, on a
    schedule: built during set-up, the profiler warms up (CUPTI on, the
    device quiet, nothing kept) until ``mark()`` makes it record and
    opens the marker; ``unmark()`` closes the marker; ``finish()`` (the
    device synchronised) ends the recording and returns the
    :class:`Trace`, or None when nothing was marked or the trace lost
    its kernels."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._torch = torch
        self._cuda = cuda
        self._trace: Optional[Trace] = None
        self._marked = False
        self._prof = profile(activities=acts,
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1),
                             on_trace_ready=self._read)
        self._prof.__enter__()
        self._mark = None

    def _read(self, prof) -> None:
        fd, path = tempfile.mkstemp(prefix="benchmark-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self._trace = read_chrome_trace(path)
        finally:
            os.unlink(path)

    def mark(self) -> None:
        self._prof.step()
        self._marked = True
        self._mark = self._torch.profiler.record_function(MARKER)
        self._mark.__enter__()

    def unmark(self) -> None:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def finish(self) -> Optional[Trace]:
        if self._cuda:
            self._torch.cuda.synchronize()
        if self._marked:
            self._prof.step()
        self._prof.__exit__(None, None, None)
        return self._trace
