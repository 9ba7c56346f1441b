"""What the host did during the window, for the run's diagnostics.

A snapshot at the window's start and one at its end: the CPU seconds of
each of this process's threads (by name, from ``/proc/self/task``) and
the time spent in the garbage collector. A thread whose CPU seconds a
frame grow while the frames a second fall shows a host that runs slower,
not more work. Read on Linux only; elsewhere a snapshot is empty.
Printed on standard error, never a metric.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List


def _threads() -> Dict[str, float]:
    """CPU seconds by thread name: the Python name where the thread is
    Python's (numbered pool threads such as ``fd-decode_3`` summed under
    their pool's name), else the kernel's ``comm``."""
    import threading

    tick = os.sysconf("SC_CLK_TCK")
    names = {t.native_id: t.name for t in threading.enumerate()}
    out: Dict[str, float] = defaultdict(float)
    base = "/proc/self/task"
    for tid in os.listdir(base):
        try:
            with open(f"{base}/{tid}/comm") as fp:
                name = fp.read().strip()
            with open(f"{base}/{tid}/stat") as fp:
                f = fp.read().rsplit(")", 1)[1].split()
        except OSError:
            continue          # the thread ended between the two reads
        name = names.get(int(tid), name)
        name = name.rstrip("0123456789").rstrip("_-") or name
        out[name] += (int(f[11]) + int(f[12])) / tick
    return dict(out)


#: seconds spent in the garbage collector, and collections, by generation
GC = {"s": [0.0, 0.0, 0.0], "n": [0, 0, 0], "longest_s": 0.0}
_gc_start = [0.0]


def _gc_callback(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_start[0] = time.perf_counter()
        return
    dt = time.perf_counter() - _gc_start[0]
    g = int(info.get("generation", 0))
    GC["s"][g] += dt
    GC["n"][g] += 1
    GC["longest_s"] = max(GC["longest_s"], dt)


def watch_gc() -> None:
    """Time the garbage collector from now on (once per process)."""
    import gc

    if _gc_callback not in gc.callbacks:
        gc.callbacks.append(_gc_callback)


def snapshot() -> dict:
    try:
        return {"t": time.monotonic(), "threads": _threads(),
                "gc": {"s": list(GC["s"]), "n": list(GC["n"])}}
    except OSError:
        return {}


def report(a: dict, b: dict) -> str:
    """One line: the window's seconds, the busiest threads' CPU share of
    one core, and the garbage collector's share of the window."""
    if not a or not b:
        return "host load: not read"
    dt = b["t"] - a["t"]
    th = {k: b["threads"][k] - a["threads"].get(k, 0.0)
          for k in b["threads"]}
    busy = sorted(th.items(), key=lambda kv: -kv[1])[:8]
    gcs = [y - x for x, y in zip(a["gc"]["s"], b["gc"]["s"])]
    gcn = [y - x for x, y in zip(a["gc"]["n"], b["gc"]["n"])]
    return (f"host load over {dt:.3f} s: threads (share of one core) "
            + ", ".join(f"{k} {100 * v / dt:.1f} %" for k, v in busy)
            + f"; process {100 * sum(th.values()) / dt:.1f} % of one core"
            + f"; garbage collections by generation {gcn} taking "
            + f"{[round(x, 4) for x in gcs]} s (longest since the "
            + f"process began {GC['longest_s']:.4f} s)")


def per_second(t0: float, t1: float, times: List[float]) -> List[int]:
    """How many of ``times`` fall in each whole second of [t0, t1)."""
    n = max(1, round(t1 - t0))
    out = [0] * n
    for t in times:
        if t0 <= t < t1:
            out[min(n - 1, int(t - t0))] += 1
    return out
