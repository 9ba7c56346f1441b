"""Kernels: kernel launches a forward. The trace's host events whose
name holds ``LaunchKernel`` (CUDA runtime and driver calls, of any
thread) that start inside one of the program's ``engine.xfer_run`` spans
lying wholly in the traced part of the window, over the number of those
spans. The spans come from the program's event ring, on the trace's
clock. Source: the device trace."""

import bisect

from benchmark.tracing import merged

NAME = "engine.xfer_run"


def read(run):
    w = run.window
    t = w.trace
    events = w.spans.get("events")
    if t is None or not t.device or not events:
        return None
    spans = sorted((e["start_us"], e["end_us"]) for e in events
                   if e["name"] == NAME
                   and t.t0 <= e["start_us"] and e["end_us"] <= t.t1)
    if not spans:
        return None
    union = merged(spans)
    starts = [a for a, _ in union]
    launches = 0
    for name, h0, _ in t.host:
        if "LaunchKernel" in name:
            i = bisect.bisect_right(starts, h0) - 1
            launches += i >= 0 and h0 <= union[i][1]
    return launches / len(spans)
