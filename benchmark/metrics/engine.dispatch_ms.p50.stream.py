"""Engine: the median of the program's ``dispatch_batch`` span (host
routing, entropy decode, staging and the dispatch of one batch; the
batcher's executor call), its samples reset at the window's start.
Source: the program's span."""


def read(run):
    s = run.window.spans.get("dispatch_batch") or {}
    return s.get("p50_ms")
