"""Engine: the 95th percentile of the program's ``engine.xfer_wait``
span (DetectionEngine: a part of a batch, one B1 tier or planes group,
queued for the transfer worker to the worker starting it) over the
window's parts. Source: the program's span."""


def read(run):
    return (run.window.spans.get("engine.xfer_wait") or {}).get("p95_ms")
