"""Model step: the median of the program's ``engine.xfer_run`` span (the
transfer worker running one part of a batch: its host-to-device copies
issued, B1, the forward's launches, soft-NMS's host syncs) over the
window's parts. Source: the program's span."""


def read(run):
    return (run.window.spans.get("engine.xfer_run") or {}).get("p50_ms")
