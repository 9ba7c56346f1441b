"""Batcher: the 95th percentile of the program's ``service.pipeline_wait``
span (ModelService: a batch formed to one of its MAX_INFLIGHT slots
held) over the window's batches. Source: the program's span."""


def read(run):
    return (run.window.spans.get("service.pipeline_wait") or {}).get(
        "p95_ms")
