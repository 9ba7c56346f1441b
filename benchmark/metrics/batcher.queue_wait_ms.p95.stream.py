"""Batcher: the 95th percentile of the program's ``service.queue_wait``
span (ModelService: a request parsed and queued to the batch that
answers it formed; a carried request counts from its first queueing)
over the window's requests. Source: the program's span."""


def read(run):
    return (run.window.spans.get("service.queue_wait") or {}).get("p95_ms")
