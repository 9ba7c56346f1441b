"""Engine: forwards run a batch, the count of the program's
``engine.xfer_run`` spans (one a part: a B1 tier or a planes group of a
batch) over the count of its ``infer_batch`` spans (one a batch), both
over the whole window. Source: the program's counters."""


def read(run):
    spans = run.window.spans
    runs = (spans.get("engine.xfer_run") or {}).get("count")
    batches = (spans.get("infer_batch") or {}).get("count")
    if not runs or not batches:
        return None
    return runs / batches
