"""Batcher: the 95th percentile of the answers' ``msec`` field, the
server's time from a request's parse to its answer (DetectSession's
span), over every answered frame. Source: the program's span."""

from benchmark.stats import percentile


def read(run):
    w = run.window
    return percentile([f.msec for f in w.frames
                       if w.ok(f) and f.msec is not None], 95)
