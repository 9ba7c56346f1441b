"""Wire and sessions: the 95th percentile over answered frames of the
time outside the server's own request span, (answer - actual send) on
the client's clock minus the answer's ``msec`` field (the server's
in-server time, 1 ms resolution). Source: the host clock."""

from benchmark.stats import percentile


def read(run):
    w = run.window
    return percentile([(f.answered - f.sent) * 1e3 - f.msec
                       for f in w.frames
                       if w.ok(f) and f.msec is not None], 95)
