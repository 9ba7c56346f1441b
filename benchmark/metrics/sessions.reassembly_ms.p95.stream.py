"""Wire and sessions: the 95th percentile of the program's
``session.reassembly`` span (DetectSession: a payload's first datagram
to the payload reassembled, on the server's event loop) over the
window's requests. Source: the program's span."""


def read(run):
    return (run.window.spans.get("session.reassembly") or {}).get("p95_ms")
