"""Device: of the traced part of the window's idle device time (the
window less the union of its kernels, copies and sets), the share that
falls inside one of the program's ``engine.xfer_run`` spans, while the
transfer worker ran a part of a batch (its copies, launches and host
syncs). High: the card waits on the launching thread; low: nothing was
queued for it. The spans come from the program's event ring, on the
trace's clock, and must reach back to the traced window's start.
Source: the device trace."""

from benchmark.tracing import merged

NAME = "engine.xfer_run"


def read(run):
    w = run.window
    t = w.trace
    events = w.spans.get("events")
    if t is None or not t.device or not events \
            or min(e["start_us"] for e in events) > t.t0:
        return None
    idle, cur = [], t.t0
    for a, b in merged(t.clipped()):
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if cur < t.t1:
        idle.append((cur, t.t1))
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    runs = merged((max(e["start_us"], t.t0), min(e["end_us"], t.t1))
                  for e in events if e["name"] == NAME
                  and e["start_us"] < t.t1 and e["end_us"] > t.t0)
    inside, j = 0.0, 0
    for a, b in idle:
        while j < len(runs) and runs[j][1] <= a:
            j += 1
        k = j
        while k < len(runs) and runs[k][0] < b:
            inside += min(b, runs[k][1]) - max(a, runs[k][0])
            k += 1
    return 100.0 * inside / total
