"""Device: the share of the traced part of the window in which no
kernel, copy or set ran on the card (100 - the union of the device
events' intervals over the traced window). Source: the device trace."""


def read(run):
    t = run.window.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
