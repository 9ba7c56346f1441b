"""Batcher: frames per dispatched batch over the window, from the change
in ``ModelService.batch_hist`` between the window's start and end.
Source: the program's counter."""


def read(run):
    before, after = run.window.before["batch_hist"], \
        run.window.after["batch_hist"]
    n = {k: after[k] - before.get(k, 0) for k in after}
    batches = sum(n.values())
    if batches == 0:
        return None
    return sum(k * v for k, v in n.items()) / batches
