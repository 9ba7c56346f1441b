"""Process start to the window's start: interpreter, weights, frame pool,
engine build and warm-up (the background warm-up joined), server and
clients, warm frames. Source: the host clock."""


def read(run):
    return run.setup_s
