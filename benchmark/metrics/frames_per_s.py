"""Frames answered inside the window (in time, without error) over the
window's seconds. Source: the host clock."""


def read(run):
    return run.window.answered_in_window() / run.window.seconds
