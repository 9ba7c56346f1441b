"""Frames answered inside the window (in time, without error) over the
window's seconds, in a stream cell: the offered rate less the frames
still in flight when the window closes, so it falls when the server
stops keeping up. Source: the host clock."""


def read(run):
    return run.window.answered_in_window() / run.window.seconds
