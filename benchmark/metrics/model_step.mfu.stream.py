"""Model step: the configuration's FLOPs a frame (benchmark.flops, the
published layer list) times the frames answered inside the window, over
the window's seconds and the H100's dense bf16 peak (989 TFLOP/s at
700 W; the card's power limit is on the run's ``card`` line).
Source: the host clock."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(run):
    w = run.window
    return (100.0 * run.flops_per_frame() * w.answered_in_window()
            / w.seconds / PEAK_BF16_FLOPS)
