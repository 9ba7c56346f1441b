"""The open-loop schedule of the stream mixes."""

import os

import numpy as np

from benchmark.generators.open_loop_udp import schedule
from benchmark.harness import load_json

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = load_json(os.path.join(BENCH, "traffic", "stream.json"))


def test_due_times_for_a_seed():
    seed = 2 ** 31 + 17
    s = schedule(seed, MIX, 12, 20.0, 256)
    assert len(s) == 12
    period = 1.0 / MIX["fps_per_camera"]
    jit = MIX["jitter"] * period
    for cam in s:
        due = np.array([d for d, _ in cam])
        assert 0.0 <= due.min() and due.max() <= 20.0
        # frame k sits within +-20 % of a period of phase + k * period
        k = np.arange(len(due))
        phase = due - k * period
        assert phase.max() - phase.min() <= 2 * jit + 1e-9
        assert all(0 <= slot < 256 for _, slot in cam)
    # one camera in each twelfth of the period: the phases are spread
    # (each estimated, in twelfths, from a camera's frames less their
    # jitter's spread)
    phases = sorted(np.median([d - k * period for k, (d, _) in
                               enumerate(cam)]) / (period / 12) for cam in s)
    assert all(i - 0.3 <= p <= i + 1.3 for i, p in enumerate(phases))
    # the same seed gives the same schedule, another seed another one
    assert schedule(seed, MIX, 12, 20.0, 256) == s
    other = schedule(seed + 1, MIX, 12, 20.0, 256)
    assert other != s
    # every seed sends the same number of frames (the same work)
    assert sum(map(len, other)) == sum(map(len, s))


def test_frames_cover_the_pool_evenly():
    s = schedule(5, MIX, 8, 20.0, 256)
    slots = [slot for cam in s for _, slot in cam]
    counts = np.bincount(slots, minlength=256)
    assert counts.max() - counts.min() <= 1
