"""Order statistics of the benchmark."""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least ``q`` %
    of the sample at or below it. ``math.inf`` stands for a frame that
    never came (infinitely late) and sorts last; None for no sample."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


#: a percentile of latency that falls on a frame that never came
NEVER_MS = 1e9


def latency_ms(window, q: float) -> Optional[float]:
    """The ``q`` percentile of every attempted frame's latency from its
    due time to its answer, in ms; a failed frame counts as infinitely
    late, and a percentile that falls on one reads :data:`NEVER_MS`."""
    v = percentile([(f.answered - f.due) * 1e3 if window.ok(f) else math.inf
                    for f in window.frames], q)
    if v is None:
        return None
    return NEVER_MS if math.isinf(v) else v
