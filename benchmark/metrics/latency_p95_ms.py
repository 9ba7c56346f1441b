"""The 95th percentile (nearest rank) of every attempted frame's latency
from its due time to the last datagram of its answer; failed frames
count as infinitely late (benchmark.stats.latency_ms). The served path
as a camera sees it. Source: the clients' host clock."""

from benchmark.stats import latency_ms


def read(run):
    return latency_ms(run.window, 95)
