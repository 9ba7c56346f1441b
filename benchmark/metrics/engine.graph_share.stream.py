"""Model step: the share of the transfer worker's parts whose prefix
(ingest, the net, the head decode, top-K) ran as a replayed CUDA graph:
100 x the count of the program's ``engine.graph_replay`` spans (one a
replayed part) over the count of its ``engine.xfer_run`` spans (one a
part), both over the whole window. A program that records no
``engine.graph_replay`` reads nothing. Source: the program's counters."""


def read(run):
    spans = run.window.spans
    runs = (spans.get("engine.xfer_run") or {}).get("count")
    replays = (spans.get("engine.graph_replay") or {}).get("count")
    if not runs or replays is None:
        return None
    return 100.0 * replays / runs
