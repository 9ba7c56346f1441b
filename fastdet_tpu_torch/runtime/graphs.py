"""CUDA graphs of the engine's sync-free prefix.

A part of a batch (one B1 tier, planes group or pixel batch of one
shard) runs ingest, the net, the head decode and the top-K selection
without a host sync; soft-NMS then syncs once a trip. Launched one by
one, the prefix's several hundred kernels pace the card at the host's
speed. The engine captures the prefix of each program it warms (a
program key: ``("pixels", b)``, ``("sparse", layout, tier, b)``,
``("planes", layout, b)``) once per shard, right after the key's warm
run, and replays it for every later part of that key: the part's arrays
are copied into the graph's static inputs, one ``cudaGraphLaunch``
runs the prefix, and the eager tail reads the static outputs before the
next part of the shard can replay anything.

- One memory pool per shard: its graphs' intermediates share it, which
  is safe because one worker replays them, each replay's outputs read by
  its tail on the same stream before the next replay.
- Capture runs on a stream that is not the legacy default stream (the
  worker's side stream, or the background warm thread's own), in
  ``thread_local`` mode, so serving on other threads goes on meanwhile;
  a sync of the whole device from any thread would break it.
- The hand-written kernels' launch counters (B1, B2) tally a captured
  launch instead of counting it (``ops/_build.capturing``); each replay
  adds what its graph holds.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from fastdet_tpu_torch.ops import _build

#: a capturer: (prefix fn, static inputs, device, pool key) ->
#: (static outputs, replay, launch tally)
Capturer = Callable[..., Tuple[tuple, Callable[[], None],
                               Dict[Callable[[int], None], int]]]


class PrefixGraph:
    """One captured prefix: its static inputs and outputs, its replay and
    the hand-written kernels' launches it holds."""

    __slots__ = ("inputs", "outputs", "_replay", "launches")

    def __init__(self, inputs, outputs, replay, launches):
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self._replay = replay
        self.launches = dict(launches)

    def run(self, arrays: Sequence[np.ndarray]) -> tuple:
        """Copy the part's ``arrays`` into the static inputs (from pinned
        memory on the current stream), replay, count the launches; the
        static outputs, valid until the next replay on the stream."""
        for t, a in zip(self.inputs, arrays):
            src = torch.from_numpy(a)
            if t.device.type == "cuda":
                src = src.pin_memory()
            t.copy_(src, non_blocking=True)
        self._replay()
        for add, n in self.launches.items():
            add(n)
        return self.outputs


def capture(capturer: Capturer, fn, inputs: Sequence[torch.Tensor],
            device: torch.device, pool_key) -> PrefixGraph:
    """Capture ``fn(*static)`` with ``capturer`` on copies of ``inputs``
    (the warm run's device arrays), the copies becoming the graph's
    static inputs."""
    static = [t.clone() for t in inputs]
    outputs, replay, launches = capturer(fn, static, device, pool_key)
    return PrefixGraph(static, outputs, replay, launches)


class CudaCapturer:
    """Captures with ``torch.cuda.CUDAGraph``: per pool key (the engine's
    shard) one memory pool, and one side stream for the shard's worker,
    which serves on the legacy default stream, where no capture can
    run (the shards of a dp engine may share a device and capture at
    once)."""

    def __init__(self):
        self._pools: dict = {}
        self._streams: dict = {}

    def __call__(self, fn, inputs, device: torch.device, pool_key):
        cur = torch.cuda.current_stream(device)
        side = cur == torch.cuda.default_stream(device)
        if side:
            stream = self._streams.get(pool_key)
            if stream is None:
                stream = self._streams[pool_key] = torch.cuda.Stream(device)
        else:
            stream = cur
        pool = self._pools.get(pool_key)
        if pool is None:
            pool = self._pools[pool_key] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            if side:
                stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                if side:
                    # library handles and workspaces of a stream are made
                    # on its first use, which a capture must not be
                    fn(*inputs)
                with _build.capturing() as tally:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        outputs = fn(*inputs)
                    finally:
                        graph.capture_end()
            if side:
                cur.wait_stream(stream)
        return tuple(outputs), graph.replay, tally
