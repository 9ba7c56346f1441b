"""A closed loop in process on the batcher, no sockets.

Mix parameters: ``outstanding`` (frames always in flight: each answer
is replaced at once), ``warm_frames`` (answered before the window),
``deadline_s`` (how long the frames still in flight when the window
closes are waited for), ``threshold``. Frames take pool slots in a
seeded order. ``due`` and ``sent`` of a frame are both its
``submit_nowait`` time.
"""

from __future__ import annotations

import asyncio
import time
from typing import List

import numpy as np

from benchmark import program
from benchmark.generators import Frame, Window


async def _drive(ctx, svc) -> Window:
    mix = ctx.mix
    outstanding = int(mix["outstanding"])
    thr = float(mix["threshold"])
    deadline = float(mix["deadline_s"])
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed % (1 << 64),
                                                        0xBA7C4]))
    order = rng.permutation(len(ctx.jpegs))
    frames: List[Frame] = []
    state = {"submitting": True, "open": 0, "answered": 0}
    drained = asyncio.Event()
    warmed = asyncio.Event()

    def submit() -> None:
        slot = int(order[len(frames) % len(order)])
        t = time.monotonic()
        f = Frame(slot, t, t)
        frames.append(f)
        state["open"] += 1
        svc.submit_nowait(ctx.jpegs[slot], thr).add_done_callback(
            lambda fut, f=f: done(fut, f))

    def done(fut, f: Frame) -> None:
        f.answered = time.monotonic()
        state["open"] -= 1
        state["answered"] += 1
        if fut.cancelled():
            f.error = "cancelled"
        elif fut.exception() is not None:
            f.error = repr(fut.exception())
        else:
            f.blob = fut.result()
        if state["answered"] >= int(mix["warm_frames"]):
            warmed.set()
        if state["submitting"]:
            submit()
        elif state["open"] == 0:
            drained.set()

    svc.start()
    try:
        for _ in range(outstanding):
            submit()
        await warmed.wait()
        t0 = time.monotonic()
        t1 = t0 + ctx.seconds
        program.reset_spans()
        before = program.counters(svc)
        ctx.mark_setup_end(t0)
        prof = ctx.trace_profiler
        if prof is not None:
            await asyncio.sleep(max(0.0, t1 - ctx.trace_seconds
                                    - time.monotonic()))
            prof.mark()
        await asyncio.sleep(max(0.0, t1 - time.monotonic()))
        state["submitting"] = False
        ctx.mark_window_end()
        after = program.counters(svc)
        spans = program.spans()
        if prof is not None:
            prof.unmark()
        if state["open"]:
            try:
                await asyncio.wait_for(drained.wait(), deadline)
            except asyncio.TimeoutError:
                pass
        trace = prof.finish() if prof is not None else None
    finally:
        svc.stop()
    # the window's frames: those in flight at t0 and those sent after it
    window = [f for f in frames
              if f.sent < t1 and (f.answered is None or f.answered >= t0)]
    return Window(t0, t1, deadline, window, before, after, spans, trace)


def run(ctx) -> Window:
    ctx.trace_profiler = ctx.start_trace()
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(_drive(ctx, ctx.svc))
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
