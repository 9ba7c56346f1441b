"""Decompose the serving-vs-batched throughput gap on the card.

    python -m fastdet_tpu_torch.tools.profile_serving [--frames 384]
        [--clients 8] [--window 4] [--profile] [--phases abc]

The port of the JAX package's ``tools/profile_serving.py``. On ONE warmed
int8 engine (the bench's model of :data:`ARCH`, :data:`BUCKETS`) it
measures the layers between the bench's batched number and its
multi-client number:

  A. engine batched   the bench's threaded producer (``bench._threaded_fps``,
                      3 batches in flight): the ceiling
  B. service direct   ``ModelService.submit`` from inside an event loop,
                      clients x window requests outstanding: the batcher
                      and its executor hops, no sockets
  C. sockets          a ``DetectionServer`` and ``--clients`` in-process
                      ``DetectClient`` threads, ``--window`` deep each

B and C report the realized average batch, which separates "the batcher
cannot fill buckets" (supply) from "the event loop burns CPU per frame"
(overhead). ``--profile`` runs cProfile on the event-loop thread during
C and prints the top 25 by cumulative time. Each event loop gets its own
fresh ``ModelService`` (a service's queue binds to the first loop that
waits on it). ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import pstats
import sys
import threading
import time

ARCH = ("full", 80)
BUCKETS = (1, 8, 16)       # the engine's batch buckets
PHASE_A_WARM_FRAMES = 32   # untimed frames before phase A
WARM_PER_CLIENT = 12       # untimed frames per client before phase C
STALL_S = 30.0             # a phase-C client with no answer this long fails


def build_engine(device="cuda"):
    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    spec, params, kind = bench.load_bench_model(*ARCH)
    eng = DetectionEngine(spec, params, mode="int8", buckets=BUCKETS,
                          calibration_images=bench.bench_calibration(),
                          device=device)
    t0 = time.time()
    eng.warmup()
    eng.wait_warm()   # every program warm, as the JAX warmup leaves it
    print(f"warmup: {time.time() - t0:.1f}s (weights={kind})")
    return eng


def phase_a(eng, frames):
    from fastdet_tpu_torch import bench

    jpegs = bench.make_jpegs(16)
    bsz = eng.max_batch

    def submit(i):
        bj = [jpegs[(i * bsz + j) % len(jpegs)] for j in range(bsz)]
        res = (eng.detect_async_sparse(bj, [0.3] * bsz)
               or eng.detect_async_planes(bj, [0.3] * bsz))
        if res is None:
            raise RuntimeError("the bench frames took no native route")
        return res

    bench._threaded_fps(eng, submit, max(1, PHASE_A_WARM_FRAMES // bsz),
                        bsz, 3)   # warm
    fps = bench._threaded_fps(eng, submit, frames // bsz, bsz, 3)
    print(f"A engine batched   : {fps:7.1f} f/s  (bucket={bsz}, inflight=3)")
    return fps


def _run_loop_thread(profile=False):
    """An asyncio loop running on a fresh thread; returns (loop, thread,
    profiler or None)."""
    loop = asyncio.new_event_loop()
    prof = cProfile.Profile() if profile else None

    def runner():
        asyncio.set_event_loop(loop)
        if prof is not None:
            prof.enable()
        loop.run_forever()
        if prof is not None:
            prof.disable()

    th = threading.Thread(target=runner, daemon=True, name="fd-prof-loop")
    th.start()
    return loop, th, prof


def phase_b(eng, frames, outstanding):
    """ModelService fed directly through submit (no sockets)."""
    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch.runtime.server import ModelService

    jpegs = bench.make_jpegs(16)
    svc = ModelService(eng, name="direct")
    loop, th, _ = _run_loop_thread()

    async def drive():
        svc.start()
        thr = 0.3
        sem = asyncio.Semaphore(outstanding)

        async def one(i):
            await svc.submit(jpegs[i % len(jpegs)], thr)
            sem.release()

        # warm pass
        for i in range(outstanding):
            await svc.submit(jpegs[i % len(jpegs)], thr)
        b0, f0 = svc.batches, svc.frames
        t0 = time.time()
        tasks = []
        for i in range(frames):
            await sem.acquire()
            tasks.append(asyncio.ensure_future(one(i)))
        await asyncio.gather(*tasks)
        wall = time.time() - t0
        ab = (svc.frames - f0) / max(1, svc.batches - b0)
        svc.stop()
        return frames / wall, ab

    fut = asyncio.run_coroutine_threadsafe(drive(), loop)
    try:
        fps, ab = fut.result(timeout=600)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=5)
    print(f"B service direct   : {fps:7.1f} f/s  (outstanding={outstanding}, "
          f"avg_batch={ab:.2f})")
    return fps


def phase_c(eng, frames, n_clients, window, profile=False):
    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch.runtime.client import DetectClient
    from fastdet_tpu_torch.runtime.server import DetectionServer, ModelService

    jpegs = bench.make_jpegs(16)
    svc = ModelService(eng, name="full")
    server = DetectionServer({"full": svc}, port=0, host="127.0.0.1")
    loop, th, prof = _run_loop_thread(profile=profile)
    serve = asyncio.run_coroutine_threadsafe(server.serve(), loop)
    deadline = time.time() + 60
    while server.bound_port is None:
        if serve.done() or time.time() > deadline:
            serve.result(timeout=0)   # the serve task's error, if any
            raise RuntimeError("the server did not start")
        time.sleep(0.01)

    per_client = frames // n_clients
    errs = []

    def client_task(ci, n_frames):
        try:
            c = DetectClient("127.0.0.1", server.bound_port, "full")
            c.open()
            try:
                sent = done = 0
                last = time.time()
                while done < n_frames:
                    while sent - done < window and sent < n_frames:
                        sent += 1
                        c.request(sent, 0.3,
                                  jpegs[(ci + sent) % len(jpegs)])
                    c.poll(0.02)
                    adv = False
                    while (done + 1) in c.responses:
                        done += 1
                        c.responses.pop(done)
                        adv = True
                    if adv:
                        last = time.time()
                    elif time.time() - last > STALL_S:
                        raise RuntimeError(f"client {ci} stalled at {done}")
            finally:
                c.close()
        except Exception as e:  # recorded in the phase's line
            errs.append(repr(e))

    try:
        for _phase, n in (("warm", WARM_PER_CLIENT), ("timed", per_client)):
            b0, f0 = svc.batches, svc.frames
            t0 = time.time()
            ts = [threading.Thread(target=client_task, args=(i, n))
                  for i in range(n_clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            wall = time.time() - t0
        ab = (svc.frames - f0) / max(1, svc.batches - b0)
        fps = n_clients * per_client / wall
        print(f"C sockets          : {fps:7.1f} f/s  (clients={n_clients}, "
              f"window={window}, avg_batch={ab:.2f}, errors={errs})")
    finally:
        # one callback: request_shutdown must run before the cancels
        loop.call_soon_threadsafe(
            lambda: (server.request_shutdown(),
                     [t.cancel() for t in asyncio.all_tasks(loop)]))
        time.sleep(0.3)
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=5)
    if prof is not None:
        st = pstats.Stats(prof, stream=sys.stdout)
        st.sort_stats("cumulative")
        print("\n--- event-loop thread profile (top 25 by cumulative) ---")
        st.print_stats(25)
    return fps


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "profile_serving")
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the event-loop thread during phase C")
    ap.add_argument("--phases", default="abc",
                    help="subset of phases to run, e.g. 'c'")
    args = ap.parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod

    print(bench.card_line(device_mod.resolve(device)))
    eng = build_engine(device)
    try:
        if "a" in args.phases:
            phase_a(eng, args.frames)
        if "b" in args.phases:
            phase_b(eng, args.frames, outstanding=args.clients * args.window)
        if "c" in args.phases:
            phase_c(eng, args.frames, args.clients, args.window,
                    profile=args.profile)
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
