"""Probe whether host-to-card copies overlap compute on the card.

    python -m fastdet_tpu_torch.tools.probe_overlap [--mb 1.2] [--iters 30]
        [--flops-ms 11.0]

The port of the JAX package's ``tools/probe_overlap.py``. It times each
component of a serving batch and the composite, on the stream the
engine uses (the calling thread's current stream; no second stream):

  put    the engine's copy (``DetectionEngine._to_device``: a fresh
         pinned host copy, then a non-blocking copy) of an ``--mb``
         payload, synchronized each time (link MB/s)
  exec   a dummy compute on a resident operand, ``tanh(y @ x)`` in f32 at
         n = 2048 for a number of rounds calibrated to ``--flops-ms``
         (true float32: ``device.strict_fp32``)
  execp  the same, three in flight
  fetch  the result's first 12800 rows to the host (the JAX tool's
         slice: all 2048 rows, 16.8 MB)
  pipe   the engine's structure: this thread puts and launches a
         compute that reads the copied buffer, a consumer thread fetches
         each result. As in the JAX tool its semaphore is released
         right after each launch, so the depth of 3 is never enforced.

If pipe ~= put, the link is saturated; if pipe ~= put + exec, copies
serialize with compute. ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import functools
import sys
import threading
import time
from collections import deque

import numpy as np

N = 2048           # side of the dummy compute's square operand
MAX_ROUNDS = 512   # the calibration stops doubling past this


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "probe_overlap")
    ap.add_argument("--mb", type=float, default=1.2,
                    help="h2d payload per iteration (b24 sparse rows ~1.2)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--flops-ms", type=float, default=11.0,
                    help="target device compute per iter (b24 int8 ~11)")
    args = ap.parse_args(argv[1:])

    import torch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    dev = device_mod.resolve(device)
    device_mod.strict_fp32()
    print(bench.card_line(dev))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} device={name}")
    put = DetectionEngine._to_device

    sync = functools.partial(bench._sync, dev)

    class Done:
        """Completion of the work queued so far on the current stream."""

        def __init__(self, value):
            self.value = value
            self.event = None
            if dev.type == "cuda":
                self.event = torch.cuda.Event()
                self.event.record()

        def wait(self):
            if self.event is not None:
                self.event.synchronize()
            return self.value

    nbytes = int(args.mb * 1e6)
    host = [np.random.randint(0, 255, (nbytes,), np.uint8)
            for _ in range(4)]

    # compute sized to ~flops_ms: chained matmuls on a resident f32
    # operand (independent of the payload)
    a = torch.from_numpy(
        (np.random.randn(N, N).astype(np.float32) * 0.01)).to(dev)

    def work(x, rounds, s=None):
        y = x
        for _ in range(rounds):
            y = torch.tanh(y @ x if s is None else y @ x + s)
        return y

    with torch.inference_mode():
        r = 4
        while True:
            work(a, r)
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                work(a, r)
                sync()
            ms = (time.perf_counter() - t0) / 3 * 1e3
            if ms >= args.flops_ms or r > MAX_ROUNDS:
                break
            r *= 2
        print(f"compute: rounds={r} -> {ms:.2f} ms/iter")

        # --- put: sequential h2d
        put(host[0], dev)
        sync()
        t0 = time.perf_counter()
        for i in range(args.iters):
            put(host[i % 4], dev)
            sync()
        put_ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"put:   {put_ms:.2f} ms/iter "
              f"({nbytes / put_ms / 1e3:.1f} MB/s)")

        # --- exec: launch + compute on the resident operand
        t0 = time.perf_counter()
        for _ in range(args.iters):
            work(a, r)
            sync()
        exec_ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"exec:  {exec_ms:.2f} ms/iter (blocked each)")

        # exec-pipelined: keep 3 in flight (launch overhead hidden)
        q = deque()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            q.append(Done(work(a, r)))
            if len(q) > 3:
                q.popleft().wait()
        while q:
            q.popleft().wait()
        execp_ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"execp: {execp_ms:.2f} ms/iter (depth-3 queue)")

        # --- fetch: the JAX tool's res[:12800]
        res = work(a, r)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            res[:12800].cpu()
        fetch_ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"fetch: {fetch_ms:.2f} ms/iter (~100 KB d2h)")

        # --- pipe: put(i), then a compute that reads the copied buffer
        # (so it depends on the copy); a consumer thread fetches
        def work_dep(x, buf, rounds):
            s = buf[:8].to(torch.float32).sum() * 1e-9
            return work(x, rounds, s)

        work_dep(a, put(host[0], dev), r)
        sync()

        results = deque()
        lock = threading.Lock()
        done = threading.Event()
        errs = []

        def consumer():
            try:
                with torch.inference_mode():
                    fetched = 0
                    while fetched < args.iters:
                        with lock:
                            item = results.popleft() if results else None
                        if item is None:
                            time.sleep(0.0005)
                            continue
                        item[:12800].cpu()
                        fetched += 1
            except Exception as e:   # raised on the main thread below
                errs.append(e)
            finally:
                done.set()

        th = threading.Thread(target=consumer, name="fd-overlap-fetch")
        th.start()
        sem = threading.Semaphore(3)
        t0 = time.perf_counter()
        for i in range(args.iters):
            sem.acquire()
            buf = put(host[i % 4], dev)
            out = work_dep(a, buf, r)
            with lock:
                results.append(out)
            # the JAX tool releases at once: its depth of 3 is never held
            sem.release()
        done.wait()
        pipe_ms = (time.perf_counter() - t0) / args.iters * 1e3
        th.join()
        if errs:
            raise errs[0]
    print(f"pipe:  {pipe_ms:.2f} ms/iter "
          f"(put+exec+fetch pipelined; sum={put_ms + exec_ms + fetch_ms:.2f},"
          f" max={max(put_ms, exec_ms, fetch_ms):.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
