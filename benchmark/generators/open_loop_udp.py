"""Open-loop camera streams over loopback UDP, through the protocol server.

Mix parameters: ``cameras`` (from the cell), ``fps_per_camera``,
``jitter`` (each send's offset from its nominal time, uniform within
+- this share of the period), ``deadline_s`` (a frame with no answer
this long after it was due has failed), ``cameras_per_process``,
``warm_frames`` (per camera, answered before the window), ``threshold``.

Camera c's phase is ``(perm[c] + u_c) / cameras`` of a period (a seeded
permutation and a seeded offset, so every seed spreads the cameras
alike), and its frame k is due at ``phase + k * period`` plus its
jitter, for each nominal time inside the window. Frames take pool slots
in a seeded order. The cameras run in :mod:`benchmark.camera` processes
with no card visible; the server runs in this process.
"""

from __future__ import annotations

import json
import os
import select
import struct
import subprocess
import sys
import time
from typing import List, Tuple

import numpy as np

from benchmark import program, scenes
from benchmark.generators import Frame, Window


def schedule(seed: int, mix: dict, cameras: int, seconds: float,
             pool: int) -> List[List[Tuple[float, int]]]:
    """Per camera, its frames' ``(due offset s, pool slot)``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                        0x5CA1E]))
    period = 1.0 / float(mix["fps_per_camera"])
    jit = float(mix["jitter"])
    perm = rng.permutation(cameras)
    u = rng.random(cameras)
    slots = rng.permutation(pool)
    out: List[List[Tuple[float, int]]] = []
    for c in range(cameras):
        phase = (perm[c] + u[c]) / cameras * period
        k_max = int(np.ceil((seconds - phase) / period))
        offs = rng.uniform(-jit, jit, k_max) * period
        cam = []
        for k in range(k_max):
            due = min(max(phase + k * period + offs[k], 0.0), seconds)
            cam.append((float(due), int(slots[(c + k * cameras) % pool])))
        out.append(cam)
    return out


def _spawn(bench_dir: str, root: str, port: int, header: dict,
           blob: bytes) -> subprocess.Popen:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.Popen(
        [sys.executable, os.path.join(bench_dir, "camera.py"), "--port",
         str(port), "--path", program.PATH],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=root, env=env)
    h = json.dumps(header).encode()
    p.stdin.write(struct.pack(">I", len(h)) + h + blob)
    p.stdin.flush()
    return p


def _sleep_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def run(ctx) -> Window:
    mix = ctx.mix
    cameras = int(mix["cameras"])
    per = int(mix["cameras_per_process"])
    deadline = float(mix["deadline_s"])
    sched = schedule(ctx.seed, mix, cameras, ctx.seconds, len(ctx.jpegs))
    blob = scenes.pool_blob(ctx.jpegs)
    prof = ctx.start_trace()
    server = program.Server(ctx.svc)
    port = server.start()
    procs: List[subprocess.Popen] = []
    try:
        for i in range(0, cameras, per):
            header = {"cameras": [{"schedule": s} for s in sched[i:i + per]],
                      "threshold": float(mix["threshold"]),
                      "deadline_s": deadline,
                      "warm_frames": int(mix["warm_frames"])}
            procs.append(_spawn(ctx.bench_dir, ctx.root, port, header, blob))
        for p in procs:
            r, _, _ = select.select([p.stdout], [], [], 300)
            line = p.stdout.readline() if r else b""
            if line.strip() != b"ready":
                err = (p.stderr.read().decode()[-2000:]
                       if p.poll() is not None else "no answer")
                raise RuntimeError(f"a camera process did not start: {err}")
        t0 = time.monotonic() + 0.25
        t1 = t0 + ctx.seconds
        for p in procs:
            p.stdin.write(f"t0 {t0!r}\n".encode())
            p.stdin.flush()
        _sleep_until(t0)
        before = server.call(lambda: (program.reset_spans(),
                                      program.counters(ctx.svc))[1])
        ctx.mark_setup_end(t0)
        if prof is not None:
            _sleep_until(t1 - ctx.trace_seconds)
            prof.mark()
        _sleep_until(t1)
        ctx.mark_window_end()
        if prof is not None:
            prof.unmark()
        after = server.call(lambda: program.counters(ctx.svc))
        spans = server.call(program.spans)
        frames: List[Frame] = []
        for p in procs:
            out, err = p.communicate(timeout=ctx.seconds + deadline + 120)
            if p.returncode != 0:
                raise RuntimeError(f"a camera process failed "
                                   f"(rc={p.returncode}): "
                                   f"{err.decode()[-2000:]}")
            for (_, _, slot, due, sent, ans, msec, rec) in json.loads(
                    out.decode().strip().splitlines()[-1]):
                frames.append(Frame(slot, due, sent, ans, msec,
                                    None if rec is None
                                    else bytes.fromhex(rec)))
        trace = prof.finish() if prof is not None else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        server.stop()
    return Window(t0, t1, deadline, frames, before, after, spans, trace)
