"""Open-loop cameras in a process of their own (no card visible).

    python benchmark/camera.py --port P --path NAME   (input on stdin)

Started by the ``open_loop_udp`` generator. Standard input carries a
4-byte length, a JSON header (this process's cameras, each with its
schedule of ``[due offset s, pool slot]``, the threshold, the deadline,
the warm frames per camera) and the frame pool (:func:`scenes.pool_blob`).
The process opens one protocol session per camera, sends the warm
frames and waits for their answers, prints ``ready``, reads ``t0 <s>``
(``time.monotonic()`` of the window's start; the clock is shared by the
processes of one machine), then sends every frame at its due time
whatever the answers do, and listens until the last frame's deadline.
Its last line is a JSON list of frames: ``[camera, frame, slot, due,
sent, answered or null, msec or null, records hex or null]``, times in
``time.monotonic()`` seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import struct
import sys
import time


def _read_exact(fp, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = fp.read(n - len(buf))
        if not part:
            raise EOFError("input closed early")
        buf += part
    return buf


def read_input(fp):
    (n,) = struct.unpack(">I", _read_exact(fp, 4))
    header = json.loads(_read_exact(fp, n))
    (count,) = struct.unpack(">I", _read_exact(fp, 4))
    pool = []
    for _ in range(count):
        (m,) = struct.unpack(">I", _read_exact(fp, 4))
        pool.append(_read_exact(fp, m))
    return header, pool


def _send(session, reqid, thr, jpeg):
    while True:
        try:
            session.send(reqid, thr, jpeg)
            return
        except BlockingIOError:
            select.select([], [session.udp], [], 0.01)


def run(port: int, path: str, header: dict, pool, out, inp) -> None:
    from benchmark.wire import Session

    thr = float(header["threshold"])
    deadline = float(header["deadline_s"])
    cams = header["cameras"]
    sessions = [Session("127.0.0.1", port, path) for _ in cams]
    try:
        # warm frames: one at a time per camera, each answered
        nwarm = int(header["warm_frames"])
        for ci, s in enumerate(sessions):
            for k in range(nwarm):
                _send(s, k + 1, thr, pool[(ci + k) % len(pool)])
                t_end = time.monotonic() + 60.0
                got = False
                while not got and time.monotonic() < t_end:
                    select.select([s.udp], [], [], 0.05)
                    got = any(a[0] == k + 1 for a in s.receive())
                if not got:
                    raise RuntimeError(f"warm frame {k} of camera {ci} "
                                       f"got no answer")
        out.write("ready\n")
        out.flush()
        t0 = float(inp.readline().decode("ascii").split()[1])

        # (due, camera, frame, slot), sorted by due time
        events = sorted((t0 + float(d), ci, k, int(slot))
                        for ci, cam in enumerate(cams)
                        for k, (d, slot) in enumerate(cam["schedule"]))
        frames = {}
        by_sock = {s.udp.fileno(): ci for ci, s in enumerate(sessions)}
        last = events[-1][0] + deadline if events else t0
        i = 0
        while True:
            now = time.monotonic()
            while i < len(events) and events[i][0] <= now:
                due, ci, k, slot = events[i]
                reqid = nwarm + 1 + k
                _send(sessions[ci], reqid, thr, pool[slot])
                frames[(ci, reqid)] = [ci, k, slot, due, time.monotonic(),
                                       None, None, None]
                i += 1
                now = time.monotonic()
            if now >= last:
                break
            if i == len(events) and all(f[5] is not None
                                        for f in frames.values()):
                break
            wait = (events[i][0] if i < len(events) else last) - now
            ready, _, _ = select.select([s.udp for s in sessions], [], [],
                                        max(0.0, min(wait, 0.05)))
            for sock in ready:
                ci = by_sock[sock.fileno()]
                for reqid, msec, body in sessions[ci].receive():
                    t = time.monotonic()
                    f = frames.get((ci, reqid))
                    if f is not None and f[5] is None:
                        f[5], f[6], f[7] = t, msec, body.hex()
        out.write(json.dumps(list(frames.values())) + "\n")
        out.flush()
    finally:
        for s in sessions:
            s.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="camera")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--path", required=True)
    args = ap.parse_args(argv)
    header, pool = read_input(sys.stdin.buffer)
    run(args.port, args.path, header, pool, sys.stdout, sys.stdin.buffer)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
