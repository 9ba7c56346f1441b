"""Multi-client load generator, run as a process of its own.

    python -m fastdet_tpu_torch.tools.client_load --port P [--path full]
        [--clients 8] [--per-client 48] [--window 6] [--threshold 0.1]
        [jpeg files...]

The port of the JAX package's ``tools/client_load.py``. The protocol
clients (``runtime.client.DetectClient``, one thread each, ``--window``
requests in flight) run in their own interpreter, so their CPU time and
interpreter lock stay out of the server's number. Prints one JSON line:
``wall_s``, ``frames`` (answered), ``frames_requested``, ``fps`` (frames
answered over the wall: a stalled or failed client lowers it), ``p50_ms``
and ``p99_ms`` of the per-frame answer latency, and ``errors``. A client
that sees no answer for 30 s fails with "stalled". The files default to
testdata/scene1-3.jpg.

:func:`run_in_subprocess` starts it with no card visible
(``CUDA_VISIBLE_DEVICES=""``) for the bench and the saturation study.
It touches no tensor and takes no device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STALL_S = 30.0


def run_clients(port, path, fixtures, n_clients, per_client, window,
                threshold=0.1, stall_s=STALL_S):
    """Run ``n_clients`` pipelined clients of ``per_client`` frames each
    against 127.0.0.1:port; returns (wall s, frames answered, per-client
    latency lists in ms, errors)."""
    from fastdet_tpu_torch.runtime.client import DetectClient

    errs = []
    completed = [0] * n_clients   # frames answered, per client
    lat_ms = [[] for _ in range(n_clients)]

    def client_task(ci, n_frames):
        try:
            c = DetectClient("127.0.0.1", port, path)
            c.open()
            try:
                sent = done = 0
                sent_at = {}
                last = time.time()
                while done < n_frames:
                    while sent - done < window and sent < n_frames:
                        sent += 1
                        sent_at[sent] = time.time()
                        c.request(sent, threshold,
                                  fixtures[(ci + sent) % len(fixtures)])
                    c.poll(0.02)
                    adv = False
                    while (done + 1) in c.responses:
                        done += 1
                        c.responses.pop(done)
                        lat_ms[ci].append(
                            (time.time() - sent_at.pop(done)) * 1000.0)
                        completed[ci] = done
                        adv = True
                    if adv:
                        last = time.time()
                    elif time.time() - last > stall_s:
                        raise RuntimeError(
                            f"client {ci} stalled at {done}/{n_frames}")
            finally:
                c.close()
        except Exception as e:  # recorded in the output line
            errs.append(repr(e))

    t0 = time.time()
    ts = [threading.Thread(target=client_task, args=(i, per_client))
          for i in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.time() - t0, sum(completed), lat_ms, errs


def run_in_subprocess(port, *, path="full", clients, per_client, window,
                      threshold, timeout=900) -> dict:
    """Run this module in a separate process with no card visible against
    127.0.0.1:port; returns its JSON line, or {"error": ...} when the
    process fails or prints nothing."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""   # a protocol client needs no card
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "fastdet_tpu_torch.tools.client_load",
           "--port", str(port), "--path", path, "--clients", str(clients),
           "--per-client", str(per_client), "--window", str(window),
           "--threshold", str(threshold)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"error": f"client_load timed out after {timeout} s"}
    if proc.returncode != 0 or not proc.stdout.strip():
        return {"error": f"client_load rc={proc.returncode} "
                         f"stderr={proc.stderr.strip()[-400:]!r}"}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog=argv[0] if argv else "client_load")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--path", default="full")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--per-client", type=int, default=48)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv[1:])

    files = args.files or [
        os.path.join(REPO, "testdata", f"scene{i}.jpg") for i in (1, 2, 3)]
    fixtures = []
    for f in files:
        with open(f, "rb") as fp:
            fixtures.append(fp.read())
    wall, answered, lat_ms, errs = run_clients(
        args.port, args.path, fixtures, args.clients,
        args.per_client, args.window, args.threshold)
    flat = sorted(ms for per in lat_ms for ms in per)

    def pct(q):
        return (round(flat[min(len(flat) - 1, int(q * len(flat)))], 1)
                if flat else None)

    print(json.dumps({
        "wall_s": round(wall, 3),
        "frames": answered,
        "frames_requested": args.clients * args.per_client,
        "fps": round(answered / wall, 1) if wall > 0 else 0.0,
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
        "errors": errs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
