#!/usr/bin/env python3
"""Smoke run of fastdet_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path end to end and checks every kernel on it:

  0. device: card name, power limit, torch and nvcc versions;
  1. build: deletes the port's build directory, then builds the CUDA
     kernels (one nvcc call, sm_90a) and the host JPEG decoder
     (one c++ call) at once, and prints nvcc's -Xptxas -v lines (the
     CUDA kernels: B1, B2, D1, D2);
  2. kernel B1 (sparse coefficient reconstruction) against its plain
     PyTorch version on the card, on std (v6) and dense (v5) rows of
     every testdata/*.jpg and a zeroed row (all of them, and the first
     two), without and with the DC column, and five synthetic edge
     classes (max |diff| must be 0); then, on the rows the server sends
     through each tier at B = 1, 8 and 16, the same check, CUDA-event
     timings and the profiler's device time;
  3. kernel B2 (4:2:0 plane ingest) likewise on the fixtures' planes,
     on views of packed 259,588-byte rows at odd frames and at 32x34,
     timed at B = 1, 8 and 16;
  4. engine: the server's models (build_services, the server CLI's
     entry) on weights/detect80_full.npz in the default bf16 mode; one
     batch of the seven fixtures must hit the sparse, sparse_dense and
     planes tiers and launch both kernels; the net's input on each
     sparse dispatch must equal the same rows through reconstruct_plain
     and the DC lane as a separate pass; an f32 engine on the card is
     held against the same engine on the CPU on three fixtures;
  5. over the wire: a DetectionServer on 127.0.0.1 answers the seven
     fixtures sent by the port's DetectClient; each response must match
     the engine's own records. Launch counts are zeroed just before and
     read just after this run;
  6. kernels D1/D2 (B1's stages one by one): the kernel-debug tool
     (fastdet_tpu_torch.tools.debug_ingest) on its three cases, every
     stage equal to its plain version, launch counts zeroed just before
     and read just after; then at B = 8, NB = 4096 (bt = 128) D1 and D2
     against their plain versions, D1's nat against B1's output on the
     same rows, and their timings;
  7. int8: the server's int8 models (build_services, mode int8,
     calibrated on testdata/scene*.jpg, decoded by runtime.jpeg, whose
     decoder is printed): one batch of the seven fixtures
     through the sparse, dense and planes tiers, the same over loopback;
     on one fixture the int32 sums of every int8 conv through
     torch._int_mm equal the 4-bit split route, and the card's int8
     engine equals a CPU engine running its quantized parameters; int8 against
     bf16 (matched boxes, batch wall, device time) is printed;
  8. the coefficient path: the bf16 engine's detect_async_jpeg (host
     int16 coefficients, device decode420_batch) on scene1-3, batched and
     one at a time, must give the sparse route's records bit for bit
     (both reach the same coefficients; the sparse one through B1), and
     None for a 4:4:4 frame and a 224x224 frame; both routes' batch walls
     are printed;
  9. checkpoint forms: the checkpoint written as darknet .weights and as
     .onnx into a temporary directory, one bf16 service built from each
     (build_services, through cached_import); over loopback each answers
     the seven fixtures with the records of the .npz service in [5]; a
     second .weights load takes the .weights.npz cache;
 10. the held-out gate of tests/test_trained_detector80.py through the
     port's server, bf16 and int8: 48 held-out synthetic scenes (q90,
     threshold 0.2, one request at a time), at least 0.9 of the frames
     with every object matched, no frame on the pixel route, the modes
     disagreeing on at most 4 frames; frames ok, failing frames, objects
     matched, false positives and mAP@0.5 are printed;
 11. the client side: client_api.LocalDetector over the bf16 engine of
     [4] (its objects equal the engine's records mapped to UV),
     RemoteDetector and cli.client -n 3 against a loopback server of
     [5]'s model (the seven fixtures answered, none on the pixel route,
     B1 launched server-side, counted from the first frame),
     cli.detector (records equal to a bf16 engine's detect_one), cli.httpserver
     (200 echo, 404, zero-byte HEAD), cli.demo oneshot on the card into a
     temporary directory, cli.inspect_weights on the checkpoint (every
     conv, the total equal to the leaves' sizes);
 12. training at full width (full:80, 416x416): (a) one f32 step from the
     checkpoint at batch 2, dense and sparse loss, against the same step
     on the CPU and, tensor by tensor, against the step in float64; (b) 20 bf16 steps from synthetic weights on a fixed
     batch of 8 synthetic scenes with flips, whose loss must fall by 10 %;
     (c) step ms, images/s, peak memory and the share of the bf16 peak at
     batch 16 in f32 and bf16; (d) save -> restore gives the saved state
     (parameters, BN statistics, Adam moments) bit for bit, and one more
     step equals the uninterrupted run, and the export of a zero-step state serves the
     fixtures with [5]'s records byte for byte; (e) cli.train with a
     checkpoint and --resume, then 30 bf16 fine-tune steps and the gate
     of [10] on their export, printed and not checked;

then prints the card line, the kernels line and, last, the result line.
It exits nonzero with no result line when no CUDA card is present, when
run outside the repository, or when any phase fails. A watchdog ends a
hung run with every thread's stack.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import logging
import os
import subprocess
import sys
import threading
import time

WATCHDOG_S = 600           # whole run, build included
THR = 0.3                  # detection threshold of every request
IOU_MIN = 0.999            # box agreement between two runs of one frame
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of an H100 SXM (NVIDIA data sheet)
REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "weights", "detect80_full.npz")
FIXTURES = ("scene1.jpg", "scene2.jpg", "scene3.jpg", "adv_night.jpg",
            "adv_noise.jpg", "adv_texture.jpg", "adv_ui.jpg")


class SmokeFailure(RuntimeError):
    pass


def say(*args) -> None:
    print(*args, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------
# Phase 0 and 1
# --------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{name}, power limit not read (nvidia-smi rc {smi.returncode})"
    from fastdet_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=10)
    say(f"[0] device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}")
    say(f"[0] nvidia-smi: {card}")
    return name, card


def phase_build():
    from fastdet_tpu_torch.ops import _build

    t0 = time.time()
    _build.clean()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,), daemon=True)
               for fn in (_build.build_kernels, _build.build_fd_jpeg)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    expect(not any(t.is_alive() for t in threads), "build timed out")
    if errors:
        raise SmokeFailure(f"build failed: {errors[0]}")
    for line in _build.BUILD_LOG.get("fd_kernels", "").splitlines():
        if "ptxas" in line:
            say(f"[1] {line.strip()}")
    _build.kernels()  # load + bind
    say(f"[1] built fd_kernels and fd_jpeg in {time.time() - t0:.1f} s")


# --------------------------------------------------------------------------
# Phase 2: kernel B1
# --------------------------------------------------------------------------

def _fixture_bytes():
    import pathlib

    return {n: (pathlib.Path(REPO) / "testdata" / n).read_bytes()
            for n in FIXTURES}


def _stage_row(data: bytes, caps):
    """One frame's packed sparse row at ``caps`` (a truncated row when
    the frame overflows them) and whether it fit."""
    import numpy as np

    from fastdet_tpu_torch.runtime import engine as eng_mod
    from fastdet_tpu_torch.runtime import native_jpeg

    row = np.zeros((eng_mod.sparse_row_bytes(caps),), np.uint8)
    views = eng_mod.sparse_row_views(row, caps)
    decode = (native_jpeg.decode_sparse6_into if caps.fmt == 6
              else native_jpeg.decode_sparse5_into)
    try:
        decode(data, *views[:-1])
        fit = True
    except native_jpeg.SparseCapacityExceeded:
        fit = False
    return row, fit


def _b1_inputs(torch, rows, caps, dev):
    """((offs, maskstream, vals, esc8, esc16, sentinel), dc) on ``dev``
    for a stack of packed rows of one format: the engine's own unpack."""
    import numpy as np

    from fastdet_tpu_torch.ops import jpeg_device as jd
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import engine as eng_mod
    from fastdet_tpu_torch.runtime import native_jpeg

    packed = torch.from_numpy(np.stack(rows)).to(dev)
    bo = [0] + [int(v) for v in eng_mod.sparse_offsets(caps)]
    f = [packed[:, bo[i]:bo[i + 1]].contiguous() for i in range(len(bo) - 1)]
    yb, cb = native_jpeg.sparse_geometry(416, 416, 2, 2)
    if caps.fmt == 6:
        vals, sentinel = jd.unpack_3bit(f[3]), -4
        dc = jd.dc_reconstruct6(f[2], f[6].view(torch.int8),
                                f[7].view(torch.int16), yb, cb)
    else:
        vals, sentinel = jd.unpack_nibbles(f[3]), -8
        dc = jd.dc_reconstruct(f[2].view(torch.int8), f[6].view(torch.int16),
                               yb, cb)
    esc8 = f[4].view(torch.int8)
    esc16 = f[5].view(torch.int16)
    offs = si.stream_offsets(f[0], f[1], vals, esc8, caps.nb, sentinel)
    return (offs, f[1], vals.contiguous(), esc8, esc16, sentinel), dc


def _b1_moved_bytes(torch, offs, bt, nframes):
    """Bytes kernel B1 moves at tile ``bt`` on these offsets: each tile's
    staged offsets and its segments of the four streams (each at most its
    shared-memory share: 8 mask bytes, 32 values, 8 level-1 and 2 level-2
    escapes per block), the DC column and the int32 output. Window entries
    outside a staged segment, read from global memory, are not counted."""
    nb = offs.shape[2] - 1
    o = offs.long()
    j0 = torch.arange(0, nb, bt, device=offs.device)
    j1 = torch.clamp(j0 + bt, max=nb)

    def span(r, share, size):
        return size * int(torch.clamp(o[:, r, j1] - o[:, r, j0], 0,
                                      share * bt).sum())

    staged_offs = 4 * 4 * int((j1 - j0 + 1).sum()) * nframes
    return (staged_offs + span(0, 8, 1) + span(1, 32, 4) + span(2, 8, 1)
            + span(3, 2, 2) + nframes * nb * (4 + 256))


def _edge_case(np, rng, nb, esc1_p, esc2_p, max_nnz, nib_cap):
    """A synthetic v5 row (plen, maskstream, nib, esc8, esc16) with the
    given escape rates: the case classes no camera frame reaches (dense
    escapes, int16 escapes out to +-32767, near-full blocks)."""
    mcap, e8cap, e16cap = 8 * nb, 64 * nb, 32 * nb
    plen = np.zeros(((nb + 1) // 2,), np.uint8)
    ms = np.zeros((mcap,), np.uint8)
    nib = np.zeros((nib_cap,), np.uint8)
    esc8 = np.zeros((e8cap,), np.int8)
    esc16 = np.zeros((e16cap,), np.int16)
    nac = ne8 = ne16 = nmask = 0
    for n in range(nb):
        nnz = rng.randint(0, max_nnz + 1)
        zzmask = 0
        b8 = b16 = 0
        for j in np.sort(rng.choice(63, nnz, replace=False) + 1):
            zzmask |= 1 << int(j)
            r = rng.rand()
            if r < esc2_p and b16 < 16 and b8 < 32:
                v = -8
                esc8[ne8] = -128
                esc16[ne16] = rng.choice([1, -1]) * rng.choice(
                    [32767, rng.randint(300, 32767)])
                ne8, ne16, b8, b16 = ne8 + 1, ne16 + 1, b8 + 1, b16 + 1
            elif r < esc1_p and b8 < 32:
                v = -8
                esc8[ne8] = rng.randint(8, 128) * rng.choice([-1, 1])
                ne8, b8 = ne8 + 1, b8 + 1
            else:
                v = rng.randint(-7, 8)
            if nac // 2 < nib_cap:
                nib[nac >> 1] |= (v & 0xF) << (4 * (nac & 1))
            nac += 1
        pl = (zzmask.bit_length() + 7) // 8
        plen[n >> 1] |= pl << (4 * (n & 1))
        ms[nmask:nmask + pl] = np.frombuffer(
            zzmask.to_bytes(8, "little")[:pl], np.uint8)
        nmask += pl
    return plen, ms, nib, esc8, esc16


def _time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, kernel, iters=20):
    """Mean device time of ``kernel`` per call of ``fn`` from a
    torch.profiler trace of the card, or None when the trace holds no
    device time for it (the profiler's CUPTI tracing is optional here)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        say(f"    (profiler unavailable: {e})")
        return None
    total = sum(getattr(ev, "device_time_total", 0.0)
                for ev in prof.key_averages() if kernel in ev.key)
    return total / iters / 1e3 if total > 0 else None


def _where_time_goes(torch, fn, tag="[4]"):
    """Device time by kernel over one call of ``fn``: prints the top
    entries and the card's busy share of the wall time; returns (busy
    ms, wall ms) or None when the profiler is unavailable."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    except (RuntimeError, AssertionError) as e:
        say(f"{tag} profile not measured (profiler unavailable: {e})")
        return None
    evs = [ev for ev in prof.key_averages()
           if getattr(ev, "device_time_total", 0.0) > 0
           and getattr(ev, "device_type", None) is not None
           and "CUDA" in str(ev.device_type)]
    busy_ms = sum(ev.device_time_total for ev in evs) / 1e3
    say(f"{tag} profile of one batch: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(ev.count for ev in evs)} kernel launches")
    for ev in sorted(evs, key=lambda e: -e.device_time_total)[:8]:
        say(f"{tag}   {ev.device_time_total / 1e3:9.3f} ms  x{ev.count:<5d} "
            f"{ev.key[:90]}")
    return busy_ms, wall_ms


def _b1_diff(torch, si, args, dc):
    """max |kernel - plain| of B1 on ``args`` without and with ``dc``."""
    want = si.reconstruct_plain(*args)
    diff = max(int((si.reconstruct(*args, dc=d) - w).abs().max().item())
               for d, w in ((None, want), (dc, si._with_dc(want, dc))))
    torch.cuda.synchronize()
    return diff


def phase_b1(torch, fixtures):
    import numpy as np

    from fastdet_tpu_torch.ops import jpeg_device as jd
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import engine as eng_mod

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    budgets = eng_mod.sparse_budgets()
    worst = 0
    cases = 0
    served, std_fit = {}, set()
    for tier in ("std", "dense"):
        caps = eng_mod.sparse_caps(416, (2, 2), budgets["fmt"][tier],
                                   budgets[tier])
        rows, fits = [], []
        for name, data in fixtures.items():
            row, fit = _stage_row(data, caps)
            rows.append(row)
            fits.append(fit)
        rows.append(np.zeros_like(rows[0]))     # zeroed row
        # the rows the server sends through B1 at this tier: the frames
        # that fit it (the dense tier gets those that overflowed std)
        names = [n for n, f in zip(fixtures, fits)
                 if f and n not in std_fit]
        if tier == "std":
            std_fit = set(names)
        served[tier] = (caps, names, [r for n, r in zip(fixtures, rows)
                                      if n in names])
        args, dc = _b1_inputs(torch, rows, caps, dev)
        diff = _b1_diff(torch, si, args, dc)
        # two rows: the tile the server's bucket 2 gets
        args2, dc2 = _b1_inputs(torch, rows[:2], caps, dev)
        diff2 = _b1_diff(torch, si, args2, dc2)
        worst = max(worst, diff, diff2)
        cases += 2 * len(rows) + 4
        say(f"[2] B1 {tier} (v{caps.fmt}): {len(rows)} rows "
            f"({sum(fits)} fit, {len(fits) - sum(fits)} truncated, 1 "
            f"zeroed), tile {si.tile(len(rows), caps.nb, sms)}, without "
            f"and with dc: max |kernel - plain| = {diff}; the first two "
            f"rows, tile {si.tile(2, caps.nb, sms)}: {diff2}")
    rng = np.random.RandomState(13)
    nb = 4056
    for name, kw in (
        ("no-esc small-nnz", dict(esc1_p=0.0, esc2_p=0.0, max_nnz=8)),
        ("no-esc", dict(esc1_p=0.0, esc2_p=0.0, max_nnz=19)),
        ("esc8", dict(esc1_p=0.25, esc2_p=0.0, max_nnz=19)),
        ("esc16 +-32k", dict(esc1_p=0.25, esc2_p=0.08, max_nnz=19)),
        ("dense nnz", dict(esc1_p=0.25, esc2_p=0.08, max_nnz=60)),
    ):
        plen, ms, nib, e8, e16 = _edge_case(np, rng, nb, nib_cap=32 * nb,
                                            **kw)
        t = [torch.from_numpy(a[None]).to(dev)
             for a in (plen, ms, nib, e8, e16)]
        vals = jd.unpack_nibbles(t[2]).contiguous()
        offs = si.stream_offsets(t[0], t[1], vals, t[3], nb, -8)
        args = (offs, t[1], vals, t[3], t[4], -8)
        diff = int((si.reconstruct(*args) - si.reconstruct_plain(*args))
                   .abs().max().item())
        worst = max(worst, diff)
        cases += 1
        say(f"[2] B1 edge case {name}: max |kernel - plain| = {diff}")
    expect(worst == 0, f"B1 disagrees with its plain version: {worst}")

    res = {"max_abs_err": worst, "cases": cases}
    for tier in ("std", "dense"):
        caps, names, frames = served[tier]
        timing, dev_ms, tiles, moved = {}, {}, {}, {}
        for b in (1, 8, 16):
            rows = [frames[i % len(frames)] for i in range(b)]
            args, dc = _b1_inputs(torch, rows, caps, dev)
            diff = _b1_diff(torch, si, args, dc)
            expect(diff == 0, f"B1 {tier} B={b} disagrees: {diff}")
            tiles[b] = si.tile(b, caps.nb, sms)
            moved[b] = _b1_moved_bytes(torch, args[0], tiles[b], b)
            timing[b] = (
                _time_ms(torch, lambda: si.reconstruct(*args, dc=dc)),
                _time_ms(torch, lambda: si.reconstruct_plain(*args, dc=dc),
                         iters=5),
                # rows in + int32 coefficients out + the DC column in
                (b * eng_mod.sparse_row_bytes(caps) + b * caps.nb * 64 * 4
                 + b * caps.nb * 4) / H100_BYTES_PER_S * 1e3)
            dev_ms[b] = _device_ms(torch, lambda: si.reconstruct(
                *args, dc=dc), "sparse_tile_kernel")
            moved_ms = moved[b] / H100_BYTES_PER_S * 1e3
            say(f"[2] B1 {tier} B={b} ({', '.join(names)} cycled): tile "
                f"{tiles[b]}, max |kernel - plain| = {diff}; kernel "
                f"{timing[b][0]:.4f} ms, device {dev_ms[b]} ms (profiler), "
                f"plain {timing[b][1]:.4f} ms, bound {timing[b][2]:.6f} ms "
                f"(bytes); moves {moved[b]} B ({moved_ms:.6f} ms at 3.35 "
                f"TB/s)")
        if tier == "std":
            res.update(timing=timing, device_ms=dev_ms[8],
                       device_ms_by_b=dev_ms, tiles=tiles, moved_bytes=moved)
        else:
            res.update(dense_device_ms_by_b=dev_ms,
                       dense_bound_ms_by_b={b: t[2]
                                            for b, t in timing.items()})
    return res


# --------------------------------------------------------------------------
# Phase 3: kernel B2
# --------------------------------------------------------------------------

def phase_b2(torch, fixtures):
    import numpy as np

    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.runtime import native_jpeg

    dev = torch.device("cuda", 0)
    planes = []
    for name, data in fixtures.items():
        y = np.empty((416, 416), np.uint8)
        cb = np.empty((208, 208), np.uint8)
        cr = np.empty((208, 208), np.uint8)
        native_jpeg.decode_planes_into(data, y, cb, cr)
        planes.append((y, cb, cr))

    def stack(idx):
        return [torch.from_numpy(np.stack([planes[i][k] for i in idx]))
                .to(dev) for k in range(3)]

    y, cb, cr = stack(range(len(planes)))
    diff = float((plane_ingest.plane_ingest_batch(y, cb, cr)
                  - plane_ingest.plane_ingest_plain(y, cb, cr))
                 .abs().max().item())
    say(f"[3] B2 on {len(planes)} fixtures' planes: max |kernel - plain| "
        f"= {diff}")
    # the planes tier's packed rows (259,588 B: frame b starts at 4*b mod
    # 16), cut at odd frames, and a width that is not a multiple of 4
    packed = torch.cat([y.flatten(1), cb.flatten(1), cr.flatten(1),
                        torch.zeros_like(y.flatten(1)[:, :4])], 1)
    yb, cw = 416 * 416, 208 * 208
    views = (packed[1::2, :yb].view(-1, 416, 416),
             packed[1::2, yb:yb + cw].view(-1, 208, 208),
             packed[1::2, yb + cw:yb + 2 * cw].view(-1, 208, 208))
    d_odd = float((plane_ingest.plane_ingest_batch(*views)
                   - plane_ingest.plane_ingest_plain(*views))
                  .abs().max().item())
    narrow = (y[:, :32, :34].contiguous(), cb[:, :16, :17].contiguous(),
              cr[:, :16, :17].contiguous())
    d_narrow = float((plane_ingest.plane_ingest_batch(*narrow)
                      - plane_ingest.plane_ingest_plain(*narrow))
                     .abs().max().item())
    say(f"[3] B2 on packed {packed.shape[1]}-B rows at odd frames: max "
        f"|kernel - plain| = {d_odd}; at 32x34: {d_narrow}")
    diff = max(diff, d_odd, d_narrow)
    expect(diff == 0.0, f"B2 disagrees with its plain version: {diff}")
    timing, dev_ms = {}, {}
    for b in (1, 8, 16):
        y, cb, cr = stack([i % len(planes) for i in range(b)])
        timing[b] = (
            _time_ms(torch, lambda: plane_ingest.plane_ingest_batch(
                y, cb, cr)),
            _time_ms(torch, lambda: plane_ingest.plane_ingest_plain(
                y, cb, cr), iters=5),
            # uint8 planes in + f32 NHWC out
            b * (416 * 416 * 3 // 2 + 416 * 416 * 3 * 4)
            / H100_BYTES_PER_S * 1e3)
        say(f"[3] B2 B={b}: kernel {timing[b][0]:.4f} ms, plain "
            f"{timing[b][1]:.4f} ms, bound {timing[b][2]:.4f} ms (bytes)")
        dev_ms[b] = _device_ms(
            torch, lambda: plane_ingest.plane_ingest_batch(y, cb, cr),
            "plane_ingest_kernel")
        say(f"[3] B2 B={b}: device time per launch (profiler) {dev_ms[b]} ms")
    return {"max_abs_err": diff, "timing": timing, "device_ms": dev_ms[8],
            "device_ms_by_b": dev_ms}


# --------------------------------------------------------------------------
# Phase 6: kernels D1 and D2 (B1's stages, the kernel-debug path)
# --------------------------------------------------------------------------

def _stage_read_bytes(torch, s, nb, gated):
    """Bytes D1 (``gated`` False) or D2 must read from these streams: the
    mask entries up to moffx[NB], the value entries up to probe[NB] or as
    far as a staged tile segment reaches (D1 stages every tile's bt*32
    values, D2 only those of tiles on its fast route), the block offsets,
    and for D2 the escape offsets at the tile boundaries. The padding
    past the content is read only where a segment reaches into it."""
    bt, t2 = s.bt, s.bt * 32
    mo, po = s.moffx.long(), s.probe.long()
    s0 = po[:, 0:nb:bt]
    seg_end = torch.clamp(s0 + t2, max=s.vals32.shape[1])
    if gated:
        seg_end = torch.where(po[:, bt::bt] - s0 <= t2, seg_end, 0)
    v_end = torch.maximum(po[:, nb], seg_end.amax(1))
    entries = int(mo[:, nb].sum()) + int(v_end.sum()) + 2 * po.numel()
    if gated:
        entries += po.shape[0] * (nb // bt + 1)
    return 4 * entries


def phase_stages(torch):
    import numpy as np

    from fastdet_tpu_torch.ops import ingest_stages as st
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.tools import debug_ingest

    dev = torch.device("cuda", 0)
    st.LAUNCHES.update(D1=0, D2=0)
    with torch.inference_mode():
        cases = debug_ingest.run(dev, prefix="[6] ")
    torch.cuda.synchronize()
    launches = dict(st.LAUNCHES)
    say(f"[6] debug tool: {len(cases)} cases, launches {launches}")
    expect(all(c["ok"] for c in cases),
           f"a D1/D2 stage disagrees with its plain version: {cases}")
    expect(launches["D1"] > 0 and launches["D2"] > 0,
           f"a kernel was not launched on the debug path: {launches}")
    worst = max(c["max_abs_err"] for c in cases)

    # the engine's scale: B = 8 frames of NB = 4096 blocks, bt = 128
    b, nb = 8, 4096
    rows = st.build_case(np.random.RandomState(13), b, nb, 0.0, 0.0,
                         MCAP=8 * nb, NCAPB=10 * nb)
    plen, ms, _, nib, esc8, esc16, _ = (torch.from_numpy(a).to(dev)
                                        for a in rows)
    s = st.prepare_streams(plen, ms, nib, nb)
    args = (s.ms32, s.vals32, s.moffx, s.probe)
    expect(s.bt == 128, f"bt {s.bt} at NB={nb}")
    got = st.stages(*args, s.bt)
    d1_diff = max(int((g - w).abs().max().item())
                  for g, w in zip(got, st.stages_plain(*args, s.bt)))
    d2_diff = int((st.nat_gated(*args, s.eoff1, s.bt)
                   - st.nat_gated_plain(*args, s.eoff1, s.bt))
                  .abs().max().item())
    offs = si.stream_offsets(plen, ms, s.vals, esc8, nb, -8)
    b1_diff = int((got.nat - si.reconstruct(offs, ms, s.vals, esc8, esc16,
                                            -8)).abs().max().item())
    say(f"[6] B={b} NB={nb} bt={s.bt}: max |D1 - plain| = {d1_diff}, "
        f"max |D2 - plain| = {d2_diff}, max |D1 nat - B1| = {b1_diff}")
    expect(d1_diff == 0 and d2_diff == 0 and b1_diff == 0,
           f"D1/D2 at B={b}: {d1_diff}, {d2_diff}, vs B1 {b1_diff}")

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    res = {}
    for key, fn, plain, kernel, out_bytes in (
        ("D1", lambda: st.stages(*args, s.bt),
         lambda: st.stages_plain(*args, s.bt), "ingest_stages_kernel",
         nbytes(got)),
        ("D2", lambda: st.nat_gated(*args, s.eoff1, s.bt),
         lambda: st.nat_gated_plain(*args, s.eoff1, s.bt),
         "nat_gated_kernel", nbytes([got.nat])),
    ):
        in_bytes = _stage_read_bytes(torch, s, nb, gated=key == "D2")
        timing = (_time_ms(torch, fn), _time_ms(torch, plain, iters=5),
                  (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3)
        dev_ms = _device_ms(torch, fn, kernel)
        say(f"[6] {key} B={b}: kernel {timing[0]:.4f} ms, device "
            f"{dev_ms} ms (profiler), plain {timing[1]:.4f} ms, bound "
            f"{timing[2]:.4f} ms (bytes: {in_bytes} in, {out_bytes} out)")
        res[key] = {"max_abs_err": max(worst, d1_diff if key == "D1"
                                       else d2_diff),
                    "timing": {8: timing}, "device_ms": dev_ms}
    res["launches"] = launches
    return res


# --------------------------------------------------------------------------
# Phase 4 and 5: engine and server
# --------------------------------------------------------------------------

def _records(blob: bytes):
    """Wire record bytes -> [(klass, conf u8, x, y, w, h)]."""
    import struct

    return [struct.unpack(">BBhhhh", blob[i:i + 10])
            for i in range(0, len(blob), 10)]


def _iou(a, b) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    iw = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
    ih = max(0.0, min(ay + ah, by + bh) - max(ay, by))
    inter = iw * ih
    union = aw * ah + bw * bh - inter
    return 1.0 if union <= 0 else inter / union


def _same_records(a, b, what):
    """Two runs' results for one frame: same count and classes, boxes
    at IoU >= IOU_MIN. ``a``/``b`` are (klass, conf, x, y, w, h) lists."""
    expect(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} detections")
    for ra, rb in zip(a, b):
        expect(ra[0] == rb[0], f"{what}: class {ra[0]} vs {rb[0]}")
        iou = _iou(ra[2:], rb[2:])
        expect(iou >= IOU_MIN, f"{what}: IoU {iou:.5f} < {IOU_MIN}")


def _sparse_input_check(torch, eng, jpegs):
    """One engine batch of ``jpegs``: the net's input on each sparse
    dispatch (kernel B1 writing the DC column) against the same packed
    rows through reconstruct_plain + _with_dc (the DC lane as a separate
    pass). Returns (max |diff|, sparse dispatches)."""
    from fastdet_tpu_torch.ops import sparse_ingest as si

    seen = []
    pipe, tail = eng._pipeline_sparse, eng._postprocess_tail

    def capture_pipe(packed, layout=(2, 2), tier="std"):
        seen.append({"args": (packed.clone(), layout, tier)})
        return pipe(packed, layout, tier)

    def capture_tail(x, thresholds):
        if seen and "x" not in seen[-1]:
            seen[-1]["x"] = x.clone()
        return tail(x, thresholds)

    def plain(offs, ms, vals, esc8, esc16, sentinel, dc=None):
        return si._with_dc(
            si.reconstruct_plain(offs, ms, vals, esc8, esc16, sentinel), dc)

    eng._pipeline_sparse, eng._postprocess_tail = capture_pipe, capture_tail
    try:
        eng.fetch_wire(eng.detect_async_sparse(jpegs, [THR] * len(jpegs)),
                       len(jpegs))
    finally:
        del eng._pipeline_sparse, eng._postprocess_tail
    kernel, si.reconstruct = si.reconstruct, plain
    eng._postprocess_tail = lambda x, thr: x
    try:
        diff = 0.0
        for d in seen:
            want = eng._pipeline_sparse(*d["args"])
            diff = max(diff, float((d["x"] - want).abs().max().item()))
    finally:
        si.reconstruct = kernel
        del eng._postprocess_tail
    torch.cuda.synchronize()
    return diff, len(seen)


def phase_engine(torch, fixtures, services):
    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    eng = services["full"].engine
    names = list(fixtures)
    jpegs = [fixtures[n] for n in names]
    si.LAUNCHES = plane_ingest.LAUNCHES = 0
    t0 = time.time()
    res = eng.detect_async_sparse(jpegs, [THR] * len(jpegs))
    expect(res is not None and not res.unresolved,
           "fixtures fell off the native ingest")
    wire = eng.fetch_wire(res, len(jpegs))
    dt = time.time() - t0
    counts = dict(res.counts)
    if "planes" not in counts:
        sub = eng.detect_async_planes(jpegs[:1], [THR])
        eng.fetch_wire(sub, 1)
        counts["planes(direct)"] = 1
    launches = (si.LAUNCHES, plane_ingest.LAUNCHES)
    say(f"[4] engine bf16 batch of {len(jpegs)}: tiers {counts}, "
        f"{[len(w) // 10 for w in wire]} detections, {dt * 1e3:.1f} ms "
        f"host wall; launches B1 {launches[0]}, B2 {launches[1]}")
    for tier in ("sparse", "sparse_dense"):
        expect(tier in counts, f"no fixture rode the {tier} tier")
    expect(launches[0] > 0 and launches[1] > 0,
           f"a kernel was not launched on the engine path: {launches}")
    for n, w in zip(names, wire):
        recs = _records(w)
        expect(all(0 < r[0] <= 80 and r[4] > 0 and r[5] > 0 for r in recs),
               f"{n}: malformed records {recs[:3]}")
    engine_records = {n: _records(w) for n, w in zip(names, wire)}
    eng._tier_hint.clear()
    diff, n_sparse = _sparse_input_check(torch, eng, jpegs)
    say(f"[4] sparse-path net input of {n_sparse} sparse batches (B1 with "
        f"the DC column) vs reconstruct_plain + _with_dc: max |diff| = "
        f"{diff}")
    expect(n_sparse > 0 and diff == 0.0,
           f"the engine's sparse input differs from the plain route: {diff}")
    eng._tier_hint.clear()
    _where_time_goes(torch, lambda: eng.fetch_wire(eng.detect_async_sparse(
        jpegs, [THR] * len(jpegs)), len(jpegs)))
    eng._tier_hint.clear()

    # f32 on the card against f32 on the CPU (true f32 on both: TF32 off)
    spec, params = weights.load_model(WEIGHTS)
    cuda32 = DetectionEngine(spec, params, mode="f32", buckets=(1,))
    cpu32 = DetectionEngine(spec, params, mode="f32", buckets=(1,),
                            device="cpu")
    try:
        for n in names[:2] + names[4:5]:
            got = []
            for e in (cuda32, cpu32):
                e._tier_hint.clear()
                r = e.detect_async_sparse([fixtures[n]], [THR])
                got.append(e.fetch(r, 1)[0])
            _same_records(got[0], got[1], f"{n} f32 card vs CPU")
            say(f"[4] {n}: f32 card == f32 CPU ({len(got[0])} detections, "
                f"first classes {[g[0] for g in got[0]][:8]})")
    finally:
        cuda32.close()
        cpu32.close()
    return engine_records


@contextlib.contextmanager
def _serving(services):
    """A DetectionServer for ``services`` on 127.0.0.1 in a thread;
    yields its port, and stops and joins it on exit (the engines stay
    open: their owner closes them)."""
    import asyncio

    from fastdet_tpu_torch.runtime.server import DetectionServer

    server = DetectionServer(services, port=0, host="127.0.0.1")
    state = {}
    ready = threading.Event()

    def serve():
        loop = asyncio.new_event_loop()
        state["loop"] = loop
        ev = asyncio.Event()

        async def main():
            task = asyncio.ensure_future(server.serve(ev))
            state["task"] = task
            await ev.wait()
            ready.set()
            try:
                await task
            except asyncio.CancelledError:
                pass

        try:
            loop.run_until_complete(main())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            loop.close()

    thread = threading.Thread(target=serve, daemon=True, name="smoke-server")
    thread.start()
    try:
        expect(ready.wait(30), "server did not start")
        yield server.bound_port
    finally:
        loop = state.get("loop")
        if loop is not None and "task" in state:
            # one callback: after request_shutdown the serve task may end
            # and the loop close before a second call could be scheduled
            task = state["task"]
            loop.call_soon_threadsafe(
                lambda: (server.request_shutdown(), task.cancel()))
        thread.join(30)
    expect(not thread.is_alive(), "server thread did not stop")


def _ask(port, path, frames, thr=THR, one_at_a_time=False):
    """Send ``frames`` {name: jpeg} over loopback with the port's
    DetectClient -> ({name: response records}, wall seconds)."""
    from fastdet_tpu_torch.runtime.client import DetectClient

    client = DetectClient("127.0.0.1", port, path=path)
    names = list(frames)
    t0 = time.time()
    try:
        client.open(timeout=10)
        if one_at_a_time:
            replies = {}
            for i, n in enumerate(names):
                client.request(i + 1, thr, frames[n])
                replies[n] = client.wait_response(i + 1, timeout=60)[1]
        else:
            for i, n in enumerate(names):
                client.request(i + 1, thr, frames[n])
            replies = {n: client.wait_response(i + 1, timeout=30)[1]
                       for i, n in enumerate(names)}
    finally:
        client.close()
    return replies, time.time() - t0


def phase_server(torch, fixtures, services, engine_records, tag="[5]"):
    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si

    si.LAUNCHES = plane_ingest.LAUNCHES = 0
    with _serving(services) as port:
        replies, dt = _ask(port, "full", fixtures)
    launches = {"B1": si.LAUNCHES, "B2": plane_ingest.LAUNCHES}
    for n, recs in replies.items():
        _same_records(recs, engine_records[n], f"{n} server vs engine")
    svc = services["full"]
    say(f"{tag} server: {len(replies)} requests answered in {dt * 1e3:.1f} "
        f"ms; every response matches the engine; ingest {svc.ingest}, "
        f"batches {svc.batch_hist}; launches {launches}")
    expect(launches["B1"] > 0 and launches["B2"] > 0,
           f"a kernel was not launched on the served path: {launches}")
    return launches, replies


# --------------------------------------------------------------------------
# Phase 7: int8 serving
# --------------------------------------------------------------------------

def _batch_walls(eng, jpegs, reps=3):
    """Host wall ms of ``reps`` engine batches of ``jpegs`` (tier memory
    cleared before each, so every batch routes as the first did)."""
    walls = []
    for _ in range(reps):
        eng._tier_hint.clear()
        t0 = time.perf_counter()
        eng.fetch_wire(eng.detect_async_sparse(jpegs, [THR] * len(jpegs)),
                       len(jpegs))
        walls.append((time.perf_counter() - t0) * 1e3)
    eng._tier_hint.clear()
    return walls


def _agreement(a, b):
    """Boxes of ``a`` matched by a box of ``b`` of the same class at IoU
    >= 0.5, and the count of ``a``."""
    hit = 0
    for ra in a:
        hit += any(rb[0] == ra[0] and _iou(ra[2:], rb[2:]) >= 0.5
                   for rb in b)
    return hit, len(a)


def phase_int8(torch, fixtures, bf16_services, bf16_records):
    import numpy as np

    from fastdet_tpu_torch.models import quantize, yolov3
    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import jpeg as jpeg_mod
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import build_services

    scenes = sorted(n for n in fixtures if n.startswith("scene"))
    calib = np.stack([jpeg_mod.decode_rgb(fixtures[n]) for n in scenes])
    say(f"[7] calibration frames decoded by {jpeg_mod.LAST_DECODER} "
        f"(FASTDET_JPEG_BACKEND={jpeg_mod._BACKEND})")
    t0 = time.time()
    services = build_services([f"full:80:{WEIGHTS}"], mode="int8",
                              buckets=(8,), calibration_images=calib)
    eng = services["full"].engine
    say(f"[7] build_services(full:80, int8, bucket 8) with warmup: "
        f"{time.time() - t0:.1f} s; calibration on {len(scenes)} scenes "
        f"{eng.calibration_s * 1e3:.1f} ms")
    try:
        expect(isinstance(eng.net, quantize.Int8Net), "not an int8 net")
        expect(isinstance(eng.spec.layers[0], yolov3.SpaceToDepth),
               "the int8 engine did not rewrite its stem")
        names = list(fixtures)
        jpegs = [fixtures[n] for n in names]
        si.LAUNCHES = plane_ingest.LAUNCHES = 0
        eng._tier_hint.clear()
        t0 = time.time()
        res = eng.detect_async_sparse(jpegs, [THR] * len(jpegs))
        expect(res is not None and not res.unresolved,
               "fixtures fell off the native ingest")
        wire = eng.fetch_wire(res, len(jpegs))
        dt = time.time() - t0
        launches = (si.LAUNCHES, plane_ingest.LAUNCHES)
        counts = dict(res.counts)
        say(f"[7] engine int8 batch of {len(jpegs)}: tiers {counts}, "
            f"{[len(w) // 10 for w in wire]} detections, {dt * 1e3:.1f} ms "
            f"host wall; launches B1 {launches[0]}, B2 {launches[1]}")
        for tier in ("sparse", "sparse_dense", "planes"):
            expect(tier in counts, f"int8: no fixture rode the {tier} tier")
        expect(launches[0] > 0 and launches[1] > 0,
               f"a kernel was not launched on the int8 path: {launches}")
        records = {n: _records(w) for n, w in zip(names, wire)}
        for n, recs in records.items():
            expect(all(0 < r[0] <= 80 and r[4] > 0 and r[5] > 0
                       for r in recs), f"{n}: malformed records {recs[:3]}")
        eng._tier_hint.clear()
        phase_server(torch, fixtures, services, records, tag="[7]")

        # every int8 conv of one fixture: _int_mm == 4-bit split
        net = eng.net
        w_q = {n: torch.from_numpy(p["w_q"]).to(eng.device)
               for n, p in eng.qparams.items() if "w_q" in p}
        img = jpeg_mod.decode_rgb(fixtures[scenes[0]])
        x = torch.from_numpy(img[None]).to(eng.device).float() * (1.0 / 255.0)
        diffs = []
        route = net.accumulate

        def checking(xq, l):
            got = route(xq, l)
            want = quantize.conv_int8_split(xq, w_q[l.name], l.stride,
                                            l.pad)
            diffs.append(int((got - want).abs().max().item()))
            return got

        net.accumulate = checking
        try:
            with torch.inference_mode():
                net(x)
        finally:
            del net.accumulate
        torch.cuda.synchronize()
        say(f"[7] {scenes[0]}: {len(diffs)} int8 convs, max |_int_mm - "
            f"4-bit split| = {max(diffs)}")
        expect(len(diffs) == len(w_q) and max(diffs) == 0,
               f"_int_mm and the split route disagree: {diffs}")

        # the card's int8 engine == a CPU engine running the same
        # quantized parameters (its own f32 net replaced)
        spec, params = weights.load_model(WEIGHTS)
        cpu8 = DetectionEngine(spec, params, mode="f32", buckets=(1,),
                               device="cpu")
        try:
            expect(cpu8.spec == eng.spec, "the CPU engine's graph differs")
            cpu8.net = quantize.Int8Net(cpu8.spec, eng.qparams,
                                        device="cpu").eval()
            n = scenes[0]
            got = []
            for e in (eng, cpu8):
                e._tier_hint.clear()
                got.append(e.fetch(e.detect_async_sparse(
                    [fixtures[n]], [THR]), 1)[0])
            _same_records(got[0], got[1], f"{n} int8 card vs CPU")
            say(f"[7] {n}: int8 card == int8 CPU ({len(got[0])} detections)")
        finally:
            cpu8.close()

        # int8 against bf16 on the same batch (information, not gates)
        hit = tot = 0
        for n in names:
            h, t = _agreement(bf16_records[n], records[n])
            hit, tot = hit + h, tot + t
        say(f"[7] int8 vs bf16: {hit} of {tot} bf16 boxes matched by an "
            f"int8 box (same class, IoU >= 0.5)")
        bf16 = bf16_services["full"].engine
        walls = {"bf16": _batch_walls(bf16, jpegs),
                 "int8": _batch_walls(eng, jpegs)}
        for mode, w in walls.items():
            say(f"[7] {mode} batch of {len(jpegs)}: host wall ms "
                f"{[round(v, 3) for v in w]}")
        for mode, e in (("bf16", bf16), ("int8", eng)):
            _where_time_goes(torch, lambda: e.fetch_wire(
                e.detect_async_sparse(jpegs, [THR] * len(jpegs)),
                len(jpegs)), tag=f"[7] {mode}")
            e._tier_hint.clear()
    finally:
        for svc in services.values():
            svc.engine.close()


# --------------------------------------------------------------------------
# Phase 8: the coefficient path
# --------------------------------------------------------------------------

def _encode_444(img):
    """A 4:4:4 JPEG (chroma not subsampled) of ``img``: OpenCV where it
    takes a sampling factor, else PIL."""
    import io

    try:
        import cv2

        ok, buf = cv2.imencode(
            ".jpg", img[:, :, ::-1],
            [int(cv2.IMWRITE_JPEG_QUALITY), 90,
             int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR),
             int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)])
        expect(ok, "cv2 could not encode a 4:4:4 frame")
        return bytes(buf)
    except (ImportError, AttributeError):
        from PIL import Image

        out = io.BytesIO()
        Image.fromarray(img).save(out, format="JPEG", quality=90,
                                  subsampling=0)
        return out.getvalue()


def phase_coeffs(torch, fixtures, services):
    """The bf16 server engine's coefficient route (detect_async_jpeg:
    host coefficients, device decode420_batch) against its sparse route
    (B1) on the camera-clean fixtures: the same records, bit for bit."""
    import numpy as np

    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import jpeg as jpeg_mod
    from fastdet_tpu_torch.runtime import native_jpeg

    eng = services["full"].engine
    names = sorted(n for n in fixtures if n.startswith("scene"))
    jpegs = [fixtures[n] for n in names]
    walls = {"sparse": [], "coeffs": []}

    def run(route, batch):
        eng._tier_hint.clear()
        thr = [THR] * len(batch)
        t0 = time.perf_counter()
        if route == "sparse":
            res = eng.detect_async_sparse(batch, thr)
            expect(res is not None and res.counts == {"sparse": len(batch)},
                   f"scenes left the std tier: {res and res.counts}")
        else:
            res = eng.detect_async_jpeg(batch, thr)
            expect(res is not None, "detect_async_jpeg refused the scenes")
        wire = eng.fetch_wire(res, len(batch))
        return wire, (time.perf_counter() - t0) * 1e3

    si.LAUNCHES = 0
    for rep in range(3):   # alternate which route runs first
        order = ("sparse", "coeffs") if rep % 2 == 0 else ("coeffs", "sparse")
        got = {}
        for route in order:
            got[route], ms = run(route, jpegs)
            walls[route].append(ms)
        expect(got["coeffs"] == got["sparse"],
               "batch: coefficient-route records differ from the sparse "
               "route's")
    b1_launches = si.LAUNCHES
    for n, d in zip(names, jpegs):
        one = {r: run(r, [d])[0] for r in ("sparse", "coeffs")}
        expect(one["coeffs"] == one["sparse"],
               f"{n}: coefficient-route records differ from the sparse "
               f"route's")
    eng._tier_hint.clear()
    dets = [len(w) // 10 for w in got["coeffs"]]
    say(f"[8] detect_async_jpeg == detect_async_sparse bit for bit on "
        f"{names} (bf16, batch of {len(names)} and one at a time; "
        f"{dets} detections)")
    for route, w in walls.items():
        say(f"[8] {route} route, batch of {len(names)} (bucket "
            f"{eng.bucket_for(len(names))}): host wall ms "
            f"{[round(v, 3) for v in w]}")
    say(f"[8] B1 launches over the 3 sparse batches: {b1_launches}")

    img = jpeg_mod.decode_rgb(fixtures[names[0]])
    f444 = _encode_444(img)
    ci = native_jpeg.decode_coefficients(f444)
    expect(not ci.is_420, "the 4:4:4 probe came out 4:2:0")
    small = jpeg_mod.encode_rgb(np.ascontiguousarray(img[:224, :224]))
    expect(eng.detect_async_jpeg([f444], [THR]) is None,
           "detect_async_jpeg took a 4:4:4 frame")
    expect(eng.detect_async_jpeg([small], [THR]) is None,
           "detect_async_jpeg took a 224x224 frame")
    say(f"[8] detect_async_jpeg returns None for a 4:4:4 frame (sampling "
        f"{ci.hmax}x{ci.vmax}) and for a 224x224 frame")


# --------------------------------------------------------------------------
# Phase 9: checkpoint forms
# --------------------------------------------------------------------------

def _same_params(a, b) -> bool:
    """Two unfolded parameter trees hold the same arrays."""
    import numpy as np

    if a.keys() != b.keys():
        return False
    for name, ea in a.items():
        eb = b[name]
        if ea.keys() != eb.keys():
            return False
        for k, v in ea.items():
            pairs = ([(v[kk], eb[k][kk]) for kk in v] if isinstance(v, dict)
                     else [(v, eb[k])])
            if not all(np.array_equal(x, y) for x, y in pairs):
                return False
    return True


def phase_checkpoints(torch, fixtures, npz_replies):
    """weights/detect80_full.npz written as darknet .weights and as .onnx
    (into a temporary directory) and served by one bf16 service each:
    their responses to the seven fixtures must equal the .npz service's
    ([5]) record for record. A second load of the .weights file must
    take the .weights.npz cache."""
    import shutil
    import tempfile

    from fastdet_tpu_torch.models import onnx_io, weights
    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.parallel import checkpoint
    from fastdet_tpu_torch.runtime.server import build_services

    tmp = tempfile.mkdtemp(prefix="fastdet-ckpt-")
    parses = []
    real_parse, real_import = weights.parse_darknet_bytes, \
        checkpoint.cached_import
    loads = {}

    def counting_parse(raw, spec):
        parses.append(spec.name)
        return real_parse(raw, spec)

    def timed_import(path, *a, **k):
        t0 = time.perf_counter()
        out = real_import(path, *a, **k)
        loads.setdefault(path, []).append(time.perf_counter() - t0)
        return out

    weights.parse_darknet_bytes = counting_parse
    checkpoint.cached_import = timed_import
    try:
        spec, params = weights.load_model(WEIGHTS)
        paths = {"darknet": os.path.join(tmp, "detect80_full.weights"),
                 "onnx": os.path.join(tmp, "detect80_full.onnx")}
        t0 = time.perf_counter()
        weights.save_darknet(paths["darknet"], spec, params)
        t1 = time.perf_counter()
        onnx_io.save_onnx(paths["onnx"], spec, params)
        t2 = time.perf_counter()
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        say(f"[9] wrote {sizes} bytes: save_darknet {t1 - t0:.3f} s, "
            f"save_onnx {t2 - t1:.3f} s")
        for form, path in paths.items():
            services = build_services([f"full:80:{path}"], buckets=(8,))
            try:
                with _serving(services) as port:
                    si.LAUNCHES = plane_ingest.LAUNCHES = 0
                    replies, dt = _ask(port, "full", fixtures)
            finally:
                services["full"].engine.close()
            launches = {"B1": si.LAUNCHES, "B2": plane_ingest.LAUNCHES}
            for n, recs in replies.items():
                expect(recs == npz_replies[n],
                       f"[9] {form}: {n} response differs from the .npz "
                       f"service's: {recs[:3]} vs {npz_replies[n][:3]}")
            say(f"[9] {form}: build_services(full:80:{os.path.basename(path)}"
                f") loaded in {loads[path][0]:.3f} s; {len(replies)} responses "
                f"over loopback equal the .npz service's record for record "
                f"({sum(len(r) for r in replies.values())} records, "
                f"{dt * 1e3:.1f} ms); launches {launches}")
            expect(launches["B1"] > 0, f"[9] {form}: B1 was not launched")
        first = len(parses)
        expect(first > 0 and os.path.exists(paths["darknet"] + ".npz"),
               "the first .weights load wrote no .weights.npz cache")
        _, again = checkpoint.cached_import(paths["darknet"], num_classes=80)
        expect(len(parses) == first,
               "the second .weights load parsed the darknet file again")
        expect(_same_params(again, params),
               "the .weights.npz cache holds other arrays than the .npz")
        dk = loads[paths["darknet"]]
        say(f"[9] .weights loads: first {dk[0]:.3f} s ({first} darknet "
            f"parses, tiny tried first; cache written), second "
            f"{dk[1]:.3f} s from the .weights.npz cache (0 parses); its "
            f"arrays equal the .npz's")
    finally:
        weights.parse_darknet_bytes = real_parse
        checkpoint.cached_import = real_import
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Phase 10: the held-out gate
# --------------------------------------------------------------------------

GATE_SEEDS = range(230100, 230148)     # held out from training (200000+)
GATE_CALIB_SEEDS = range(240500, 240506)
GATE_THR = 0.2
GATE_RATE = 0.9
# the frames the CPU engines of both packages fail, in bf16 and int8
GATE_CPU_FAILING = [9, 10, 11, 13]


def _gate_frames():
    """The gate's 48 held-out scenes as q90 JPEGs, with their boxes and
    labels, and its int8 calibration scenes."""
    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.runtime import jpeg as jpeg_mod

    imgs, boxes, labels = synth.make_dataset(GATE_SEEDS, num_classes=80)
    frames = {i: jpeg_mod.encode_rgb(im, quality=90)
              for i, im in enumerate(imgs)}
    calib = synth.make_dataset(GATE_CALIB_SEEDS, num_classes=80)[0]
    return frames, boxes, labels, calib


def _gate_run(torch, weights_path, mode, gate, tag="[10]"):
    """One service of ``weights_path`` in ``mode`` answers the gate's
    frames over loopback, one request at a time; prints and returns
    {"ok": per-frame bool, "matched", "total", "ingest", "launches"}."""
    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.ops import metrics, plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime.server import build_services

    frames, boxes, labels, calib = gate
    t0 = time.perf_counter()
    services = build_services(
        [f"full:80:{weights_path}"], mode=mode, buckets=(1, 2),
        calibration_images=calib if mode == "int8" else None)
    svc = services["full"]
    build_s = time.perf_counter() - t0
    try:
        si.LAUNCHES = plane_ingest.LAUNCHES = 0
        with _serving(services) as port:
            replies, dt = _ask(port, "full", frames, thr=GATE_THR,
                               one_at_a_time=True)
        launches = {"B1": si.LAUNCHES, "B2": plane_ingest.LAUNCHES}
    finally:
        svc.engine.close()
    dets = [[(k, c / 255.0, x, y, w, h) for (k, c, x, y, w, h)
             in replies[i]] for i in range(len(frames))]
    ok, matched, total, fps = [], 0, 0, 0
    for d, bx, lb in zip(dets, boxes, labels):
        m, t, fp = synth.match_detections(d, bx, lb)
        ok.append(m == t)
        matched, total, fps = matched + m, total + t, fps + fp
    ev = metrics.evaluate_detections(dets, boxes, labels, 80)
    failing = [i for i, o in enumerate(ok) if not o]
    say(f"{tag} {mode}: {sum(ok)}/{len(ok)} frames ok "
        f"({sum(ok) / len(ok):.4f}, bar {GATE_RATE}); objects "
        f"{matched}/{total}; false positives {fps}; mAP@0.5 "
        f"{float(ev['map'][0.5])!r}; ingest {svc.ingest}; batches "
        f"{svc.batch_hist}; launches {launches}")
    say(f"{tag} {mode}: failing frames {failing} (seeds "
        f"{[GATE_SEEDS[i] for i in failing]}; the CPU engines fail "
        f"{GATE_CPU_FAILING}); {len(frames)} requests in "
        f"{dt:.2f} s; build_services {build_s:.2f} s, calibration "
        f"{svc.engine.calibration_s:.3f} s")
    return {"ok": ok, "matched": matched, "total": total,
            "ingest": dict(svc.ingest), "launches": launches}


def phase_gate(torch):
    """tests/test_trained_detector80.py's gate through the port's server
    on the card: 48 held-out scenes, q90 JPEGs, one request at a time at
    threshold 0.2; a frame is ok when every planted object is matched.
    In bf16 and int8, at least 0.9 of the frames are ok and none takes
    the pixel route; the modes disagree on at most max(1, 48 // 10).
    Returns the frames and the frames ok per mode."""
    t0 = time.perf_counter()
    gate = _gate_frames()
    frames = gate[0]
    say(f"[10] {len(frames)} held-out scenes (seeds {GATE_SEEDS.start}-"
        f"{GATE_SEEDS.stop - 1}) and {len(gate[3])} calibration scenes made "
        f"and encoded in {time.perf_counter() - t0:.2f} s")
    ok_by_mode = {}
    for mode in ("bf16", "int8"):
        r = _gate_run(torch, WEIGHTS, mode, gate)
        ok = ok_by_mode[mode] = r["ok"]
        expect(r["ingest"]["pixels"] == 0,
               f"[10] {mode}: frames took the pixel route: {r['ingest']}")
        expect(r["launches"]["B1"] > 0, f"[10] {mode}: B1 was not launched")
        expect(sum(ok) >= GATE_RATE * len(ok),
               f"[10] {mode}: only {sum(ok)}/{len(ok)} held-out frames "
               f"fully localized ({r['matched']}/{r['total']} objects)")
    diff = [i for i, (a, b) in enumerate(zip(ok_by_mode["bf16"],
                                             ok_by_mode["int8"])) if a != b]
    say(f"[10] bf16 and int8 disagree on {len(diff)} frames {diff} "
        f"(limit {max(1, len(frames) // 10)})")
    expect(len(diff) <= max(1, len(frames) // 10),
           f"[10] bf16 and int8 disagree on {len(diff)} frames")
    return gate, {m: sum(ok) for m, ok in ok_by_mode.items()}


# --------------------------------------------------------------------------
# Phase 11: the client side on the card
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _diag_server():
    """cli.httpserver's DiagServer on a free port of 127.0.0.1 in a
    thread; yields the port, and cancels and joins it on exit."""
    import asyncio

    from fastdet_tpu_torch.cli import httpserver

    srv = httpserver.DiagServer(host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(srv.serve())
        except asyncio.CancelledError:
            pass

    thread = threading.Thread(target=run, daemon=True, name="smoke-diag")
    thread.start()
    try:
        deadline = time.time() + 10
        while srv.bound_port is None and time.time() < deadline:
            time.sleep(0.01)
        expect(srv.bound_port is not None, "httpserver did not start")
        yield srv.bound_port
    finally:
        loop.call_soon_threadsafe(
            lambda: [t.cancel() for t in asyncio.all_tasks(loop)])
        thread.join(10)
    expect(not thread.is_alive(), "httpserver thread did not stop")
    loop.close()


def _captured(fn, *args, **kw):
    """(fn's return value, what it printed to stdout)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


def phase_client(torch, fixtures, services):
    """The client API and the CLIs on the card: LocalDetector over the
    bf16 engine of [4] (objects equal the engine's records mapped to UV),
    RemoteDetector and cli.client -n 3 against a loopback server of
    [5]'s model (answers for the seven fixtures, B1 launched server-side),
    cli.detector (records equal to a bf16 engine's detect_one), cli.httpserver
    (200 / 404 / zero-byte HEAD), cli.demo oneshot local into a temporary
    directory, cli.inspect_weights on the checkpoint (75 convs, the
    total equal to the leaves' sizes)."""
    import ast
    import re
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np

    from fastdet_tpu_torch import client_api
    from fastdet_tpu_torch.cli import client as client_cli
    from fastdet_tpu_torch.cli import demo, detector, inspect_weights
    from fastdet_tpu_torch.models import weights
    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import jpeg as jpeg_mod
    from fastdet_tpu_torch.runtime.engine import DetectionEngine
    from fastdet_tpu_torch.runtime.server import build_services

    eng = services["full"].engine
    scenes = sorted(n for n in fixtures if n.startswith("scene"))
    scene_paths = [os.path.join(REPO, "testdata", n) for n in scenes]
    imgs = [jpeg_mod.decode_rgb(fixtures[n]) for n in scenes]

    # LocalDetector: one engine batch of the three letterboxed scenes
    det = client_api.LocalDetector(eng)
    got = {}
    det.on_result = lambda r: got.__setitem__(r.request_id, r)
    t0 = time.perf_counter()
    ids = [det.process_image(im, threshold=THR) for im in imgs]
    while det.num_pending_requests:
        det.update()
    local_ms = (time.perf_counter() - t0) * 1e3
    want = eng.detect([client_api.letterbox(im) for im in imgs],
                      [THR] * len(imgs))
    size = client_api.IMAGE_SIZE
    for n, i, recs in zip(scenes, ids, want):
        objs = [(o.klass, o.conf, o.bbox) for o in got[i].objects]
        expect(objs == [(k, c, (0.0 + (x / size) * 1.0, 0.0 + (y / size)
                                * 1.0, (w / size) * 1.0, (h / size) * 1.0))
                        for k, c, x, y, w, h in recs],
               f"[11] LocalDetector {n}: objects differ from the engine's "
               f"records")
    say(f"[11] LocalDetector (bf16 engine of [4], bucket 8): {scenes} -> "
        f"{[len(got[i].objects) for i in ids]} objects, equal to the "
        f"engine's detect records mapped to UV; {local_ms:.1f} ms for the "
        f"three")

    # RemoteDetector and cli.client -n 3 against a loopback server of the
    # same model as [5]'s (a ModelService's queue belongs to the event
    # loop that first served it, so [5]'s services are not served again)
    remote = {}
    remote_services = build_services([f"full:80:{WEIGHTS}"], buckets=(8,))
    svc = remote_services["full"]
    try:
        with _serving(remote_services) as port:
            det = client_api.RemoteDetector(f"rtsp://127.0.0.1:{port}/full")
            det.on_result = lambda r: remote.__setitem__(r.request_id, r)
            # counted from here: build_services' warm-up launched B1 too
            si.LAUNCHES = plane_ingest.LAUNCHES = 0
            try:
                t0 = time.perf_counter()
                for data in fixtures.values():
                    det.process_image(jpeg_mod.decode_rgb(data),
                                      threshold=THR)
                deadline = time.time() + 30
                while len(remote) < len(fixtures) and time.time() < deadline:
                    det.update()
                    time.sleep(0.002)
                remote_ms = (time.perf_counter() - t0) * 1e3
            finally:
                det.close()
            launches = {"B1": si.LAUNCHES, "B2": plane_ingest.LAUNCHES}
            ingest = dict(svc.ingest)
            rc = client_cli.main(["client", "-t", "0.01", "-n", "3",
                                  f"rtsp://127.0.0.1:{port}/full",
                                  scene_paths[0]])
        served = sum(svc.batch_hist.values())
    finally:
        svc.engine.close()
    expect(sorted(remote) == list(range(1, len(fixtures) + 1)),
           f"[11] RemoteDetector: answers for {sorted(remote)}")
    sparse = sum(v for k, v in ingest.items() if k.startswith("sparse"))
    expect(ingest["pixels"] == 0 and sparse > 0
           and sparse + ingest["planes"] == len(fixtures),
           f"[11] RemoteDetector: the frames' routes {ingest}")
    expect(launches["B1"] > 0 and (launches["B2"] > 0) == (
        ingest["planes"] > 0),
        f"[11] RemoteDetector: launches {launches} for routes {ingest}")
    expect(rc == 0, f"[11] cli.client returned {rc}")
    say(f"[11] RemoteDetector over loopback: {len(remote)} fixtures "
        f"answered in {remote_ms:.1f} ms "
        f"({[len(r.objects) for _, r in sorted(remote.items())]} objects); "
        f"server-side ingest {ingest}, launches {launches} (counted from "
        f"the first frame); then cli.client -n 3 exited 0 ({served} "
        f"batches served in all)")

    # cli.detector against a bf16 engine's detect_one
    t0 = time.perf_counter()
    rc, out = _captured(detector.main, ["detector", "-t", str(THR),
                                        WEIGHTS] + scene_paths)
    cli_s = time.perf_counter() - t0
    expect(rc == 0, f"[11] cli.detector returned {rc}")
    lines = out.strip().splitlines()
    expect(len(lines) == len(scenes), f"[11] cli.detector printed {out!r}")
    spec, params = weights.load_model(WEIGHTS)
    ref = DetectionEngine(spec, params, buckets=(1,))
    try:
        walls = []
        for n, im, line in zip(scenes, imgs, lines):
            dt, _, rest = line.partition(" ")
            walls.append(float(dt))
            expect(ast.literal_eval(rest) == ref.detect_one(im, THR),
                   f"[11] cli.detector {n}: records differ from "
                   f"detect_one's")
    finally:
        ref.close()
    say(f"[11] cli.detector (bf16, bucket 1 warmed): records equal "
        f"detect_one's on {scenes}; printed walls {walls} s; the whole "
        f"CLI {cli_s:.2f} s")

    # cli.httpserver
    with _diag_server() as port:
        base = f"http://127.0.0.1:{port}"
        body = urllib.request.urlopen(base + "/", timeout=10).read()
        expect(body.startswith(b"('GET / HTTP/1.1'"),
               f"[11] httpserver GET /: {body[:80]!r}")
        try:
            urllib.request.urlopen(base + "/nope", timeout=10)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        expect(code == 404, f"[11] httpserver GET /nope: {code}")
        import socket

        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            c.sendall(b"HEAD / HTTP/1.1\r\nHost: x\r\n\r\n")
            head = c.recv(1024)
        expect(head == b"", f"[11] httpserver HEAD answered {head!r}")
    say("[11] cli.httpserver: GET / 200 echo, 404, HEAD zero bytes")

    # cli.demo oneshot, local mode, into a temporary directory
    tmp = tempfile.mkdtemp(prefix="fastdet-demo-")
    try:
        t0 = time.perf_counter()
        rc = demo.main(["demo", "-w", WEIGHTS, "-c", "80", "-o", tmp]
                       + scene_paths)
        demo_s = time.perf_counter() - t0
        expect(rc == 0, f"[11] cli.demo returned {rc}")
        drawn = 0
        for n, im in zip(scenes, imgs):
            path = os.path.join(tmp, n)
            expect(os.path.exists(path), f"[11] cli.demo wrote no {n}")
            out_img = jpeg_mod.decode_rgb(open(path, "rb").read())
            expect(out_img.shape == im.shape, f"[11] cli.demo {n} shape")
            drawn += bool(np.abs(out_img.astype(int) - im.astype(int))
                          .max() > 100)
        expect(drawn > 0, "[11] cli.demo drew no box")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[11] cli.demo oneshot local (bf16): {len(scenes)} annotated "
        f"images written, {drawn} with boxes drawn, {demo_s:.2f} s")

    # cli.inspect_weights on the checkpoint
    rc, out = _captured(inspect_weights.main, ["inspect_weights", WEIGHTS])
    expect(rc == 0, f"[11] cli.inspect_weights returned {rc}")
    convs = {m.group(1) for m in re.finditer(r"^(conv\d+)/", out, re.M)}
    total = re.search(r"^# total parameters: ([\d,]+)$", out, re.M)
    leaves = sum(np.asarray(v).size for p in params.values()
                 for v in ([p["w"]] + ([p["b"]] if "b" in p else [])
                           + list(p.get("bn", {}).values())))
    expect(len(convs) == len(spec.conv_specs()),
           f"[11] inspect_weights: {len(convs)} convs")
    expect(total is not None
           and int(total.group(1).replace(",", "")) == leaves,
           f"[11] inspect_weights total {total and total.group(1)} vs "
           f"{leaves}")
    say(f"[11] cli.inspect_weights: {len(convs)} convs, '# total "
        f"parameters: {total.group(1)}' = the leaves' sizes; "
        f"{len(out.splitlines())} lines")


# --------------------------------------------------------------------------
# Phase 12: training on the card
# --------------------------------------------------------------------------

TRAIN_SEEDS = 200000                   # training scenes (the gate's are
                                       # held out: 230100+)
H100_BF16_FLOPS = 989e12               # dense bf16 peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12                 # float32 outside the tensor cores


def _train_scenes(torch, seeds, dev):
    """Synthetic 80-class scenes through a q90 JPEG round trip, as the
    committed checkpoints were trained: (images (B, 416, 416, 3) f32 in
    [0, 1] on ``dev``, boxes, labels)."""
    import numpy as np

    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.runtime import jpeg as jpeg_mod

    imgs, boxes, labels = synth.make_dataset(seeds, num_classes=80)
    imgs = np.stack([jpeg_mod.decode_rgb(jpeg_mod.encode_rgb(im, 90))
                     for im in imgs]).astype(np.float32) / 255.0
    return torch.from_numpy(imgs).to(dev), boxes, labels


def _conv_macs(spec) -> int:
    """Multiply-accumulates of one image's forward, from the spec: per
    conv, output cells x k x k x in x out."""
    from fastdet_tpu_torch.models import yolov3

    size, sizes, macs = spec.image_size, [], 0
    io = iter(yolov3.conv_io_channels(spec))
    for l in spec.layers:
        if isinstance(l, yolov3.Conv):
            cin, cout, k = next(io)
            size //= l.stride
            macs += size * size * k * k * cin * cout
        elif isinstance(l, yolov3.MaxPool) and l.stride > 1:
            size //= l.stride
        elif isinstance(l, yolov3.Upsample):
            size *= 2
        elif isinstance(l, yolov3.Route):
            size = sizes[l.sources[0]]
        sizes.append(size)
    return macs


def _flipped(torch, train, x, slots, rng, grids):
    """A random horizontal / vertical flip per image of NHWC ``x`` and
    the matching slot transform (train.flip_slots)."""
    dev = x.device
    fh = torch.from_numpy(rng.rand(x.shape[0]) < 0.5).to(dev)
    fv = torch.from_numpy(rng.rand(x.shape[0]) < 0.5).to(dev)
    x = torch.where(fh[:, None, None, None], x.flip(2), x)
    x = torch.where(fv[:, None, None, None], x.flip(1), x)
    return x, train.flip_slots(slots, fh, fv, grids)


def _state_diff(torch, a, b):
    """Names of what differs between two TrainStates: the net's
    parameters and buffers, the optimizer's state and groups, the step."""
    sa, sb = a.net.state_dict(), b.net.state_dict()
    out = [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    if oa["param_groups"] != ob["param_groups"]:
        out.append("param_groups")
    for i in sorted(set(oa["state"]) | set(ob["state"])):
        ta, tb = oa["state"].get(i, {}), ob["state"].get(i, {})
        for k in sorted(set(ta) | set(tb)):
            va, vb = (torch.as_tensor(t[k]) if k in t else None
                      for t in (ta, tb))
            if (va is None or vb is None or va.device != vb.device
                    or not torch.equal(va, vb)):
                out.append(f"optimizer {i} {k}")
    if a.step != b.step:
        out.append("step")
    return out


def _step_grads(net):
    """{name: .grad on the host} of every parameter."""
    return {n: p.grad.detach().double().cpu().numpy()
            for n, p in net.named_parameters()}


def phase_train(torch, fixtures, npz_replies, gate, gate_ok, card):
    """Training at full width (full:80, 416x416) on the card: (a) one f32
    step from the checkpoint at batch 2, dense and sparse loss, against
    the same step on the CPU and in float64 on the CPU (loss rtol 1e-4
    against both; every gradient tensor of the card within L2-relative
    1e-2 of the float64 step's, and within 1e-3 of the step's largest |g|
    of the CPU's; BN running stats rtol 1e-4 with atol 1e-6 against the
    CPU's);
    (b) 20 bf16 sparse steps with flips from synthetic weights on a fixed
    batch of 8: the mean loss of the last 5 under 0.9x that of the first
    5; (c) step ms, images/s, peak memory and the share of the bf16 peak
    at batch 16 in f32 and bf16; (d) save -> restore gives the saved
    state bit for bit, and one more step equals the uninterrupted run
    (states bit for bit, loss rtol 1e-5), and the export of a
    zero-step state serves the fixtures with [5]'s records byte for
    byte; (e) cli.train --synthetic with a checkpoint and --resume, then
    30 bf16 fine-tune steps at lr 1e-5 and the gate of [10] on their
    export, printed beside the untouched checkpoint's (not a check)."""
    import shutil
    import tempfile

    import numpy as np

    from fastdet_tpu_torch.cli import train as train_cli
    from fastdet_tpu_torch.models import weights, yolov3
    from fastdet_tpu_torch.parallel import checkpoint, train
    from fastdet_tpu_torch.runtime.server import build_services

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    spec, params = weights.load_model(WEIGHTS)
    grids = yolov3.head_grid_sizes(spec)

    # (a) card step against CPU step, f32, batch 2
    x2, boxes2, labels2 = _train_scenes(torch, range(TRAIN_SEEDS,
                                                     TRAIN_SEEDS + 2), cpu)
    dense2 = [torch.from_numpy(t)
              for t in train.build_targets(spec, boxes2, labels2)]
    slots2 = torch.from_numpy(train.build_sparse_targets(spec, boxes2,
                                                         labels2))
    def worst(a, b):
        """(max |a - b| over b's largest |g| of the step, and the worst
        tensor relative to its own max |g|: (error, name))."""
        gmax = max(np.abs(v).max() for v in b.values())
        per = max((float(np.abs(a[n] - b[n]).max()
                         / max(np.abs(b[n]).max(), 1e-30)), n) for n in b)
        return max(float(np.abs(a[n] - b[n]).max()) for n in b) / gmax, per

    def worst_l2(a, b):
        """The worst tensor's L2-relative error ||a - b|| / ||b||:
        (error, name)."""
        return max((float(np.linalg.norm(a[n] - b[n])
                          / max(np.linalg.norm(b[n]), 1e-30)), n) for n in b)

    for kind, tg in (("dense", dense2), ("sparse", [slots2])):
        res = []
        # the card's f32 step, the CPU's, and the CPU's with the net in
        # float64 (its heads and the loss stay float32, as TrainNet
        # returns them): the reference that both f32 steps are held against
        for d, dt in ((dev, torch.float32), (cpu, torch.float32),
                      (cpu, torch.float64)):
            t0 = time.perf_counter()
            st = train.init_train_state(spec, params, device=d)
            st.net.to(dt)
            st, m = train.make_train_step(spec, sparse=kind == "sparse")(
                st, x2.to(d, dt), *[t.to(d, dt) for t in tg])
            res.append((float(m["loss"]), _step_grads(st.net),
                        {n: b.double().cpu().numpy()
                         for n, b in st.net.named_buffers()},
                        time.perf_counter() - t0))
            del st
        (lc, gc, bc, sc), (lh, gh, bh, sh), (l64, g64, _, s64) = res
        gerr, per = worst(gc, gh)
        berr = max(float((np.abs(bc[n] - bh[n])
                          / (1e-6 + 1e-4 * np.abs(bh[n]))).max())
                   for n in bh)
        say(f"[12a] {kind} f32 step, batch 2: loss card {lc!r} CPU {lh!r} "
            f"(rel {abs(lc - lh) / abs(lh):.3e}); over {len(gh)} gradient "
            f"tensors max |card - CPU| = {gerr:.3e} of the step's largest "
            f"|g| (worst tensor {per[1]}: {per[0]:.3e} of its own max); BN "
            f"stats err / (1e-6 + 1e-4 |x|) {berr:.3f}; step walls card "
            f"{sc:.2f} s, CPU {sh:.2f} s, CPU float64 {s64:.2f} s")
        l2 = {}
        for who, g in (("card", gc), ("CPU", gh)):
            e, p = worst(g, g64)
            l2[who] = worst_l2(g, g64)
            say(f"[12a] {kind} f32 {who} vs the float64 CPU step (loss "
                f"{l64!r}): worst tensor L2-relative {l2[who][1]}: "
                f"{l2[who][0]:.3e}; {e:.3e} of the largest |g|; worst "
                f"tensor {p[1]}: {p[0]:.3e} of its own max")
        expect(abs(lc - lh) <= 1e-4 * abs(lh), f"[12a] {kind} loss")
        expect(abs(lc - l64) <= 1e-4 * abs(l64),
               f"[12a] {kind} loss vs float64")
        expect(l2["card"][0] <= 1e-2,
               f"[12a] {kind} card gradients vs float64: {l2['card']}")
        expect(gerr <= 1e-3, f"[12a] {kind} gradients card vs CPU: {gerr}")
        expect(berr <= 1.0, f"[12a] {kind} BN running stats: {berr}")

    # (b) the loss falls: 20 bf16 sparse steps with flips
    x8, boxes8, labels8 = _train_scenes(
        torch, range(TRAIN_SEEDS + 2, TRAIN_SEEDS + 10), dev)
    slots8 = torch.from_numpy(train.build_sparse_targets(
        spec, boxes8, labels8)).to(dev)
    st = train.init_train_state(spec, weights.synthetic_params(spec, 0),
                                device=dev)
    step = train.make_train_step(spec, compute_dtype=torch.bfloat16,
                                 sparse=True)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(20):
        st, m = step(st, *_flipped(torch, train, x8, slots8, rng, grids))
        losses.append(float(m["loss"]))
    del st
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"[12b] bf16 sparse steps from synthetic_params(seed=0), batch 8 "
        f"with flips: losses {[round(v, 3) for v in losses]}")
    say(f"[12b] mean of the last 5 {last:.4f} vs the first 5 {first:.4f} "
        f"({last / first:.4f}, bar 0.9)")
    expect(all(np.isfinite(losses)) and last < 0.9 * first,
           "[12b] the loss did not fall")

    # (c) step time, images/s, memory and share of peak at batch 16
    x16 = torch.cat([x8, x8.flip(2)])
    slots16 = torch.cat([slots8, train.flip_slots(
        slots8, torch.ones(8, dtype=torch.bool, device=dev),
        torch.zeros(8, dtype=torch.bool, device=dev), grids)])
    flops = 3 * 2 * _conv_macs(spec) * x16.shape[0]
    for name, cd in (("f32", None), ("bf16", torch.bfloat16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = train.init_train_state(spec, params, device=dev)
        step = train.make_train_step(spec, compute_dtype=cd, sparse=True)
        for _ in range(3):
            st, m = step(st, x16, slots16)
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            st, m = step(st, x16, slots16)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        mem = torch.cuda.max_memory_allocated()
        _where_time_goes(torch, lambda: step(st, x16, slots16),
                         tag=f"[12c] {name}")
        del st, m
        rate = flops / (ms / 1e3)
        say(f"[12c] {name} train step, batch 16 (sparse loss, AdamW, BN "
            f"EMA): {ms:.3f} ms, {16 / (ms / 1e3):.1f} images/s; peak "
            f"memory {mem / 2**30:.3f} GiB; {flops / 1e12:.4f} TFLOP a "
            f"step (3 x 2 x conv MACs), {rate / 1e12:.2f} TFLOP/s = "
            f"{100 * rate / H100_BF16_FLOPS:.2f} % of the dense bf16 peak "
            f"989 TFLOP/s"
            + (f" ({100 * rate / H100_F32_FLOPS:.1f} % of the 67 TFLOP/s "
               f"float32 peak)" if cd is None else "")
            + f"; {card}")

    tmp = tempfile.mkdtemp(prefix="fastdet-train-")
    try:
        # (d) checkpoint round trip and the export's service
        xd, td = x2.to(dev), [t.to(dev) for t in dense2]
        step = train.make_train_step(spec)
        a, _ = step(train.init_train_state(spec, params, device=dev), xd, *td)
        path = os.path.join(tmp, "state.pt")
        t0 = time.perf_counter()
        checkpoint.save(path, a)
        save_s = time.perf_counter() - t0
        b = checkpoint.restore(path, train.init_train_state(
            spec, weights.synthetic_params(spec, 1), device=dev))
        restored = _state_diff(torch, a, b)
        xb = xd.flip(2)
        # the same cuDNN algorithms for both runs, so the states can be
        # held equal bit for bit after the step
        torch.backends.cudnn.deterministic = True
        try:
            _, ma = step(a, xb, *td)
            _, mb = step(b, xb, *td)
        finally:
            torch.backends.cudnn.deterministic = False
        resumed = _state_diff(torch, a, b)
        la, lb = float(ma["loss"]), float(mb["loss"])
        say(f"[12d] save ({os.path.getsize(path)} B, {save_s:.2f} s) -> "
            f"restore: parameters, BN running stats, Adam moments and step "
            f"equal (differing: {restored}) -> step: loss {lb!r} vs "
            f"uninterrupted {la!r}; the states after it differ in "
            f"{resumed}")
        expect(not restored, f"[12d] the restored state differs: {restored}")
        expect(not resumed and abs(la - lb) <= 1e-5 * abs(la),
               "[12d] the resumed step differs from the uninterrupted one")
        del a, b
        export = os.path.join(tmp, "export.npz")
        checkpoint.export_inference(export, spec, train.init_train_state(
            spec, params, device=dev))
        services = build_services([f"full:80:{export}"], buckets=(8,))
        try:
            with _serving(services) as port:
                replies, _ = _ask(port, "full", fixtures)
        finally:
            services["full"].engine.close()
        for n, recs in replies.items():
            expect(recs == npz_replies[n],
                   f"[12d] {n}: the export's records differ from [5]'s")
        say(f"[12d] export_inference of a zero-step state: its service "
            f"answers the {len(replies)} fixtures with [5]'s records byte "
            f"for byte ({sum(len(r) for r in replies.values())} records)")

        # (e) cli.train with a checkpoint and --resume, then fine-tune
        ck, out = os.path.join(tmp, "cli.pt"), os.path.join(tmp, "cli.npz")
        argv = ["train", "--synthetic", "--batch", "4", "-w", WEIGHTS,
                "--ckpt", ck, "--ckpt-every", "2", "-o", out]
        t0 = time.perf_counter()
        expect(train_cli.main(argv + ["--steps", "4"]) == 0,
               "[12e] cli.train failed")
        t1 = time.perf_counter()
        expect(train_cli.main(argv + ["--steps", "6", "--resume"]) == 0,
               "[12e] cli.train --resume failed")
        t2 = time.perf_counter()
        expect(torch.load(ck, weights_only=True)["step"] == 6
               and os.path.exists(out), "[12e] cli.train --resume")
        say(f"[12e] cli.train --synthetic 4 steps at batch 4 from the "
            f"checkpoint: {t1 - t0:.2f} s; --resume to 6: {t2 - t1:.2f} s; "
            f"checkpoint at step 6, {os.path.getsize(out)} B exported")

        st = train.init_train_state(spec, params, lr=1e-5, device=dev)
        step = train.make_train_step(spec, compute_dtype=torch.bfloat16,
                                     sparse=True)
        losses = []
        t0 = time.perf_counter()
        for i in range(30):
            seeds = range(TRAIN_SEEDS + 100 + 8 * i, TRAIN_SEEDS + 108 + 8 * i)
            xi, bi, li = _train_scenes(torch, seeds, dev)
            si_ = torch.from_numpy(train.build_sparse_targets(
                spec, bi, li)).to(dev)
            st, m = step(st, *_flipped(torch, train, xi, si_, rng, grids))
            losses.append(float(m["loss"]))
        tuned = os.path.join(tmp, "tuned.npz")
        checkpoint.export_inference(tuned, spec, st)
        del st
        say(f"[12e] 30 bf16 fine-tune steps at lr 1e-5, batch 8 (seeds "
            f"{TRAIN_SEEDS + 100}-{TRAIN_SEEDS + 339}, flips): "
            f"{time.perf_counter() - t0:.1f} s; losses "
            f"{[round(v, 3) for v in losses]}")
        r = _gate_run(torch, tuned, "bf16", gate, tag="[12e]")
        say(f"[12e] gate after fine-tuning (printed, not a check): "
            f"{sum(r['ok'])}/{len(r['ok'])} frames ok, against the "
            f"untouched checkpoint's {gate_ok['bf16']}/{len(r['ok'])} in "
            f"[10]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernels_line(b1, b2, launches, d):
    def entry(name, src, replaces, res, n):
        ms, plain_ms, bound_ms = res["timing"][8]
        out = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": res["max_abs_err"],
            "max_abs_diff": res["max_abs_err"],
            "ms": ms, "kernel_ms": ms, "device_ms": res["device_ms"],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "batch": 8,
        }
        for b in (1, 16):
            if b in res["timing"]:
                out[f"ms_b{b}"] = res["timing"][b][0]
                out[f"bound_ms_b{b}"] = res["timing"][b][2]
                out[f"device_ms_b{b}"] = res["device_ms_by_b"][b]
        for key in ("tiles", "moved_bytes", "dense_device_ms_by_b",
                    "dense_bound_ms_by_b"):
            if key in res:
                out[key] = res[key]
        return out

    return {"kernels": [
        entry("B1 sparse_ingest", "fastdet_tpu_torch/csrc/sparse_ingest.cu",
              "fastdet_tpu/ops/pallas/sparse_ingest.py:452", b1,
              launches["B1"]),
        entry("B2 plane_ingest", "fastdet_tpu_torch/csrc/plane_ingest.cu",
              "fastdet_tpu/ops/pallas/plane_ingest.py:91", b2,
              launches["B2"]),
        entry("D1 ingest_stages", "fastdet_tpu_torch/csrc/ingest_stages.cu",
              "tools/debug_kernel_tpu.py:133", d["D1"], d["launches"]["D1"]),
        entry("D2 ingest_nat_gated",
              "fastdet_tpu_torch/csrc/ingest_stages.cu",
              "tools/debug_kernel_tpu.py:298", d["D2"], d["launches"]["D2"]),
    ]}


def main(argv) -> int:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    ).parse_args(argv[1:])
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    # warnings only: the CLIs driven in [11] and [12] configure INFO
    # logging when nothing has configured it before them
    logging.basicConfig(format="%(asctime)s %(levelname)s %(message)s",
                        level=logging.WARNING)

    if not os.path.isdir(os.path.join(REPO, "fastdet_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(fastdet_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2

    t_start = time.time()
    name, card = phase_device(torch)
    phase_build()
    fixtures = _fixture_bytes()
    b1 = phase_b1(torch, fixtures)
    b2 = phase_b2(torch, fixtures)
    stages = phase_stages(torch)

    from fastdet_tpu_torch.runtime.server import build_services

    t0 = time.time()
    services = build_services([f"full:80:{WEIGHTS}"], buckets=(8,))
    say(f"[4] build_services(full:80, bf16, bucket 8) with warmup: "
        f"{time.time() - t0:.1f} s")
    try:
        engine_records = phase_engine(torch, fixtures, services)
        launches, replies = phase_server(torch, fixtures, services,
                                         engine_records)
        phase_int8(torch, fixtures, services, engine_records)
        phase_coeffs(torch, fixtures, services)
        phase_checkpoints(torch, fixtures, replies)
        gate, gate_ok = phase_gate(torch)
        phase_client(torch, fixtures, services)
        phase_train(torch, fixtures, replies, gate, gate_ok, card)
    finally:
        for svc in services.values():
            svc.engine.close()
    alive = [t.name for t in threading.enumerate()
             if t is not threading.main_thread() and not t.daemon]
    expect(not alive, f"threads left running: {alive}")
    say(f"[done] {time.time() - t_start:.1f} s")
    say(card)
    say(json.dumps(kernels_line(b1, b2, launches, stages)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    except Exception:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread this run started is joined or daemonic; os._exit makes
    # sure no interpreter-exit hook can hold the process past its result
    os._exit(rc)
