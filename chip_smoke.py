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

then prints the card line, the kernels line and, last, the result line.
It exits nonzero with no result line when no CUDA card is present, when
run outside the repository, or when any phase fails. A watchdog ends a
hung run with every thread's stack.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
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


def phase_server(torch, fixtures, services, engine_records, tag="[5]"):
    import asyncio

    from fastdet_tpu_torch.ops import plane_ingest
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime.client import DetectClient
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
    si.LAUNCHES = plane_ingest.LAUNCHES = 0
    thread.start()
    expect(ready.wait(30), "server did not start")
    client = DetectClient("127.0.0.1", server.bound_port, path="full")
    names = list(fixtures)
    t0 = time.time()
    try:
        client.open(timeout=10)
        for i, n in enumerate(names):
            client.request(i + 1, THR, fixtures[n])
        replies = {n: client.wait_response(i + 1, timeout=30)
                   for i, n in enumerate(names)}
    finally:
        client.close()
        dt = time.time() - t0
        loop = state.get("loop")
        if loop is not None:
            loop.call_soon_threadsafe(server.request_shutdown)
            loop.call_soon_threadsafe(state["task"].cancel)
        thread.join(30)
    launches = {"B1": si.LAUNCHES, "B2": plane_ingest.LAUNCHES}
    expect(not thread.is_alive(), "server thread did not stop")
    for n in names:
        _, recs = replies[n]
        _same_records(recs, engine_records[n], f"{n} server vs engine")
    svc = services["full"]
    say(f"{tag} server: {len(names)} requests answered in {dt * 1e3:.1f} ms; "
        f"every response matches the engine; ingest {svc.ingest}, "
        f"batches {svc.batch_hist}; launches {launches}")
    expect(launches["B1"] > 0 and launches["B2"] > 0,
           f"a kernel was not launched on the served path: {launches}")
    return launches


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
        launches = phase_server(torch, fixtures, services, engine_records)
        phase_int8(torch, fixtures, services, engine_records)
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
