"""Kernel B1's stages one by one — kernels D1 and D2, the stage debugger.

Replaces the TPU kernels of the JAX package's kernel-debug tool,
``tools/debug_kernel_tpu.py`` (``dbg_kernel``, launched by ``run`` :133,
and ``dbg_kernel2``, the inline ``pl.pallas_call`` :298), with two
hand-written CUDA kernels in ``csrc/ingest_stages.cu``. That tool ran
B1's window and placement stages alone on the TPU to find a miscompiled
primitive; the port's counterpart runs the device functions kernel B1
runs (``csrc/ingest_common.cuh``) and writes out what each step gives,
so every stage can be held against its plain version here.

The inputs are the tool's (:func:`build_case` rows, :func:`prepare_streams`
host preparation), as flat int32 streams per frame. Stages of D1, per
frame and JPEG block j (``off = probe[j]``, ``nnz = probe[j+1] - off``):

- ``mwin`` (NB, 8): the block's mask bytes ``ms[moffx[j] + k]`` for
  k < min(moffx[j+1] - moffx[j], 8), else 0;
- ``win`` (NB, 64): its values ``vals[off + k]`` for k < min(nnz, 64);
- ``seg`` (NB / bt, bt*32): each tile's bt*32 values from the tile's
  first value offset;
- ``bits`` (NB, 64): the mask bits in zigzag order (bit p of mask byte
  p >> 3);
- ``rank`` (NB, 64): their exclusive in-block prefix counts;
- ``acc`` (NB, 64): the sign-extended nibble ``win[rank] & 15`` at each
  set bit, else 0;
- ``nat`` (NB, 64): ``acc`` in natural order.

D2 gives ``nat`` again, through the tile structure of the TPU kernel
and of kernel B1, with GATE added to every output of a tool tile (bt
blocks) whose level-1 escape offsets ``eoff1`` show escapes. A tool tile
whose value span fits bt*32 entries takes the fast route (values staged
in shared memory), any other the dense route (values read from global
memory); both read the same entries. The kernel runs B1's tile phases
on sub-tiles of a tool tile (:func:`sub_tile`). Every read past a stream
is 0.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdet_tpu_torch.ops import _build
from fastdet_tpu_torch.ops import jpeg_device as jd
from fastdet_tpu_torch.ops import sparse_ingest as si

LANES = 128
GATE = 100000   # D2's escape-gate offset (the tool's marker value)
MAX_BT = 128    # the largest tool tile pick_bt returns

#: D2's sub-tile sizes (blocks per CTA), one instance each in
#: csrc/ingest_stages.cu
SUB_TILES = (8, 16, 32, 64)

#: launches of the CUDA kernels (the plain versions do not count)
LAUNCHES = {"D1": 0, "D2": 0}
_LAUNCHES_LOCK = threading.Lock()


def build_case(rng, B, NB, esc1_p, esc2_p, max_nnz=19,
               MCAP=512, NCAPB=640, E8CAP=512, E16CAP=256, DCECAP=256,
               min_nnz=0):
    """Synthetic v5 sparse rows (plen, maskstream, dc8, nib, esc8, esc16,
    dcesc) with the given escape rates — the JAX package's
    ``tools/bisect_kernel_tpu.build_case``, draw for draw, so one
    ``RandomState`` gives identical arrays. ``min_nnz`` (the port's
    addition; 0 keeps the draws) raises the per-block value count, so a
    tile's value span can exceed bt*32."""
    plen = np.zeros((B, (NB + 1) // 2), np.uint8)
    ms = np.zeros((B, MCAP), np.uint8)
    nib = np.zeros((B, NCAPB), np.uint8)
    esc8 = np.zeros((B, E8CAP), np.int8)
    esc16 = np.zeros((B, E16CAP), np.int16)
    dc8 = np.zeros((B, NB), np.int8)
    dcesc = np.zeros((B, DCECAP), np.int16)
    for b in range(B):
        nac = ne8 = ne16 = nmask = 0
        for n in range(NB):
            dc8[b, n] = rng.randint(-127, 128)
            nnz = rng.randint(min_nnz, max_nnz + 1)
            zzmask = 0
            zzs = np.sort(rng.choice(63, nnz, replace=False) + 1)
            for j in zzs:
                zzmask |= 1 << int(j)
                r = rng.rand()
                if r < esc2_p and ne16 < E16CAP and ne8 < E8CAP:
                    v = -8
                    esc8[b, ne8] = -128
                    ne8 += 1
                    esc16[b, ne16] = rng.randint(300, 32000) * rng.choice(
                        [-1, 1])
                    ne16 += 1
                elif r < esc1_p and ne8 < E8CAP:
                    v = -8
                    esc8[b, ne8] = rng.randint(8, 128) * rng.choice([-1, 1])
                    ne8 += 1
                else:
                    v = rng.randint(-7, 8)
                n4 = v & 0xF
                if nac & 1:
                    nib[b, nac >> 1] |= n4 << 4
                else:
                    nib[b, nac >> 1] = n4
                nac += 1
            pl = (int(zzmask).bit_length() + 7) // 8
            if n & 1:
                plen[b, n >> 1] |= pl << 4
            else:
                plen[b, n >> 1] = pl
            mb = int(zzmask).to_bytes(8, "little")[:pl]
            ms[b, nmask:nmask + pl] = np.frombuffer(mb, np.uint8)
            nmask += pl
    return plen, ms, dc8, nib, esc8, esc16, dcesc


def pick_bt(nb: int) -> int:
    """Blocks per tile: the largest multiple of 16 up to 128 that divides
    ``nb``, else 16 (the JAX kernel's ``_pick_bt``, without its
    environment override)."""
    for bt in range(MAX_BT, 15, -16):
        if nb % bt == 0:
            return bt
    return 16


def sub_tile(nframes: int, nb: int, bt: int, sms: int) -> int:
    """Blocks per CTA of kernel D2 for ``nframes`` frames of ``nb`` blocks
    in tool tiles of ``bt`` on a card of ``sms`` multiprocessors: the
    largest of :data:`SUB_TILES` that divides ``bt`` and whose grid still
    gives every SM a CTA, else the smallest that divides ``bt`` (B1's
    rule, sparse_ingest.tile). At NB = 4096, bt = 128 on 132 SMs that is
    16 at one frame, 32 at two and 64 from three (so 64 at 8 and at 16).
    Raises ValueError when no size divides ``bt``."""
    fits = [s for s in SUB_TILES if bt % s == 0]
    if not fits:
        raise ValueError(f"ingest_stages: bt={bt} is not a multiple of "
                         f"{SUB_TILES[0]} (D2's sub-tiles: {SUB_TILES})")
    for sub in reversed(fits[1:]):
        if nb // sub * nframes >= sms:
            return sub
    return fits[0]


def rows128(stream32: torch.Tensor, extra_rows: int) -> torch.Tensor:
    """(B, CAP) int32 -> (B, (ceil(CAP/128) + extra_rows) * 128), zero
    padded: the flat form of the JAX kernel's ``_rows128`` layout."""
    cap = stream32.shape[1]
    rows = -(-cap // LANES)
    return F.pad(stream32, (0, (rows + extra_rows) * LANES - cap))


class Streams(NamedTuple):
    """Host-prepared inputs of D1/D2 (each (B, ...) int32)."""
    moffx: torch.Tensor   # (B, NB+1) mask-stream block offsets + total
    probe: torch.Tensor   # (B, NB+1) value-stream block offsets + total
    off: torch.Tensor     # (B, NB) value offset of each block
    nnz: torch.Tensor     # (B, NB) value count of each block
    vals: torch.Tensor    # (B, 2*NCAPB) signed nibble values
    ms32: torch.Tensor    # (B, ML) mask bytes, padded as rows128
    vals32: torch.Tensor  # (B, VL) values, padded as rows128
    eoff1: torch.Tensor   # (B, NB+1) level-1 escape offsets (-8 values)
    bt: int               # blocks per tile


def prepare_streams(plen: torch.Tensor, ms: torch.Tensor, nib: torch.Tensor,
                    nb: int) -> Streams:
    """The tool's host stream preparation (debug_kernel_tpu.py:37-59):
    mask offsets from the plen nibbles, value offsets probed from the
    mask popcount prefix at the mask boundaries (the wire mask's DC bit
    is clear, so the popcount prefix counts AC values), unpacked nibble
    values, the tile size and the padded int32 streams; plus the level-1
    escape offsets D2's gate reads (the tool passed zeros there)."""
    ln = jd.unpack_nibbles_u(plen)[:, :nb].to(torch.int64)
    moff = torch.cumsum(ln, -1) - ln
    moffx = torch.cat([moff, moff[:, -1:] + ln[:, -1:]], -1)
    vals = jd.unpack_nibbles(nib)
    s = torch.cumsum(si._popcount_u8(ms), -1)
    probe = torch.where(moffx > 0, jd.take(s, moffx - 1).to(torch.int64), 0)
    bt = pick_bt(nb)
    return Streams(
        moffx=moffx.to(torch.int32),
        probe=probe.to(torch.int32),
        off=probe[:, :-1].to(torch.int32),
        nnz=(probe[:, 1:] - probe[:, :-1]).to(torch.int32),
        vals=vals,
        ms32=rows128(ms.to(torch.int32), bt // 16 + 1),
        vals32=rows128(vals, bt // 4 + 1),
        eoff1=si._boundary_prefix(vals == -8, probe).to(torch.int32),
        bt=bt)


class Stages(NamedTuple):
    mwin: torch.Tensor  # (B, NB, 8)
    win: torch.Tensor   # (B, NB, 64)
    seg: torch.Tensor   # (B, NB/bt, bt*32)
    bits: torch.Tensor  # (B, NB, 64)
    rank: torch.Tensor  # (B, NB, 64)
    acc: torch.Tensor   # (B, NB, 64)
    nat: torch.Tensor   # (B, NB, 64)


def _window(stream: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
            width: int) -> torch.Tensor:
    """(B, N, width) entries ``stream[start + k]`` for k < count, 0 past
    the window and past the stream."""
    k = torch.arange(width, device=stream.device)
    idx = start[..., None] + k
    ok = (k < count[..., None]) & (idx >= 0) & (idx < stream.shape[1])
    return torch.where(ok, jd.take(stream, idx), 0)


def _check_bt(nb: int, bt: int) -> None:
    if bt <= 0 or nb % bt:
        raise ValueError(f"ingest_stages: bt={bt} must divide nb={nb}")


def stages_plain(ms32: torch.Tensor, vals32: torch.Tensor,
                 moffx: torch.Tensor, probe: torch.Tensor,
                 bt: int) -> Stages:
    """Kernel D1's plain version: the seven stages (module docstring)."""
    nb = moffx.shape[1] - 1
    _check_bt(nb, bt)
    mo, po = moffx.to(torch.int64), probe.to(torch.int64)
    mwin = _window(ms32, mo[:, :-1], torch.clamp(mo[:, 1:] - mo[:, :-1],
                                                 max=8), 8)
    off, nnz = po[:, :-1], po[:, 1:] - po[:, :-1]
    win = _window(vals32, off, nnz, 64)
    s0 = po[:, 0:nb:bt]
    seg = _window(vals32, s0, torch.full_like(s0, bt * 32), bt * 32)
    bits = jd.mask_bits(mwin).to(torch.int32)
    rank = jd.excl_cumsum(bits)
    nib = torch.gather(win, -1, rank) & 15
    acc = (nib - ((nib >> 3) << 4)) * bits
    nat = acc[..., jd._const("nat2zz", acc.device)]
    return Stages(mwin, win, seg, bits, rank.to(torch.int32), acc,
                  nat.contiguous())


def nat_gated_plain(ms32: torch.Tensor, vals32: torch.Tensor,
                    moffx: torch.Tensor, probe: torch.Tensor,
                    eoff1: torch.Tensor, bt: int) -> torch.Tensor:
    """Kernel D2's plain version: D1's ``nat`` plus GATE on every output
    of a tile with level-1 escapes (eoff1[tile end] > eoff1[tile start])."""
    nat = stages_plain(ms32, vals32, moffx, probe, bt).nat
    nb = moffx.shape[1] - 1
    e = eoff1.to(torch.int64)
    esc = (e[:, bt::bt] - e[:, 0:nb:bt]) > 0                 # (B, NB/bt)
    gate = torch.where(esc, GATE, 0).to(torch.int32)
    return nat + gate.repeat_interleave(bt, dim=1)[..., None]


def _cuda_inputs(name: str, tensors):
    """Validate the wrapper inputs for a launch; returns the device."""
    dev = tensors[0][1].device
    b = tensors[0][1].shape[0]
    for tname, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device (or all on the CPU)")
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != b \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be a contiguous "
                             f"({b}, N) int32 tensor")
    if dev.type != "cuda":
        raise ValueError(f"{name}: inputs on {dev} (CUDA or CPU only)")
    return dev


def _launched(key: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1


def stages(ms32: torch.Tensor, vals32: torch.Tensor, moffx: torch.Tensor,
           probe: torch.Tensor, bt: int) -> Stages:
    """Kernel D1: B1's stages for every block (module docstring).

    CPU tensors take :func:`stages_plain`; CUDA tensors launch the kernel
    or raise."""
    tensors = (("ms32", ms32), ("vals32", vals32), ("moffx", moffx),
               ("probe", probe))
    if all(t.device.type == "cpu" for _, t in tensors):
        return stages_plain(ms32, vals32, moffx, probe, bt)
    dev = _cuda_inputs("ingest_stages.stages", tensors)
    b, nb1 = moffx.shape
    nb = nb1 - 1
    if probe.shape != moffx.shape or nb < 1:
        raise ValueError("ingest_stages.stages: moffx and probe must both "
                         "be (B, NB+1)")
    _check_bt(nb, bt)
    out = Stages(*(torch.empty(shape, dtype=torch.int32, device=dev)
                   for shape in ((b, nb, 8), (b, nb, 64),
                                 (b, nb // bt, bt * 32), (b, nb, 64),
                                 (b, nb, 64), (b, nb, 64), (b, nb, 64))))
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fd_ingest_stages(
            ms32.data_ptr(), vals32.data_ptr(), moffx.data_ptr(),
            probe.data_ptr(), *(t.data_ptr() for t in out), b, nb, bt,
            ms32.shape[1], vals32.shape[1], stream)
    _build.check("fd_ingest_stages", rc)
    _launched("D1")
    return out


def nat_gated(ms32: torch.Tensor, vals32: torch.Tensor, moffx: torch.Tensor,
              probe: torch.Tensor, eoff1: torch.Tensor,
              bt: int) -> torch.Tensor:
    """Kernel D2: (B, NB, 64) int32 ``nat`` through the tile structure,
    escape-gated (module docstring), on :func:`sub_tile`'s sub-tiles. CPU
    tensors take :func:`nat_gated_plain`; CUDA tensors launch the kernel
    or raise."""
    tensors = (("ms32", ms32), ("vals32", vals32), ("moffx", moffx),
               ("probe", probe), ("eoff1", eoff1))
    if all(t.device.type == "cpu" for _, t in tensors):
        return nat_gated_plain(ms32, vals32, moffx, probe, eoff1, bt)
    dev = _cuda_inputs("ingest_stages.nat_gated", tensors)
    b, nb1 = moffx.shape
    nb = nb1 - 1
    if probe.shape != moffx.shape or eoff1.shape != moffx.shape or nb < 1:
        raise ValueError("ingest_stages.nat_gated: moffx, probe and eoff1 "
                         "must all be (B, NB+1)")
    _check_bt(nb, bt)
    if b > 65535:
        raise ValueError(f"ingest_stages.nat_gated: B={b} > 65535")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _nat_gated_cuda(ms32, vals32, moffx, probe, eoff1, bt,
                           sub_tile(b, nb, bt, sms))


def _nat_gated_cuda(ms32, vals32, moffx, probe, eoff1, bt: int,
                    sub: int) -> torch.Tensor:
    """Launch kernel D2 on checked CUDA inputs with sub-tiles of ``sub``
    blocks (``chip_smoke.py`` times every size through it)."""
    dev = moffx.device
    b, nb = moffx.shape[0], moffx.shape[1] - 1
    out = torch.empty((b, nb, 64), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fd_ingest_nat_gated(
            ms32.data_ptr(), vals32.data_ptr(), moffx.data_ptr(),
            probe.data_ptr(), eoff1.data_ptr(), out.data_ptr(), b, nb, bt,
            sub, ms32.shape[1], vals32.shape[1], stream)
    _build.check("fd_ingest_nat_gated", rc)
    _launched("D2")
    return out
