"""Sparse JPEG coefficient reconstruction — kernel B1 and its batch entries.

Replaces the TPU kernel ``fastdet_tpu/ops/pallas/sparse_ingest.py``
(``_kernel``, launched by ``_reconstruct``) with a hand-written CUDA
kernel, ``csrc/sparse_ingest.cu``. The TPU kernel's windows, one-hot
placement matmuls and permutation matmuls were workarounds for a core
without fast gathers; the card has them. The kernel stages a tile of
blocks' offsets, mask bytes and values in shared memory, places the
tile's coefficients there (one warp per JPEG block, two zigzag
positions per lane) and writes the tile back as one contiguous span —
see the source for its design.

The split is the JAX package's:

- the PROLOGUE (:func:`stream_offsets`, plain torch on the device, as it
  was XLA around the Pallas kernel): per-block exclusive offsets of the
  mask, value and both escape streams, from prefix sums over each stream
  probed at the block boundaries;
- kernel B1 (:func:`reconstruct`): per block, expand the mask prefix to
  64 zigzag bits, rank them, place values, resolve the two escape levels
  and write natural order. The DC column (jpeg_device.dc_reconstruct /
  dc_reconstruct6, plain torch, as it was XLA) goes in as ``dc`` and
  lands at natural position 0; without it that position holds what the
  mask gives there (0 on every row the emitter writes), as the Pallas
  kernel's does.

Semantics on any input, valid or not (both the kernel and
:func:`reconstruct_plain`; bit-exact to the Pallas kernel run with
``interpret=True``, tests/test_torch_sparse_ingest.py):

- block j's mask bytes are ``maskstream[moff[j] + k]`` for
  k < min(moff[j+1] - moff[j], 8); its values ``vals[voff[j] + r]`` for
  in-block rank r < voff[j+1] - voff[j]; its level-1 escapes
  ``esc8[e1off[j] + r]`` for r < min(e1off[j+1] - e1off[j], 32) and its
  level-2 escapes ``esc16[e2off[j] + r]`` for r < min(e2off[j+1] -
  e2off[j], 16) (the emitter's per-block caps, fd_jpeg.cpp
  kMaxEsc8PerBlock / kMaxEsc16PerBlock); anything else reads 0;
- every read past a stream's capacity reads 0, as the TPU kernel's zero
  pad rows do — so a zeroed row or a truncated overflow row never reads
  out of bounds.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from fastdet_tpu_torch.ops import _build
from fastdet_tpu_torch.ops import jpeg_device as jd

EW1 = 32   # level-1 escapes per block (fd_jpeg.cpp kMaxEsc8PerBlock)
EW2 = 16   # level-2 escapes per block (fd_jpeg.cpp kMaxEsc16PerBlock)

#: launches of the CUDA kernel (the plain version does not count; a
#: launch captured into a CUDA graph counts at each replay)
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


def add_launches(n: int) -> None:
    """Count ``n`` launches of the kernel."""
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += n


#: the kernel's tile sizes (blocks per CTA), one instance each in
#: csrc/sparse_ingest.cu
TILES = (8, 16, 32, 64)

_POPCOUNT = {}


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    lut = _POPCOUNT.get(x.device)
    if lut is None:
        # the first writer wins, so a captured graph's table stays alive
        lut = _POPCOUNT.setdefault(x.device, torch.tensor(
            [bin(i).count("1") for i in range(256)], dtype=torch.int64,
            device=x.device))
    return lut[x.to(torch.int64)]


def _boundary_prefix(flags: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Exclusive per-block counts of flagged stream entries, as offsets.

    ``ends`` (B, NB+1) are the block boundaries in the flagged stream;
    returns (B, NB+1) offsets [0, c0, c0+c1, ...] where c_j counts the
    flags in [ends[j], ends[j+1]) (boundaries past the stream's capacity
    count up to the capacity — the Pallas prologue's _stream_counts)."""
    cap = flags.shape[1]
    s = torch.cumsum(flags.to(torch.int64), dim=1)
    probe = torch.where(ends > 0, jd.take(s, ends - 1).to(torch.int64), 0)
    cnt = probe[:, 1:] - probe[:, :-1]
    return torch.cat([torch.zeros_like(cnt[:, :1]), torch.cumsum(cnt, 1)], 1)


def stream_offsets(plen: torch.Tensor, maskstream: torch.Tensor,
                   vals: torch.Tensor, esc8: torch.Tensor, nb: int,
                   sentinel: int) -> torch.Tensor:
    """The prologue: (B, 4, NB+1) int32 exclusive block offsets into the
    mask, value, esc8 and esc16 streams, each extended with its total.

    Value offsets come straight from the mask stream (the wire mask's DC
    bit is clear, so the inclusive popcount prefix at a block's mask
    boundary is its exclusive AC-value offset), clamped to the value
    stream's capacity; escape offsets count sentinels inside each
    block's value (resp. esc8) range."""
    ln = jd.unpack_nibbles_u(plen)[:, :nb].to(torch.int64)
    moff = torch.cat([torch.zeros_like(ln[:, :1]), torch.cumsum(ln, 1)], 1)
    s = torch.clamp(torch.cumsum(_popcount_u8(maskstream), dim=1),
                    max=vals.shape[1])
    voff = torch.where(moff > 0, jd.take(s, moff - 1).to(torch.int64), 0)
    e1off = _boundary_prefix(vals == sentinel, voff)
    e2off = _boundary_prefix(esc8 == -128, e1off)
    return torch.stack([moff, voff, e1off, e2off], dim=1).to(torch.int32)


def _escape_level(flag, e_off, stream, width, prev):
    """Substitute flagged lanes with their block's escape entries."""
    rank = jd.excl_cumsum(flag)                                # (B, NB, 64)
    start = e_off[:, :-1, None].to(torch.int64)
    n = (e_off[:, 1:] - e_off[:, :-1])[..., None]
    idx = start + rank
    ok = (rank < width) & (rank < n) & (idx < stream.shape[1])
    val = torch.where(ok, jd.take(stream, idx), 0)
    return torch.where(flag, val, prev)


def reconstruct_plain(offs: torch.Tensor, maskstream: torch.Tensor,
                      vals: torch.Tensor, esc8: torch.Tensor,
                      esc16: torch.Tensor, sentinel: int,
                      dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B1's plain version: (B, NB, 64) int32 in natural order,
    ``dc`` (B, NB) at position 0 when given."""
    dev = maskstream.device
    moff, voff = offs[:, 0].to(torch.int64), offs[:, 1].to(torch.int64)
    ln = torch.clamp(moff[:, 1:] - moff[:, :-1], 0, 8)
    k8 = torch.arange(8, device=dev)
    midx = moff[:, :-1, None] + k8
    mb = torch.where((k8 < ln[..., None]) & (midx < maskstream.shape[1]),
                     jd.take(maskstream, midx), 0)
    bits = jd.mask_bits(mb)                                    # (B, NB, 64)
    rank = jd.excl_cumsum(bits)
    nnz = (voff[:, 1:] - voff[:, :-1])[..., None]
    vidx = voff[:, :-1, None] + rank
    ok = (bits > 0) & (rank < nnz) & (vidx < vals.shape[1])
    acc = torch.where(ok, jd.take(vals, vidx), 0)
    esc1 = (bits > 0) & (acc == sentinel)
    c1 = _escape_level(esc1, offs[:, 2], esc8, EW1, acc)
    esc2 = esc1 & (c1 == -128)
    c2 = _escape_level(esc2, offs[:, 3], esc16, EW2, c1)
    out = c2[..., jd._const("nat2zz", dev)].contiguous()
    if dc is not None:
        out[..., 0] = dc
    return out


def tile(nframes: int, nb: int, sms: int) -> int:
    """Blocks per CTA for ``nframes`` frames of ``nb`` blocks on a card of
    ``sms`` multiprocessors: the largest of :data:`TILES` whose grid still
    gives every SM a CTA. A CTA's fixed cost (two round trips to memory,
    four barriers) is paid once per tile, so once the card is covered a
    larger tile wins; at 416x416 4:2:0 (NB = 4056) on 132 SMs that is 16
    at one frame, 32 at two and 64 from four."""
    for bt in reversed(TILES[1:]):
        if -(-nb // bt) * nframes >= sms:
            return bt
    return TILES[0]


def reconstruct(offs: torch.Tensor, maskstream: torch.Tensor,
                vals: torch.Tensor, esc8: torch.Tensor, esc16: torch.Tensor,
                sentinel: int, dc: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Kernel B1: per-block reconstruction -> (B, NB, 64) int32.

    offs (B, 4, NB+1) int32 (:func:`stream_offsets`); maskstream (B,
    MCAP) uint8; vals (B, NV) int32 unpacked values; esc8 (B, E8) int8;
    esc16 (B, E16) int16; dc, optional, (B, NB) int32, written at natural
    position 0. The kernel's tile is :func:`tile`'s. CPU tensors take
    :func:`reconstruct_plain`; CUDA tensors launch the CUDA kernel or
    raise."""
    b, four, nb1 = offs.shape
    if dc is not None and (dc.dtype != torch.int32
                           or tuple(dc.shape) != (b, nb1 - 1)):
        raise ValueError(f"sparse_ingest.reconstruct: dc must be a ({b}, "
                         f"{nb1 - 1}) int32 tensor, got {tuple(dc.shape)} "
                         f"{dc.dtype}")
    inputs = [(t, dt, name) for t, dt, name in (
        (offs, torch.int32, "offs"), (maskstream, torch.uint8, "maskstream"),
        (vals, torch.int32, "vals"), (esc8, torch.int8, "esc8"),
        (esc16, torch.int16, "esc16"), (dc, torch.int32, "dc"))
        if t is not None]
    if all(t.device.type == "cpu" for t, _, _ in inputs):
        return reconstruct_plain(offs, maskstream, vals, esc8, esc16,
                                 sentinel, dc)
    dev = offs.device
    for t, _, name in inputs:
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"sparse_ingest.reconstruct: {name} is on "
                             f"{t.device}, offs on {dev}; all inputs must "
                             f"be on one CUDA device (or all on the CPU)")
    for t, dt, name in inputs:
        if (t.dtype != dt or t.shape[0] != b or not t.is_contiguous()):
            raise ValueError(f"sparse_ingest.reconstruct: {name} must be a "
                             f"contiguous ({b}, ...) {dt} tensor")
    if four != 4 or nb1 < 2:
        raise ValueError(f"sparse_ingest.reconstruct: offs shape "
                         f"{tuple(offs.shape)} is not (B, 4, NB+1)")
    nb = nb1 - 1
    bt = tile(b, nb,
              torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, nb, 64), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fd_sparse_reconstruct(
            offs.data_ptr(), maskstream.data_ptr(), vals.data_ptr(),
            esc8.data_ptr(), esc16.data_ptr(),
            None if dc is None else dc.data_ptr(), out.data_ptr(),
            b, nb, maskstream.shape[1], vals.shape[1], esc8.shape[1],
            esc16.shape[1], sentinel, bt, stream)
    _build.check("fd_sparse_reconstruct", rc)
    if not _build.captured(add_launches):
        add_launches(1)
    return out


def _batch_ac(plen, maskstream, vals, esc8, esc16, nb: int, sentinel: int,
              dc: torch.Tensor):
    """Shared v5/v6 batched reconstruction (prologue + kernel B1 with the
    DC column)."""
    offs = stream_offsets(plen, maskstream, vals, esc8, nb, sentinel)
    return reconstruct(offs, maskstream.contiguous(), vals.contiguous(),
                       esc8.contiguous(), esc16.contiguous(), sentinel,
                       dc=dc)


def _with_dc(ac: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """``ac`` with ``dc`` at natural position 0: what ``reconstruct(...,
    dc=dc)`` computes, spelled as a separate pass (the check of the
    kernel's DC lane)."""
    return torch.cat([dc[..., None], ac[..., 1:]], dim=-1)


def sparse5_to_coeffs_batch(plen, maskstream, dc8, nib, esc8, esc16, dcesc,
                            yb: int, cb: int) -> torch.Tensor:
    """v5 rows -> (B, NB, 64) int32 NATURAL-order coefficients: plen (B,
    ceil(NB/2)) uint8, maskstream (B, MCAP) uint8, dc8 (B, NB) int8, nib
    (B, NCAP_BYTES) uint8, esc8 int8, esc16 int16, dcesc int16."""
    nb = dc8.shape[1]
    return _batch_ac(plen, maskstream, jd.unpack_nibbles(nib), esc8, esc16,
                     nb, -8, jd.dc_reconstruct(dc8, dcesc, yb, cb))


def sparse6_to_coeffs_batch(plen, maskstream, dc4, tri, esc8, esc16, dcesc8,
                            dcesc16, yb: int, cb: int) -> torch.Tensor:
    """v6 rows -> (B, NB, 64) int32 NATURAL-order coefficients: the v5
    machinery with 3-bit values (``tri``, escape sentinel -4) and 4-bit
    DC deltas with their own two escape levels."""
    nb = yb + 2 * cb
    return _batch_ac(plen, maskstream, jd.unpack_3bit(tri), esc8, esc16, nb,
                     -4, jd.dc_reconstruct6(dc4, dcesc8, dcesc16, yb, cb))
