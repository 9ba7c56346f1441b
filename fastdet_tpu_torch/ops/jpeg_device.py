"""On-device JPEG tail in PyTorch: sparse unpack, dequant + IDCT, chroma
upsample, colour convert.

Counterpart of the JAX package's ops/jpeg_device.py, function for
function and bit for bit (tests/test_torch_jpeg_device.py). Every
function here takes a LEADING BATCH DIMENSION (the JAX versions are
per frame and vmapped by the engine).

- The host entropy-decodes only; the sparse wire rows (v5 nibble / v6
  3-bit values with two escape levels, zigzag mask prefixes, DC raster
  deltas — native/jpeg/fd_jpeg.cpp decode_sparse5/6) unpack here.
  :func:`sparse5_to_coeffs` / :func:`sparse6_to_coeffs` are the gather
  formulation, every stream index clamped into its stream; the engine
  reconstructs through ops/sparse_ingest.py (kernel B1) instead.
- The 8x8 IDCT is one float32 matmul with the Kronecker basis
  ``kron(T, T)``. It must run in TRUE float32: TF32 would shift pixels
  by whole levels (device.strict_fp32).
- The libjpeg "fancy" chroma upsample is integer shift arithmetic; the
  colour transform rounds half to even and clips to the uint8 grid.
- :func:`decode420_batch` is the coefficient path's tail: the host ships
  entropy-decoded int16 coefficients (native_jpeg.decode_coefficients)
  and the same dequant, IDCT and colour run here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ZZ[j] = natural-order position of the j-th zigzag coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)
NAT2ZZ = np.argsort(ZIGZAG).astype(np.int32)  # natural pos -> zigzag idx


@functools.lru_cache()
def _idct_kron_np() -> np.ndarray:
    t = np.zeros((8, 8), np.float32)
    for u in range(8):
        for x in range(8):
            c = 0.35355339059327373 if u == 0 else 0.5
            t[u, x] = c * np.cos((2 * x + 1) * u * np.pi / 16)
    return np.kron(t, t).astype(np.float32)  # (64, 64): [uv, yx]


_CONSTS: dict = {}


def _const(name: str, device: torch.device) -> torch.Tensor:
    """Per-device cached constant tensors."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        if name == "kron":
            arr = _idct_kron_np()
        elif name == "nat2zz":
            arr = NAT2ZZ.astype(np.int64)
        else:
            raise KeyError(name)
        t = torch.from_numpy(arr).to(device)
        _CONSTS[key] = t
    return t


def blocks_to_pixels(coeffs: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(B, N, 64) int coefficients + (B, 64) quant -> (B, N, 64) f32
    samples, level-shifted (+128) and rounded/clamped to the uint8 grid."""
    deq = coeffs.to(torch.float32) * qtab.to(torch.float32)[:, None, :]
    pix = deq @ _const("kron", coeffs.device) + 128.0
    return torch.clamp(torch.round(pix), 0.0, 255.0)


def plane_from_blocks(pix: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(B, bh*bw, 64) block samples -> (B, bh*8, bw*8) plane."""
    b = pix.shape[0]
    return (pix.reshape(b, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(b, bh * 8, bw * 8))


def _shift_up(x):    # row i-1 with edge replication (rows = dim -2)
    return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)


def _shift_down(x):
    return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)


def _shift_left(x):  # column j-1 with edge replication
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def _shift_right(x):
    return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)


def upsample2x_triangle(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2 'fancy' 2x upsample, integer-exact: (B, h, w) uint8-
    grid values -> (B, 2h, 2w) f32. Vertical 3:1 sums, then the
    horizontal triangle with libjpeg's biases (+8 even, +7 odd columns)
    and >> 4; edge replication reproduces libjpeg's border cases."""
    ci = c.to(torch.int32)
    b, h, w = ci.shape
    v_near = 3 * ci
    sum_up = v_near + _shift_up(ci)      # output row 2i
    sum_dn = v_near + _shift_down(ci)    # output row 2i+1
    t = torch.stack([sum_up, sum_dn], dim=2).reshape(b, 2 * h, w)
    t3 = 3 * t
    even = (t3 + _shift_left(t) + 8) >> 4
    odd = (t3 + _shift_right(t) + 7) >> 4
    return torch.stack([even, odd], dim=3).reshape(b, 2 * h, 2 * w).to(
        torch.float32)


def upsample2x_h_triangle(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v1 'fancy' horizontal 2x upsample (4:2:2 chroma)."""
    ci = c.to(torch.int32)
    b, h, w = ci.shape
    t3 = 3 * ci
    even = (t3 + _shift_left(ci) + 1) >> 2
    odd = (t3 + _shift_right(ci) + 2) >> 2
    return torch.stack([even, odd], dim=3).reshape(b, h, 2 * w).to(
        torch.float32)


def upsample2x_v_nearest(c: torch.Tensor) -> torch.Tensor:
    """Vertical 2x nearest upsample (4:4:0 chroma)."""
    return torch.repeat_interleave(c.to(torch.float32), 2, dim=-2)


def upsample_chroma(c: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """Upsample (B, h, w) chroma planes by the luma sampling factors:
    (2,2)=4:2:0 fancy triangle, (2,1)=4:2:2 horizontal fancy,
    (1,2)=4:4:0 vertical nearest, (1,1)=4:4:4 identity."""
    if (hs, vs) == (2, 2):
        return upsample2x_triangle(c)
    if (hs, vs) == (2, 1):
        return upsample2x_h_triangle(c)
    if (hs, vs) == (1, 2):
        return upsample2x_v_nearest(c)
    if (hs, vs) == (1, 1):
        return c.to(torch.float32)
    raise ValueError(f"unsupported chroma layout {(hs, vs)}")


def ycbcr_to_rgb01(y: torch.Tensor, cb: torch.Tensor,
                   cr: torch.Tensor) -> torch.Tensor:
    """f32 (B, H, W) planes -> (B, H, W, 3) RGB in [0, 1], uint8-
    quantized (round half to even, clip to [0, 255], then / 255)."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0.0, 255.0) * (1.0 / 255.0)


def components_to_rgb01(ycoef: torch.Tensor, cbcoef: torch.Tensor,
                        crcoef: torch.Tensor, qy: torch.Tensor,
                        qcb: torch.Tensor, qcr: torch.Tensor, height: int,
                        width: int, hs: int, vs: int) -> torch.Tensor:
    """Dequant + IDCT + upsample + colour for a batch of frames: (B, *,
    64) coefficients per component in raster order and (B, 64) quant
    tables -> (B, H, W, 3) f32."""
    yb_h, yb_w = height // 8, width // 8
    cb_h, cb_w = height // vs // 8, width // hs // 8
    ypix = plane_from_blocks(blocks_to_pixels(ycoef, qy), yb_h, yb_w)
    cbp = plane_from_blocks(blocks_to_pixels(cbcoef, qcb), cb_h, cb_w)
    crp = plane_from_blocks(blocks_to_pixels(crcoef, qcr), cb_h, cb_w)
    return ycbcr_to_rgb01(ypix, upsample_chroma(cbp, hs, vs),
                          upsample_chroma(crp, hs, vs))


def coeffs_to_rgb01(coeff: torch.Tensor, qy: torch.Tensor,
                    qcb: torch.Tensor, qcr: torch.Tensor, height: int,
                    width: int, hs: int, vs: int) -> torch.Tensor:
    """:func:`components_to_rgb01` of (B, NB, 64) coefficients in
    Y|Cb|Cr raster order. ``qcr`` may differ from ``qcb`` (3-table JPEGs
    are legal)."""
    nyb = (height // 8) * (width // 8)
    ncb = (height // vs // 8) * (width // hs // 8)
    return components_to_rgb01(coeff[:, :nyb], coeff[:, nyb:nyb + ncb],
                               coeff[:, nyb + ncb:], qy, qcb, qcr, height,
                               width, hs, vs)


def decode420_batch(ycoef: torch.Tensor, cbcoef: torch.Tensor,
                    crcoef: torch.Tensor, qy: torch.Tensor, qc: torch.Tensor,
                    height: int, width: int) -> torch.Tensor:
    """Device decode of a batch of 4:2:0 frames (the coefficient path):
    (B, Yb, 64) / (B, Cb, 64) int16 coefficients in natural order and
    (B, 64) tables -> (B, H, W, 3) f32 RGB in [0, 1]. One chroma table
    ``qc`` dequantizes both Cb and Cr (native_jpeg.CoeffImage carries
    one; the host refuses files whose Cb and Cr tables differ). H and W
    are multiples of 16."""
    return components_to_rgb01(ycoef, cbcoef, crcoef, qy, qc, qc, height,
                               width, 2, 2)


def decode420(ycoef: torch.Tensor, cbcoef: torch.Tensor,
              crcoef: torch.Tensor, qy: torch.Tensor, qc: torch.Tensor,
              height: int, width: int) -> torch.Tensor:
    """:func:`decode420_batch` of one frame: (Yb, 64) / (Cb, 64) and
    (64,) tables -> (H, W, 3)."""
    return decode420_batch(ycoef[None], cbcoef[None], crcoef[None],
                           qy[None], qc[None], height, width)[0]


# ---------------------------------------------------------------------------
# Sparse wire streams (native fd_jpeg_sparse5 / fd_jpeg_sparse6)
# ---------------------------------------------------------------------------

def unpack_nibbles(nib: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 -> (..., 2N) int32 in [-8, 7]; entry 2i is the low
    nibble of byte i (two's complement 4-bit)."""
    x = nib.to(torch.int32)
    pair = torch.stack([x & 15, x >> 4], dim=-1).reshape(*nib.shape[:-1], -1)
    return (pair ^ 8) - 8


def unpack_nibbles_u(nib: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 -> (..., 2N) int32 in [0, 15] (unsigned nibbles:
    the per-block mask byte counts)."""
    x = nib.to(torch.int32)
    return torch.stack([x & 15, x >> 4], dim=-1).reshape(*nib.shape[:-1], -1)


def unpack_3bit(tri: torch.Tensor) -> torch.Tensor:
    """(..., TCAP) uint8 (TCAP % 3 == 0) -> (..., TCAP*8//3) int32 in
    [-4, 3]: 3-bit two's complement symbols packed continuously little-
    endian (value k = bits [3k, 3k+3)), 8 symbols per 3-byte group."""
    g = tri.reshape(*tri.shape[:-1], -1, 3).to(torch.int32)
    w = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
    syms = torch.stack([(w >> (3 * k)) & 7 for k in range(8)], dim=-1)
    flat = syms.reshape(*tri.shape[:-1], -1)
    return (flat ^ 4) - 4


def excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``dim`` (int64)."""
    x = x.to(torch.int64)
    return torch.cumsum(x, dim=dim) - x


def take(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched ``s[b, clamp(idx[b, ...], 0, cap - 1)]`` -> int32."""
    b, cap = s.shape
    flat = torch.clamp(idx, 0, cap - 1).reshape(b, -1).to(torch.int64)
    return torch.gather(s, 1, flat).reshape(idx.shape).to(torch.int32)


def _per_component_cumsum(delta: torch.Tensor, yb: int, cb: int):
    return torch.cat([
        torch.cumsum(delta[:, :yb], dim=1),
        torch.cumsum(delta[:, yb:yb + cb], dim=1),
        torch.cumsum(delta[:, yb + cb:], dim=1),
    ], dim=1).to(torch.int32)


def dc_reconstruct(dc8: torch.Tensor, dcesc: torch.Tensor, yb: int,
                   cb: int) -> torch.Tensor:
    """v5 DC chain: (B, NB) int8 raster deltas (-128 = next int16
    escape) -> (B, NB) int32 DC; the per-component cumsum undoes JPEG's
    DC prediction."""
    d = dc8.to(torch.int32)
    flag = d == -128
    delta = torch.where(flag, take(dcesc, excl_cumsum(flag)), d)
    return _per_component_cumsum(delta, yb, cb)


def dc_reconstruct6(dc4: torch.Tensor, dcesc8: torch.Tensor,
                    dcesc16: torch.Tensor, yb: int, cb: int) -> torch.Tensor:
    """v6 DC chain: (B, ceil(NB/2)) packed 4-bit deltas (-8 = next dcesc8
    entry; -128 there = next dcesc16 entry) -> (B, NB) int32 DC."""
    nb = yb + 2 * cb
    d = unpack_nibbles(dc4)[:, :nb]
    f1 = d == -8
    d1 = torch.where(f1, take(dcesc8, excl_cumsum(f1)), d)
    f2 = f1 & (d1 == -128)
    delta = torch.where(f2, take(dcesc16, excl_cumsum(f2)), d1)
    return _per_component_cumsum(delta, yb, cb)


def mask_bits(mb: torch.Tensor) -> torch.Tensor:
    """(..., 8) mask bytes -> (..., 64) int32 bits, bit k of byte j at
    position 8j + k (zigzag order; numpy unpackbits 'little')."""
    z = torch.arange(64, device=mb.device)
    return (mb.to(torch.int32)[..., z >> 3] >> (z & 7)) & 1


def _sparse_ac_zz(plen, maskstream, vals, esc8, esc16, nb: int,
                  sentinel: int) -> torch.Tensor:
    """Shared v5/v6 AC reconstruction (gather formulation) -> (B, NB, 64)
    int32 zigzag-order AC values. ``vals`` is the unpacked value stream
    with level-1 escape mark ``sentinel`` (-8 nibbles / -4 3-bit)."""
    dev = plen.device
    ln = unpack_nibbles_u(plen)[:, :nb]                        # (B, NB)
    moff = excl_cumsum(ln)
    j8 = torch.arange(8, device=dev)
    mb = torch.where(j8 < ln[..., None],
                     take(maskstream, moff[..., None] + j8), 0)
    bits = mask_bits(mb)                                       # (B, NB, 64)
    nnz_blk = bits.sum(-1)
    block_off = excl_cumsum(nnz_blk)
    rank = excl_cumsum(bits)
    c = take(vals, block_off[..., None] + rank) * bits
    # level-1 escapes: value-stream sentinel -> esc8 stream
    esc1 = c == sentinel
    eoff1 = excl_cumsum(esc1.sum(-1))
    c1 = torch.where(esc1, take(esc8, eoff1[..., None] + excl_cumsum(esc1)),
                     c)
    # level-2 escapes: esc8 sentinel -128 -> esc16 stream
    esc2 = esc1 & (c1 == -128)
    eoff2 = excl_cumsum(esc2.sum(-1))
    return torch.where(
        esc2, take(esc16, eoff2[..., None] + excl_cumsum(esc2)), c1)


def _with_dc_natural(ac_zz: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    # zigzag lane 0 IS the DC position (ZIGZAG[0] == 0)
    coeff_zz = torch.cat([dc[..., None], ac_zz[..., 1:]], dim=-1)
    return coeff_zz[..., _const("nat2zz", ac_zz.device)]


def sparse5_to_coeffs(plen, maskstream, dc8, nibvals, esc8, esc16, dcesc,
                      yb: int, cb: int) -> torch.Tensor:
    """v5 streams -> (B, NB, 64) int32 NATURAL-order coefficients.
    ``nibvals`` is the already-unpacked nibble stream (unpack_nibbles).
    Bit-exact inverse of fd_jpeg.cpp decode_sparse5."""
    nb = dc8.shape[1]
    ac = _sparse_ac_zz(plen, maskstream, nibvals, esc8, esc16, nb, -8)
    return _with_dc_natural(ac, dc_reconstruct(dc8, dcesc, yb, cb))


def sparse6_to_coeffs(plen, maskstream, dc4, trivals, esc8, esc16, dcesc8,
                      dcesc16, yb: int, cb: int) -> torch.Tensor:
    """v6 streams -> (B, NB, 64) int32 NATURAL-order coefficients.
    ``trivals`` is the already-unpacked 3-bit stream (unpack_3bit).
    Bit-exact inverse of fd_jpeg.cpp decode_sparse6."""
    nb = yb + 2 * cb
    ac = _sparse_ac_zz(plen, maskstream, trivals, esc8, esc16, nb, -4)
    return _with_dc_natural(
        ac, dc_reconstruct6(dc4, dcesc8, dcesc16, yb, cb))
