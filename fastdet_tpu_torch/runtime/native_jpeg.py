"""ctypes binding for the first-party C++ JPEG decoder (native/jpeg).

The port compiles ``native/jpeg/fd_jpeg.cpp`` itself at first use, into
its own build directory (ops/_build.py: ``c++ -O3 -fPIC -shared
-std=c++17``, the flags of native/jpeg/Makefile); it never loads a
library built elsewhere. A failed build raises :class:`NativeJpegBuildError`
— unlike NativeJpegUnavailable it is not caught by :func:`available` or
the engine's per-frame routing, so a serving process without its
decoder fails loudly instead of quietly degrading to pixel decode.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

from fastdet_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NativeJpegUnavailable(RuntimeError):
    pass


class NativeJpegBuildError(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                try:
                    path = _build.build_fd_jpeg()
                except _build.BuildError as e:
                    raise NativeJpegBuildError(str(e)) from e
                _lib = _bind(ctypes.CDLL(path))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every symbol's signature; raises AttributeError when the
    compiled sources and this binding disagree."""
    lib.fd_jpeg_info.restype = ctypes.c_int
    lib.fd_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fd_jpeg_decode_rgb.restype = ctypes.c_int
    lib.fd_jpeg_decode_rgb.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.fd_jpeg_scan_info.restype = ctypes.c_int
    lib.fd_jpeg_scan_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
    ]
    lib.fd_jpeg_planes420.restype = ctypes.c_int
    lib.fd_jpeg_planes420.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.fd_jpeg_planes.restype = ctypes.c_int
    lib.fd_jpeg_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fd_jpeg_coefficients.restype = ctypes.c_int
    lib.fd_jpeg_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.fd_jpeg_sparse5.restype = ctypes.c_int
    lib.fd_jpeg_sparse5.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # plen
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # maskstream
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,    # dc8
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # nib
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,    # esc8
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,   # esc16
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,   # dcesc
        ctypes.POINTER(ctypes.c_long),                   # counts[10]
        ctypes.POINTER(ctypes.c_uint16),                 # qtabs
    ]
    lib.fd_jpeg_sparse6.restype = ctypes.c_int
    lib.fd_jpeg_sparse6.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # plen
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # maskstream
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # dc4
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,   # tri
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,    # esc8
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,   # esc16
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,    # dcesc8
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long,   # dcesc16
        ctypes.POINTER(ctypes.c_long),                   # counts[10]
        ctypes.POINTER(ctypes.c_uint16),                 # qtabs
    ]
    # Output-contract check: a stale prebuilt library missing this symbol
    # (or with an older contract) must degrade to the fallback decoders —
    # scan_info's layout changes would otherwise return garbage silently.
    lib.fd_jpeg_abi.restype = ctypes.c_int
    lib.fd_jpeg_abi.argtypes = []
    abi = lib.fd_jpeg_abi()
    if abi != 6:
        raise AttributeError(f"fd_jpeg ABI {abi} != expected 6")
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeJpegUnavailable:
        return False


def info(data: bytes) -> Tuple[int, int, int]:
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.fd_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"fd_jpeg_info failed: rc={rc}")
    return w.value, h.value, c.value


class CoeffImage:
    """Entropy-decoded JPEG: per-component int16 coefficient planes.

    The host half of the on-device decode path (ops/jpeg_device.py).
    ``ycoef``/``cbcoef``/``crcoef`` are (num_blocks, 64) int16, natural
    frequency order; ``qy``/``qc`` the (64,) quant tables.
    """

    __slots__ = ("width", "height", "hmax", "vmax", "ycoef", "cbcoef",
                 "crcoef", "qy", "qc")

    def __init__(self, width, height, hmax, vmax, ycoef, cbcoef, crcoef, qy, qc):
        self.width = width
        self.height = height
        self.hmax = hmax
        self.vmax = vmax
        self.ycoef = ycoef
        self.cbcoef = cbcoef
        self.crcoef = crcoef
        self.qy = qy
        self.qc = qc

    @property
    def is_420(self) -> bool:
        return self.hmax == 2 and self.vmax == 2 and self.cbcoef is not None


def decode_coefficients(
    data: bytes, expected_size: Optional[Tuple[int, int]] = None
) -> CoeffImage:
    """Entropy-decode only (the serial part); the rest runs on device.

    ``expected_size`` (w, h), when given, is validated against the header
    BEFORE any plane allocation — the serving path passes the model input
    size so a crafted header claiming huge dimensions cannot trigger a
    multi-GB allocation from one UDP request.
    """
    lib = _load()
    info = _scan_info(data)
    w, h, ncomp = info[0], info[1], info[2]
    if expected_size is not None and (w, h) != tuple(expected_size):
        raise ValueError(f"unexpected image size {w}x{h}")
    if ncomp != 3:
        raise ValueError("coefficient path supports 3-component JPEGs only")
    planes = []
    for i in range(3):
        bw, bh = info[5 + 2 * i], info[6 + 2 * i]
        planes.append(np.zeros((bh * bw, 64), np.int16))
    q = np.zeros((4, 64), np.uint16)
    rc = lib.fd_jpeg_coefficients(
        data, len(data),
        planes[0].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), planes[0].size,
        planes[1].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), planes[1].size,
        planes[2].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), planes[2].size,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if rc != 0:
        raise ValueError(f"fd_jpeg_coefficients failed: rc={rc}")
    if not np.array_equal(q[info[12]], q[info[13]]):
        # CoeffImage carries one chroma table; a (legal, rare) file with
        # a distinct Cr table would be dequantized wrongly — callers fall
        # back (the sparse and plane paths both support 3 tables).
        raise ValueError("distinct Cb/Cr quant tables")
    return CoeffImage(
        width=w, height=h, hmax=info[3], vmax=info[4],
        ycoef=planes[0], cbcoef=planes[1], crcoef=planes[2],
        qy=q[info[11]].astype(np.float32), qc=q[info[12]].astype(np.float32),
    )


#: Subsampling layouts the plane ingest supports, keyed by the luma
#: sampling factors (hs, vs): (2,2)=4:2:0, (2,1)=4:2:2, (1,2)=4:4:0,
#: (1,1)=4:4:4. Chroma planes come out at (H//vs, W//hs).
PLANE_LAYOUTS = ((2, 2), (2, 1), (1, 2), (1, 1))


def _scan_info(data: bytes) -> "ctypes.Array":
    """One native header parse -> the 14-int fd_jpeg_scan_info layout."""
    lib = _load()
    info = (ctypes.c_int * 14)()
    rc = lib.fd_jpeg_scan_info(data, len(data), info)
    if rc != 0:
        raise ValueError(f"fd_jpeg_scan_info failed: rc={rc}")
    return info


def scan_layout(
    data: bytes, expected_size: Optional[Tuple[int, int]] = None
) -> Tuple[int, int, int, int]:
    """Header-only probe: (w, h, hs, vs) for the plane path.

    No entropy decode — used to group a batch by subsampling layout
    and validate dimensions BEFORE allocating anything. Raises
    ValueError for non-3-component files, unexpected sizes, or layouts
    outside PLANE_LAYOUTS.
    """
    return _layout_from_info(_scan_info(data), expected_size)


def _layout_from_info(
    info, expected_size: Optional[Tuple[int, int]] = None
) -> Tuple[int, int, int, int]:
    w, h, ncomp, hs, vs = info[0], info[1], info[2], info[3], info[4]
    if expected_size is not None and (w, h) != tuple(expected_size):
        raise ValueError(f"unexpected image size {w}x{h}")
    if ncomp != 3 or (hs, vs) not in PLANE_LAYOUTS:
        raise ValueError(f"unsupported plane layout ncomp={ncomp} {(hs, vs)}")
    # info[3]/info[4] are the maxima over ALL components; the plane path
    # additionally requires luma to carry them and chroma to be exactly
    # (1,1) — verify via the per-component block dims so a legal-but-odd
    # file (e.g. chroma sampled above luma) is rejected here, before any
    # batch buffers are allocated for the wrong shapes.
    mcux = -(-w // (8 * hs))
    mcuy = -(-h // (8 * vs))
    if (info[5], info[6]) != (mcux * hs, mcuy * vs):
        raise ValueError("luma does not carry the max sampling factors")
    for i in (1, 2):
        if (info[5 + 2 * i], info[6 + 2 * i]) != (mcux, mcuy):
            raise ValueError("chroma sampling factors are not (1,1)")
    return w, h, hs, vs


def decode_planes_into(
    data: bytes, y: np.ndarray, cb: np.ndarray, cr: np.ndarray
) -> None:
    """Decode directly into caller-provided C-contiguous uint8 views
    (e.g. slices of a batch array) — no per-frame allocation or copy.
    Shapes must match the layout from scan_layout: y (H, W), chroma
    (H//vs, W//hs). Releases the GIL during the native call, so a batch
    can be decoded in parallel across threads.
    """
    lib = _load()
    # Validate BEFORE the native call: the C side only checks capacity,
    # so wrong dtype/strides/shape would silently scramble caller memory.
    w, h, hs, vs = scan_layout(data)
    expect = {"y": (h, w), "cb": (h // vs, w // hs), "cr": (h // vs, w // hs)}
    for name, a in (("y", y), ("cb", cb), ("cr", cr)):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError(f"{name} plane buffer must be contiguous uint8")
        if a.shape != expect[name]:
            raise ValueError(
                f"{name} plane buffer shape {a.shape} != {expect[name]} "
                f"for this JPEG's layout {(hs, vs)}"
            )
    layout = (ctypes.c_int * 4)()
    rc = lib.fd_jpeg_planes(
        data, len(data),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), y.size,
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cb.size,
        cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cr.size,
        layout,
    )
    if rc != 0:
        raise ValueError(f"fd_jpeg_planes failed: rc={rc}")


def decode_planes(
    data: bytes, expected_size: Optional[Tuple[int, int]] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Decode a baseline JPEG to raw subsampled planes.

    Returns (y, cb, cr, (hs, vs)): Y at (H, W) uint8, chroma at
    (H//vs, W//hs). Host does Huffman+IDCT; upsample/color run on device.
    Shipping subsampled planes cuts host->device bytes vs RGB888
    (1.5 B/px for 4:2:0, 2 B/px for 4:2:2/4:4:0). Raises ValueError for
    unsupported layouts (grayscale, 4:1:1, odd sizes) — caller falls back.

    ``expected_size`` (w, h) is checked against the header before any
    allocation (see decode_coefficients).
    """
    w, h, hs, vs = scan_layout(data, expected_size)
    y = np.empty((h, w), np.uint8)
    cb = np.empty((h // vs, w // hs), np.uint8)
    cr = np.empty((h // vs, w // hs), np.uint8)
    decode_planes_into(data, y, cb, cr)
    return y, cb, cr, (hs, vs)


def decode_planes420(
    data: bytes, expected_size: Optional[Tuple[int, int]] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4:2:0-only plane decode: Y (H,W), Cb/Cr (H/2,W/2) uint8."""
    y, cb, cr, (hs, vs) = decode_planes(data, expected_size)
    if (hs, vs) != (2, 2):
        raise ValueError("not a 4:2:0 JPEG")
    return y, cb, cr


class SparseCounts(NamedTuple):
    """The 10-long counts block both sparse emitters fill (fd_jpeg.cpp
    kSparseCounts): TRUE content totals — written even on capacity
    overflow — plus the OTHER wire format's escape predictors, so the
    engine's tier router can evaluate a format-crossing retry (std tier
    ships v6, dense tier ships v5) without a second entropy decode."""

    ac: int        # AC value count (= mask popcount)
    e8: int        # this format's level-1 AC escapes (v5 |v|>7, v6 |v|>3)
    e16: int       # |v|>127 AC escapes (same meaning in both formats)
    dce8: int      # v6 |dc delta|>7 escapes (0 from the v5 emitter)
    dce16: int     # |dc delta|>127 escapes
    mask: int      # mask stream bytes
    flags: int     # bit0: own per-block caps violated; bit1: the other
    #                format's per-block caps would be violated
    ac_gt3: int    # v6 esc8-stream predictor
    ac_gt7: int    # v5 esc8-stream predictor
    dcd_gt7: int   # v6 dcesc8-stream predictor

    @property
    def own_block_cap(self) -> bool:
        return bool(self.flags & 1)

    @property
    def other_block_cap(self) -> bool:
        return bool(self.flags & 2)


class SparseCapacityExceeded(ValueError):
    """The frame has more nonzero coefficients (or escapes) than the
    caller's budget — retry a bigger tier or fall back to the plane
    path for this frame.

    ``counts`` (a SparseCounts) carries the emitter's true totals so
    the caller can size/route a retry; ``block_cap_violated`` means
    THIS format's per-block caps failed — the other format's caps may
    still hold (counts.other_block_cap), so a format-crossing retry
    can remain viable where a same-format one is pointless.
    """

    def __init__(self, msg: str, counts: "SparseCounts",
                 block_cap_violated: bool = False):
        super().__init__(msg)
        self.counts = counts
        self.block_cap_violated = block_cap_violated


def sparse_geometry(w: int, h: int, hs: int, vs: int) -> Tuple[int, int]:
    """(luma_blocks, chroma_blocks_per_plane) for the sparse path.

    Requires MCU-aligned dimensions (always true for the protocol's
    416x416 in every PLANE_LAYOUTS member) so the block grid carries no
    padding — the device reshapes blocks straight into planes.
    """
    if w % (8 * hs) or h % (8 * vs):
        raise ValueError(f"dimensions {w}x{h} not MCU-aligned for {(hs, vs)}")
    yb = (h // 8) * (w // 8)
    cb = (h // vs // 8) * (w // hs // 8)
    return yb, cb


def decode_sparse5_into(
    data: bytes,
    plen: np.ndarray,
    maskstream: np.ndarray,
    dc8: np.ndarray,
    nib: np.ndarray,
    esc8: np.ndarray,
    esc16: np.ndarray,
    dcesc: np.ndarray,
) -> Tuple[Tuple[int, int, int, int, int], np.ndarray, np.ndarray,
           np.ndarray]:
    """Entropy-decode into caller-provided nibble-sparse (v5) views.

    ``plen``: (ceil(NB/2),) uint8 — per-block mask byte-counts, 4-bit
    unsigned packed two per byte (block 2i = low nibble of byte i), each
    0..8. ``maskstream``: (MCAP,) uint8 — per block, the first plen
    bytes of its 64-bit nonzero bitmask in ZIGZAG coefficient order
    (bit j of the reconstructed little-endian word = zigzag index j),
    truncated after the highest set bit; bit 0 (DC) is always clear, so
    popcount(maskstream) is exactly the AC value count. Blocks ordered Y
    raster, Cb raster, Cr raster. ``dc8``: (NB,) int8 — quantized DC as
    a raster delta per component (-128 = take the next ``dcesc`` int16
    entry). ``nib``: (NCAP_BYTES,) uint8 — nonzero AC values in
    increasing ZIGZAG order, 4-bit two's complement packed two per byte
    (entry 2i = low nibble of byte i), 0x8 (-8) = take the next ``esc8``
    entry. ``esc8``: (E8CAP,) int8 (-128 = take the next ``esc16``
    entry). ``esc16``/``dcesc``: int16 streams. All views may alias one
    batch row (no per-frame allocation). Returns
    ((n_ac, n_esc8, n_esc16, n_dcesc, n_mask_bytes), qy, qcb, qcr) with
    the per-component quant tables as (64,) uint16 in natural order (qcb
    is qcr for the common shared-table case, but a legal JPEG may give
    Cr its own table). Raises SparseCapacityExceeded when the frame
    outgrows any stream budget or a block exceeds the per-block escape
    caps (32 at level 1, 16 at level 2 — fd_jpeg.cpp kMaxEsc8PerBlock /
    kMaxEsc16PerBlock, matching the kernel window widths; caller retries
    a bigger tier or falls back to the plane path), ValueError for
    malformed/unsupported files.
    """
    lib = _load()
    info = _scan_info(data)   # ONE header parse serves layout + tq needs
    w, h, hs, vs = _layout_from_info(info)
    yb, cb = sparse_geometry(w, h, hs, vs)
    nb = yb + 2 * cb
    if plen.dtype != np.uint8 or not plen.flags.c_contiguous:
        raise ValueError("plen must be contiguous uint8")
    if plen.shape != ((nb + 1) // 2,):
        raise ValueError(f"plen shape {plen.shape} != ({(nb + 1) // 2},)")
    if maskstream.dtype != np.uint8 or not maskstream.flags.c_contiguous:
        raise ValueError("maskstream must be contiguous uint8")
    if dc8.dtype != np.int8 or dc8.shape != (nb,) or not dc8.flags.c_contiguous:
        raise ValueError(f"dc8 must be contiguous ({nb},) int8")
    if nib.dtype != np.uint8 or not nib.flags.c_contiguous:
        raise ValueError("nib must be contiguous uint8")
    if esc8.dtype != np.int8 or not esc8.flags.c_contiguous:
        raise ValueError("esc8 must be contiguous int8")
    if esc16.dtype != np.int16 or not esc16.flags.c_contiguous:
        raise ValueError("esc16 must be contiguous int16")
    if dcesc.dtype != np.int16 or not dcesc.flags.c_contiguous:
        raise ValueError("dcesc must be contiguous int16")
    counts = (ctypes.c_long * 10)()
    q = np.zeros((4, 64), np.uint16)
    rc = lib.fd_jpeg_sparse5(
        data, len(data),
        plen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), plen.size,
        maskstream.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        maskstream.size,
        dc8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), dc8.size,
        nib.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nib.size,
        esc8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), esc8.size,
        esc16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), esc16.size,
        dcesc.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), dcesc.size,
        counts,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    cts = SparseCounts(*counts)
    if rc == -5:  # ERR_CAPACITY: valid frame, too dense for the budget
        raise SparseCapacityExceeded(
            f"ac={cts.ac}/{2 * nib.size} esc8={cts.e8}/{esc8.size} "
            f"esc16={cts.e16}/{esc16.size} dcesc={cts.dce16}/{dcesc.size} "
            f"mask={cts.mask}/{maskstream.size} flags={cts.flags}",
            cts,
            block_cap_violated=cts.own_block_cap,
        )
    if rc != 0:
        raise ValueError(f"fd_jpeg_sparse5 failed: rc={rc}")
    return cts, q[info[11]], q[info[12]], q[info[13]]


def decode_sparse6_into(
    data: bytes,
    plen: np.ndarray,
    maskstream: np.ndarray,
    dc4: np.ndarray,
    tri: np.ndarray,
    esc8: np.ndarray,
    esc16: np.ndarray,
    dcesc8: np.ndarray,
    dcesc16: np.ndarray,
) -> Tuple["SparseCounts", np.ndarray, np.ndarray, np.ndarray]:
    """Entropy-decode into caller-provided 3-bit-sparse (v6) views.

    ``plen``/``maskstream`` are exactly the v5 streams (see
    decode_sparse5_into). ``dc4``: (ceil(NB/2),) uint8 — DC raster
    deltas as 4-bit two's complement nibbles (block 2i = low nibble of
    byte i), -8 = take the next ``dcesc8`` entry (int8; -128 there =
    take the next ``dcesc16`` int16 entry). ``tri``: (TCAP,) uint8 —
    nonzero AC values in increasing ZIGZAG order as 3-bit two's
    complement symbols packed continuously little-endian (value k =
    bits [3k, 3k+3); 8 values per 3 bytes), 100b (-4) = take the next
    ``esc8`` entry (int8; -128 there = next ``esc16`` int16 entry).
    Same return/raise contract as decode_sparse5_into; cites
    fd_jpeg.cpp decode_sparse6 for the wire layout.
    """
    lib = _load()
    info = _scan_info(data)
    w, h, hs, vs = _layout_from_info(info)
    yb, cb = sparse_geometry(w, h, hs, vs)
    nb = yb + 2 * cb
    if plen.dtype != np.uint8 or not plen.flags.c_contiguous:
        raise ValueError("plen must be contiguous uint8")
    if plen.shape != ((nb + 1) // 2,):
        raise ValueError(f"plen shape {plen.shape} != ({(nb + 1) // 2},)")
    if maskstream.dtype != np.uint8 or not maskstream.flags.c_contiguous:
        raise ValueError("maskstream must be contiguous uint8")
    if (dc4.dtype != np.uint8 or dc4.shape != ((nb + 1) // 2,)
            or not dc4.flags.c_contiguous):
        raise ValueError(f"dc4 must be contiguous ({(nb + 1) // 2},) uint8")
    if tri.dtype != np.uint8 or not tri.flags.c_contiguous:
        raise ValueError("tri must be contiguous uint8")
    if esc8.dtype != np.int8 or not esc8.flags.c_contiguous:
        raise ValueError("esc8 must be contiguous int8")
    if esc16.dtype != np.int16 or not esc16.flags.c_contiguous:
        raise ValueError("esc16 must be contiguous int16")
    if dcesc8.dtype != np.int8 or not dcesc8.flags.c_contiguous:
        raise ValueError("dcesc8 must be contiguous int8")
    if dcesc16.dtype != np.int16 or not dcesc16.flags.c_contiguous:
        raise ValueError("dcesc16 must be contiguous int16")
    counts = (ctypes.c_long * 10)()
    q = np.zeros((4, 64), np.uint16)
    rc = lib.fd_jpeg_sparse6(
        data, len(data),
        plen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), plen.size,
        maskstream.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        maskstream.size,
        dc4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dc4.size,
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), tri.size,
        esc8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), esc8.size,
        esc16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), esc16.size,
        dcesc8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), dcesc8.size,
        dcesc16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        dcesc16.size,
        counts,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    cts = SparseCounts(*counts)
    if rc == -5:  # ERR_CAPACITY: valid frame, too dense for the budget
        raise SparseCapacityExceeded(
            f"ac={cts.ac} (tri cap {tri.size}B) esc8={cts.e8}/{esc8.size} "
            f"esc16={cts.e16}/{esc16.size} dcesc8={cts.dce8}/{dcesc8.size} "
            f"dcesc16={cts.dce16}/{dcesc16.size} "
            f"mask={cts.mask}/{maskstream.size} flags={cts.flags}",
            cts,
            block_cap_violated=cts.own_block_cap,
        )
    if rc != 0:
        raise ValueError(f"fd_jpeg_sparse6 failed: rc={rc}")
    return cts, q[info[11]], q[info[12]], q[info[13]]


def decode_rgb(data: bytes) -> np.ndarray:
    """Decode baseline JPEG bytes to RGB uint8 (H, W, 3)."""
    lib = _load()
    w, h, _ = info(data)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.fd_jpeg_decode_rgb(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes,
    )
    if rc != 0:
        raise ValueError(f"fd_jpeg_decode_rgb failed: rc={rc}")
    return out
