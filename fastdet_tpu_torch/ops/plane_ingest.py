"""Fused 4:2:0 plane ingest — kernel B2.

Replaces the TPU kernel ``fastdet_tpu/ops/pallas/plane_ingest.py``
(``_kernel``, launched by ``plane_ingest`` / ``plane_ingest_batch``) with
a hand-written CUDA kernel, ``csrc/plane_ingest.cu``: libjpeg's "fancy"
h2v2 chroma upsample as an integer stencil, YCbCr->RGB, round half to
even, clip, /255 — one pass, NHWC float32 out. One CTA makes a pair of
output rows from three chroma rows staged in shared memory, four pixels
per thread, and writes the rows back with 16-byte stores; any even H
and W and any batch stride are taken. Its plain version is
jpeg_device.upsample2x_triangle + ycbcr_to_rgb01; the two agree bit for
bit, and both agree bit for bit with the JAX package's kernel and XLA
path (tests/test_torch_plane_ingest.py).
"""

from __future__ import annotations

import threading

import torch

from fastdet_tpu_torch.ops import _build
from fastdet_tpu_torch.ops import jpeg_device as jd

#: launches of the CUDA kernel (the plain version does not count; a
#: launch captured into a CUDA graph counts at each replay)
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


def add_launches(n: int) -> None:
    """Count ``n`` launches of the kernel."""
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += n


def plane_ingest_plain(y: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """Kernel B2's plain version: Y (B, H, W) + Cb/Cr (B, H/2, W/2) uint8
    -> (B, H, W, 3) float32 RGB in [0, 1]."""
    return jd.ycbcr_to_rgb01(y.to(torch.float32),
                             jd.upsample2x_triangle(cb),
                             jd.upsample2x_triangle(cr))


def plane_ingest_batch(y: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on a batch: Y (B, H, W) + Cb/Cr (B, H/2, W/2) uint8 ->
    (B, H, W, 3) float32. The planes may be views into one packed row
    per frame (any batch stride; each plane contiguous within a frame,
    Cb and Cr with one batch stride). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if all(t.device.type == "cpu" for t in (y, cb, cr)):
        return plane_ingest_plain(y, cb, cr)
    dev = y.device
    if dev.type != "cuda" or cb.device != dev or cr.device != dev:
        raise ValueError("plane_ingest_batch: all planes must be on one "
                         "CUDA device (or all on the CPU)")
    b, h, w = y.shape
    if h % 2 or w % 2 or cb.shape != (b, h // 2, w // 2) \
            or cr.shape != cb.shape:
        raise ValueError(f"plane_ingest_batch: shapes {tuple(y.shape)}, "
                         f"{tuple(cb.shape)}, {tuple(cr.shape)} are not "
                         f"4:2:0 planes")
    for t in (y, cb, cr):
        if t.dtype != torch.uint8 or t.stride()[1:] != (t.shape[2], 1):
            raise ValueError("plane_ingest_batch: planes must be uint8, "
                             "contiguous within each frame")
    if cb.stride(0) != cr.stride(0):
        raise ValueError("plane_ingest_batch: Cb and Cr need one batch "
                         "stride")
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fd_plane_ingest(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(),
            b, h, w, y.stride(0), cb.stride(0), stream)
    _build.check("fd_plane_ingest", rc)
    if not _build.captured(add_launches):
        add_launches(1)
    return out
