"""Build the port's native libraries from the sources in the checkout.

Two shared libraries, each built at first use into a gitignored
directory and loaded with ctypes:

- the CUDA kernels (``csrc/*.cu`` and their header): ONE ``nvcc`` call for
  ``sm_90a`` with a plain C interface — no PyTorch headers, so the build
  takes seconds and needs neither ninja nor ``torch.utils.cpp_extension``;
- the host JPEG entropy decoder (``native/jpeg/fd_jpeg.cpp``): one
  ``c++`` call with the flags of ``native/jpeg/Makefile``.

Each library's file name carries a digest of its sources and flags, so
a stale build is never loaded. Concurrent builders (pytest workers)
serialize on an ``flock``, which the kernel releases when a process
dies — an interrupted build leaves no lock behind. A failed build
raises :class:`BuildError`; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterator, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

KERNEL_SOURCES = ("sparse_ingest.cu", "plane_ingest.cu", "ingest_stages.cu")
KERNEL_HEADERS = ("ingest_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

#: compiler output of the builds this process ran, by library name
#: (``-Xptxas -v`` register/spill lines for the kernels)
BUILD_LOG: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (CUDA_HOME/bin or PATH)")
    return found


def _digest(sources: Sequence[str], flags: Sequence[str]) -> str:
    h = hashlib.sha1()
    for path in sources:
        with open(path, "rb") as fp:
            h.update(fp.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def build_shared(name: str, compiler: List[str], sources: Sequence[str],
                 flags: Sequence[str], timeout: float = 600.0,
                 headers: Sequence[str] = ()) -> str:
    """Compile ``sources`` into ``BUILD_DIR/lib<name>-<digest>.so`` unless
    that file exists; returns its path. The digest covers the sources,
    the ``headers`` they include and the flags."""
    for path in (*sources, *headers):
        if not os.path.exists(path):
            raise BuildError(f"{name}: missing source {path}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(
        BUILD_DIR, f"lib{name}-{_digest([*sources, *headers], flags)}.so")
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [*compiler, *flags, "-o", tmp, *sources]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"{name}: {' '.join(cmd)}: {e}") from e
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise BuildError(f"{name}: {' '.join(cmd)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def build_kernels() -> str:
    """The CUDA kernels' shared library (nvcc, sm_90a)."""
    return build_shared(
        "fd_kernels", [nvcc_path()],
        [os.path.join(CSRC_DIR, s) for s in KERNEL_SOURCES], NVCC_FLAGS,
        headers=[os.path.join(CSRC_DIR, h) for h in KERNEL_HEADERS])


def build_fd_jpeg() -> str:
    """The host JPEG decoder's shared library (c++)."""
    cxx = os.environ.get("CXX", "c++")
    return build_shared(
        "fd_jpeg", [cxx],
        [os.path.join(REPO_DIR, "native", "jpeg", "fd_jpeg.cpp")], CXX_FLAGS,
        timeout=300.0)


def clean() -> None:
    """Delete every built library (stale builds included)."""
    shutil.rmtree(BUILD_DIR, ignore_errors=True)


_KERNELS = None
_KERNELS_LOCK = threading.Lock()


def kernels():
    """The loaded kernel library (ctypes), built on first call.

    C entries take device pointers and the stream as ``void*`` and
    return ``cudaGetLastError()`` after their launch; :func:`check`
    raises on a nonzero code."""
    global _KERNELS
    with _KERNELS_LOCK:
        if _KERNELS is None:
            _KERNELS = _bind_kernels(ctypes.CDLL(build_kernels()))
    return _KERNELS


def _bind_kernels(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fd_sparse_reconstruct.restype = i
    lib.fd_sparse_reconstruct.argtypes = [
        p, p, p, p, p, p, p,     # offs, maskstream, vals, esc8, esc16,
                                 # dc (or None), out
        i, i, i, i, i, i, i, i,  # B, NB, MCAP, NV, E8, E16, sentinel, bt
        p]                       # stream
    lib.fd_plane_ingest.restype = i
    lib.fd_plane_ingest.argtypes = [
        p, p, p, p,              # y, cb, cr, out
        i, i, i,                 # B, H, W
        ctypes.c_long, ctypes.c_long,  # batch strides of y, cb/cr
        p]                       # stream
    lib.fd_ingest_stages.restype = i
    lib.fd_ingest_stages.argtypes = [
        p, p, p, p,              # ms, vals, moffx, probe
        p, p, p, p, p, p, p,     # mwin, win, seg, bits, rank, acc, nat
        i, i, i, i, i,           # B, NB, bt, mask length, value length
        p]                       # stream
    lib.fd_ingest_nat_gated.restype = i
    lib.fd_ingest_nat_gated.argtypes = [
        p, p, p, p, p, p,        # ms, vals, moffx, probe, eoff1, out
        i, i, i, i, i, i,        # B, NB, bt, sub-tile, mask length,
                                 # value length
        p]                       # stream
    lib.fd_cuda_error_string.restype = ctypes.c_char_p
    lib.fd_cuda_error_string.argtypes = [i]
    return lib


def check(name: str, rc: int) -> None:
    if rc != 0:
        msg = kernels().fd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")


_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing() -> Iterator[Dict[Callable[[int], None], int]]:
    """While a CUDA graph is captured on this thread: yields a tally
    {counter: launches} that :func:`captured` fills in place of the
    kernels' launch counters. A captured launch runs at each replay, and
    the replay adds the tally to the counters (``counter(n)``)."""
    tally: Dict[Callable[[int], None], int] = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def captured(counter: Callable[[int], None]) -> bool:
    """Tally one launch for ``counter`` if this thread is capturing (see
    :func:`capturing`); False when the launch runs now."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None:
        return False
    tally[counter] = tally.get(counter, 0) + 1
    return True
