"""DetectionEngine: the inference pipeline behind every model service.

The port of the JAX package's runtime/engine.py to PyTorch on a CUDA
card. Per batch of frames:

    host entropy decode into ONE packed row per frame (native fd_jpeg)
    -> one host-to-device copy -> row unpack -> kernel B1 (sparse
    coefficient reconstruction) or kernel B2 (4:2:0 plane ingest)
    -> dequant + IDCT + upsample + colour -> YOLOv3 forward (bf16 by
    default) -> head decode -> top-K candidates -> soft-NMS
    -> (B, max_det, 7) packed results + response-wire record bytes

Engine properties kept from the JAX engine:

- **Batch buckets.** A request batch is padded to the nearest bucket;
  padded rows carry the 2.0 threshold sentinel so postprocess skips them.
- **Per-image thresholds** ride the packed row's tail (one copy per batch).
- **Ingest tiers.** The std tier ships wire format v6, the dense tier v5;
  frames too dense for std retry dense, frames too dense for both take the
  plane path — per frame, with tier memory per layout (see
  :meth:`DetectionEngine.detect_async_sparse`).
- **Async dispatch.** detect_async* return at once; a transfer worker
  copies the batch and runs the device program, and fetch()/fetch_wire()
  wait for it, so the serving loop decodes the next batch meanwhile.
- **Data-parallel serving.** Over n > 1 devices (every visible card by
  default) the buckets are rounded to multiples of n, every device holds
  a replica of the network, and each batch splits into n equal shards of
  rows: shard k is copied to device k and runs the whole pipeline there
  (kernels B1/B2 on that device's stream, the net, decode, soft-NMS and
  wire packing) on its own transfer worker, so the shards' soft-NMS loops
  sync each with its own card concurrently; fetch() gathers the rows in
  order. The JAX engine's shard_map over its 'dp' mesh does the same.
- **Lazy warm-up.** warmup() runs the first-choice programs (pixels at
  the smallest bucket, the std sparse tier) before it returns and the
  fallbacks (dense tier, planes, larger pixel buckets) on a background
  thread with its own stream per device; until a fallback is warm, the
  routers send its frames down the ladder that is (see warmup()).

- **Graph forms.** The space-to-depth stem rewrite (models/s2d.py) is
  applied in every mode wherever the stem matches; ``-m int8`` calibrates
  activation scales on the canonical graph first, then rewrites, then
  quantizes (models/quantize.py), as the JAX engine does.

- **Ingest routes.** detect_async_sparse (the server's), detect_async_planes,
  detect_async_jpeg (host entropy decode into int16 coefficients, device
  dequant + IDCT + colour: the coefficient path) and detect_async (host
  pixels).

- **CUDA graphs.** A part's prefix up to the top-K candidates makes no
  host sync; warmup() captures it for each program it warms, per shard,
  and the transfer worker replays it for every later part of that
  program (runtime/graphs.py). soft-NMS and the packing stay eager; a
  program never warmed, and every CPU tensor, runs eagerly.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import logging
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.models import quantize, s2d, weights
from fastdet_tpu_torch.models.yolov3 import ModelSpec, YoloNet
from fastdet_tpu_torch.ops import jpeg_device, nms, plane_ingest, postprocess
from fastdet_tpu_torch.ops import sparse_ingest
from fastdet_tpu_torch.parallel import mesh as mesh_lib
from fastdet_tpu_torch.runtime import graphs
from fastdet_tpu_torch.runtime import jpeg as jpeg_mod
from fastdet_tpu_torch.runtime import native_jpeg
from fastdet_tpu_torch.utils import profiling
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES
from fastdet_tpu_torch.utils.profiling import now_ns

logger = logging.getLogger(__name__)

ResultTuple = Tuple[int, float, float, float, float, float]


class SparseCaps(NamedTuple):
    """Static stream capacities of one (layout, tier) sparse row.

    ``fmt`` is the wire format (5 = nibble AC + int8 DC deltas, 6 =
    3-bit AC + 4-bit DC deltas — fd_jpeg.cpp decode_sparse5/6).
    ``vals`` is the packed AC value stream capacity in BYTES; ``e16`` /
    ``dce16`` are in int16 ENTRIES; ``dce8`` is 0 for fmt 5."""

    fmt: int
    nb: int
    mask: int
    vals: int
    e8: int
    e16: int
    dce8: int
    dce16: int


def device_result(x):
    """Unwrap a dispatch part to its packed (B, max_det, 7) tensor (parts
    hold Futures while the transfer worker runs the batch)."""
    x = x.result() if hasattr(x, "result") else x
    if isinstance(x, (tuple, list)):
        return x[0]
    return x


DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# f32 LE bytes of the padded-row threshold sentinel (2.0): above any
# real threshold, so batched postprocess early-exits on padding rows.
_THR_PAD_BYTES = np.frombuffer(np.float32(2.0).tobytes(), np.uint8)

_COMPUTE_DTYPES = {
    "bf16": torch.bfloat16,
    "f32": torch.float32,
    "int8": torch.float32,  # float boundaries stay f32; convs are int8
    # Reference -m values (the reference's ONNX Runtime providers) keep
    # being accepted and map onto the default mode.
    None: torch.bfloat16,
    "cpu": torch.bfloat16,
    "cuda": torch.bfloat16,
    "tensorrt": torch.bfloat16,
    "tpu": torch.bfloat16,
}


def _calibration_from_dir(size: int, n: int = 8) -> Optional[np.ndarray]:
    """Activation-calibration frames from FASTDET_CALIB_DIR, if set.

    Real frames from the target camera beat any synthetic default; the
    serving CLI keeps the reference's flags, so this deployment input
    rides an environment variable, as in the JAX engine. Files that fail
    to decode or are not (size, size, 3) are skipped."""
    d = os.environ.get("FASTDET_CALIB_DIR")
    if not d:
        return None
    imgs: List[np.ndarray] = []
    for p in sorted(glob.glob(os.path.join(d, "*"))):
        try:
            with open(p, "rb") as fp:
                img = jpeg_mod.decode_rgb(fp.read())
        except (OSError, ValueError):
            continue
        if img.shape == (size, size, 3):
            imgs.append(img)
        if len(imgs) >= n:
            break
    if not imgs:
        logger.warning(
            "FASTDET_CALIB_DIR=%s: no usable %dx%d images; falling back "
            "to synthetic calibration scenes", d, size, size)
        return None
    logger.info("int8 calibration: %d frames from %s", len(imgs), d)
    return np.stack(imgs)


def _default_calibration_images(size: int, n: int = 8) -> np.ndarray:
    """Smooth synthetic scenes for activation calibration when the caller
    provides none (the JAX engine's, draw for draw; prefer real frames
    from the target camera)."""
    rng = np.random.RandomState(0)
    out = np.zeros((n, size, size, 3), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        img = np.stack([100 + 100 * yy, 90 + 110 * xx,
                        80 + 90 * (1 - yy) * xx], -1)
        for _ in range(4):
            x0, y0 = rng.randint(0, size * 3 // 4, 2)
            w, h = rng.randint(size // 8, size // 3, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.randint(0, 255, 3)
        img += rng.randn(size, size, 3) * 8
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def sparse_budgets() -> Dict[str, Any]:
    """Per-tier sparse-ingest budgets from the environment: (mask bytes,
    AC values, esc8, esc16, dcesc8, dcesc16) per block, and each tier's
    wire format under "fmt". std ships v6 (3-bit AC), dense ships v5
    (nibbles); the defaults and the measurements behind them are the JAX
    engine's (fastdet_tpu/runtime/engine.py, tools/measure_sparse_stats.py):
    std sits a few % above camera-clean q90 content, dense catches
    photo-dense frames before the plane path."""
    env = os.environ.get
    return {
        "fmt": {"std": 6, "dense": 5},
        "std": (
            float(env("FASTDET_SPARSE_MASK_BUDGET", "4.6")),
            float(env("FASTDET_SPARSE_AC_BUDGET", "13.6")),
            float(env("FASTDET_SPARSE_ESC8_BUDGET", "0.66")),
            float(env("FASTDET_SPARSE_ESC16_BUDGET", "0.01")),
            float(env("FASTDET_SPARSE_DCESC8_BUDGET", "0.16")),
            float(env("FASTDET_SPARSE_DCESC_BUDGET", "0.02")),
        ),
        "dense": (
            float(env("FASTDET_SPARSE_MASK_BUDGET_DENSE", "6.0")),
            float(env("FASTDET_SPARSE_AC_BUDGET_DENSE", "15")),
            float(env("FASTDET_SPARSE_ESC8_BUDGET_DENSE", "4.2")),
            float(env("FASTDET_SPARSE_ESC16_BUDGET_DENSE", "0.3")),
            0.0,  # dense tier is v5: no dcesc8 stream
            float(env("FASTDET_SPARSE_DCESC_BUDGET_DENSE", "0.25")),
        ),
    }


def sparse_caps(size: int, layout: Tuple[int, int], fmt: int,
                budget: Sequence[float]) -> SparseCaps:
    """Static stream capacities of a (layout, format, budget) row."""
    hs, vs = layout
    yb, cb = native_jpeg.sparse_geometry(size, size, hs, vs)
    nb = yb + 2 * cb
    mk, ac, e8, e16, dce8, dce16 = budget
    mcap = -128 * (math.ceil(nb * mk) // -128)
    if fmt == 6:
        # 3-bit value capacity in BYTES, a multiple of 3 (whole 8-symbol
        # groups) and of 128
        vcap = -384 * (math.ceil(nb * ac * 3 / 8) // -384)
        dce8cap = max(128, -128 * (math.ceil(nb * dce8) // -128))
    else:
        vcap = -128 * (math.ceil(nb * ac / 2) // -128)
        dce8cap = 0  # v5 DC deltas are already int8
    e8cap = max(128, -128 * (math.ceil(nb * e8) // -128))
    e16cap = max(64, -64 * (math.ceil(nb * e16) // -64))
    dce16cap = max(64, -64 * (math.ceil(nb * dce16) // -64))
    return SparseCaps(fmt, nb, mcap, vcap, e8cap, e16cap, dce8cap, dce16cap)


def sparse_offsets(caps: SparseCaps) -> np.ndarray:
    """Field end-offsets of the packed row — the ONE definition of the row
    layout per wire format, shared by host staging and device unpack:
      v5: [plen ceil(nb/2) | maskstream | dc8 nb | nib | esc8
           | esc16*2 | dcesc16*2 | qy,qcb,qcr 3*2*64 | thr 4]
      v6: [plen ceil(nb/2) | maskstream | dc4 ceil(nb/2) | tri
           | esc8 | esc16*2 | dcesc8 | dcesc16*2 | q... | thr]"""
    nb = caps.nb
    if caps.fmt == 6:
        fields = [(nb + 1) // 2, caps.mask, (nb + 1) // 2, caps.vals,
                  caps.e8, 2 * caps.e16, caps.dce8, 2 * caps.dce16]
    else:
        fields = [(nb + 1) // 2, caps.mask, nb, caps.vals,
                  caps.e8, 2 * caps.e16, 2 * caps.dce16]
    return np.cumsum(fields)


def sparse_row_bytes(caps: SparseCaps) -> int:
    """Row size: the fields + 384 B of quant tables (3 x 64 x uint16) +
    the 4-byte f32 threshold."""
    return int(sparse_offsets(caps)[-1]) + 384 + 4


def sparse_row_views(row: np.ndarray, caps: SparseCaps) -> tuple:
    """One packed uint8 row's fields as the typed views the native
    emitter (native_jpeg.decode_sparse5_into / 6_into) fills, quant
    tables last."""
    bo = sparse_offsets(caps)
    if caps.fmt == 6:
        return (
            row[:bo[0]],                      # plen
            row[bo[0]:bo[1]],                 # maskstream
            row[bo[1]:bo[2]],                 # dc4
            row[bo[2]:bo[3]],                 # tri
            row[bo[3]:bo[4]].view(np.int8),   # esc8
            row[bo[4]:bo[5]].view(np.int16),  # esc16
            row[bo[5]:bo[6]].view(np.int8),   # dcesc8
            row[bo[6]:bo[7]].view(np.int16),  # dcesc16
            row[bo[7]:bo[7] + 384].view(np.uint16),  # q
        )
    return (
        row[:bo[0]],                      # plen
        row[bo[0]:bo[1]],                 # maskstream
        row[bo[1]:bo[2]].view(np.int8),   # dc8
        row[bo[2]:bo[3]],                 # nib
        row[bo[3]:bo[4]].view(np.int8),   # esc8
        row[bo[4]:bo[5]].view(np.int16),  # esc16
        row[bo[5]:bo[6]].view(np.int16),  # dcesc
        row[bo[6]:bo[6] + 384].view(np.uint16),  # q
    )


class PlanesDispatch:
    """In-flight grouped-batch dispatch: one result per (ingest path,
    subsampling layout) group, with the original batch indices to
    reassemble order. Returned by detect_async_planes /
    detect_async_sparse and consumed by fetch()."""

    __slots__ = ("parts", "layouts", "tags", "counts", "unresolved")

    def __init__(self, parts, layouts=(), tags=(), counts=None,
                 unresolved=()):
        self.parts = parts      # [(Future of device result, [orig idx]), ...]
        self.layouts = layouts
        self.tags = tags        # e.g. ("sparse:22", "planes:21")
        self.counts = counts or {}  # frames per ingest kind
        # frames NO native path could decode: the caller routes exactly
        # these through the host pixel path
        self.unresolved = tuple(unresolved)


class _Gathered:
    """The Future of a dp dispatch: the shards' (packed, wire) results,
    concatenated on the host in row order once every shard is done."""

    def __init__(self, futures):
        self._futures = futures
        self._out = None

    def result(self):
        if self._out is None:
            parts = [f.result() for f in self._futures]
            self._out = tuple(torch.cat([p[i].cpu() for p in parts])
                              for i in range(2))
        return self._out


def _warm_layouts() -> List[Tuple[int, int]]:
    """FASTDET_WARM_LAYOUTS (default "22,21": 4:2:0, the mobile clients'
    layout, and 4:2:2, the reference fixtures'), as the JAX engine reads
    it; other layouts run their first batch cold."""
    out = []
    for tok in os.environ.get("FASTDET_WARM_LAYOUTS", "22,21").split(","):
        tok = tok.strip()
        if len(tok) != 2 or not tok.isdigit():
            continue
        layout = (int(tok[0]), int(tok[1]))
        if layout not in native_jpeg.PLANE_LAYOUTS:
            logger.warning("FASTDET_WARM_LAYOUTS: ignoring %r", tok)
            continue
        out.append(layout)
    return out


class DetectionEngine:
    def __init__(
        self,
        spec: ModelSpec,
        params: Dict[str, Any],
        *,
        mode: Optional[str] = "bf16",
        max_candidates: int = postprocess.MAX_CANDIDATES,
        max_det: int = postprocess.MAX_DET,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        folded: bool = False,
        device="cuda",
        devices: Optional[Sequence] = None,
        calibration_images: Optional[np.ndarray] = None,
    ):
        """``devices`` lists the dp mesh's devices, one shard each (the
        JAX engine's argument); when it is None, a bare ``"cuda"`` device
        means every visible card, as ``jax.devices()`` does, and
        ``"cuda:k"`` or ``"cpu"`` that one device.
        ``calibration_images`` (N, H, W, 3) uint8 are the int8 mode's
        calibration frames (else FASTDET_CALIB_DIR, else synthetic
        scenes)."""
        if mode not in _COMPUTE_DTYPES:
            raise ValueError(f"unknown mode {mode!r}")
        if devices is None:
            dev = device_mod.resolve(device)
            if not (dev.type == "cuda" and dev.index is None):
                devices = [dev]
        self.devices = tuple(mesh_lib.make_devices(devices))
        self.n_devices = len(self.devices)
        self.device = self.devices[0]
        device_mod.strict_fp32()
        self.mode = mode
        self.compute_dtype = _COMPUTE_DTYPES[mode]
        self.max_candidates = max_candidates
        self.max_det = max_det
        # Sparse-ingest budgets are captured ONCE: the packed row layout
        # and the device unpack must agree for the engine's lifetime.
        self._sparse_budgets = sparse_budgets()
        self._sparse_fmt = self._sparse_budgets["fmt"]
        folded_params = params if folded else weights.fold_params(spec,
                                                                  params)
        #: int8: the activation scales and the calibration's wall seconds
        self.act_scales: Optional[Dict[str, Dict[str, float]]] = None
        self.calibration_s = 0.0
        if mode == "int8":
            # Calibrate on the CANONICAL graph, before the stem rewrite:
            # the float forward sums in another order in the two graph
            # forms, and with one set of scales the rewritten int8
            # network stays bit-exact to the canonical one. One
            # calibration on the first device: every replica quantizes
            # with the same scales.
            calib = calibration_images
            if calib is None:
                calib = _calibration_from_dir(spec.image_size)
            if calib is None:
                calib = _default_calibration_images(spec.image_size)
            t0 = time.perf_counter()
            self.act_scales = quantize.calibrate(spec, folded_params, calib,
                                                 device=self.device)
            self.calibration_s = time.perf_counter() - t0
        rewritten = s2d.stem_to_s2d(spec, folded_params)
        if rewritten is not None:
            spec, folded_params = rewritten
        self.spec = spec
        if mode == "int8":
            self.qparams = quantize.quantize_params(spec, folded_params,
                                                    self.act_scales)
            self.nets = [quantize.Int8Net(spec, self.qparams,
                                          device=d).eval()
                         for d in self.devices]
        else:
            self.nets = [YoloNet(spec, folded_params,
                                 dtype=self.compute_dtype,
                                 device=d).eval()
                         for d in self.devices]
        buckets = tuple(sorted(buckets))
        if self.n_devices > 1:
            buckets = mesh_lib.dp_buckets(buckets, self.n_devices)
        self.buckets = buckets
        self.max_batch = self.buckets[-1]
        # Tier memory: layout -> "dense" when recent traffic of that
        # layout mostly overflowed the std tier (see detect_async_sparse)
        self._tier_hint: Dict[Tuple[int, int], str] = {}
        # One transfer worker per shard copies its rows to its device and
        # runs the program (the soft-NMS loop syncs with the host, so the
        # caller must not run it); one decode pool entropy-decodes the
        # frames of a batch in parallel (the native decoder releases the
        # GIL). All are joined by close().
        self._xfers = [ThreadPoolExecutor(1, thread_name_prefix=f"fd-xfer{k}")
                       for k in range(self.n_devices)]
        ncpu = os.cpu_count() or 1
        self._decode = (ThreadPoolExecutor(min(8, ncpu),
                                           thread_name_prefix="fd-decode")
                        if ncpu > 1 else None)
        # Programs still warming on the background thread (see warmup):
        # routing treats these paths as unavailable instead of making a
        # request wait for their first run.
        self._lazy_pending: set = set()
        self._lazy_thread: Optional[threading.Thread] = None
        self.background_warm_s: Optional[float] = None
        #: per-program warm-up wall seconds, keyed by str(tag) of the JAX
        #: engine's tags: ("pixels", b), ("sparse", layout, tier, b),
        #: ("planes", layout, b)
        self.warm_attribution: Dict[str, float] = {}
        #: per shard, {program key: its captured prefix}; the capturer
        #: is CUDA's on a card and None on the CPU
        self._graphs: List[Dict[Any, graphs.PrefixGraph]] = [
            {} for _ in self.devices]
        self._capturer: Optional[graphs.Capturer] = (
            graphs.CudaCapturer()
            if all(d.type == "cuda" for d in self.devices) else None)

    @property
    def net(self):
        """The first replica (the only one on a one-device engine)."""
        return self.nets[0]

    def close(self) -> None:
        """Join the engine's threads: the background warm-up first, then
        the workers (pending work finishes)."""
        if self._lazy_thread is not None:
            self._lazy_thread.join()
        for x in self._xfers:
            x.shutdown(wait=True)
        if self._decode is not None:
            self._decode.shutdown(wait=True)

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------

    @staticmethod
    def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    def _run_shard(self, fn, k: int, arrays, queued=None, key=None,
                   capture: bool = False):
        """Run shard k's part on its device, on the current stream: the
        prefix ``fn`` (ingest -> net -> top-K), then the eager tail
        (soft-NMS, packing). The prefix replays ``key``'s captured graph
        of the shard when there is one; else ``arrays`` are copied to the
        device and ``fn`` runs, and with ``capture`` the prefix is then
        captured under ``key``. ``queued`` = (perf_counter_ns when the
        work was queued, batch id, part tag) records the spans
        ``engine.xfer_wait`` (queued -> started), ``engine.xfer_run``
        (started -> returned: the copies issued, the program's launches,
        soft-NMS's host syncs) and, for a replayed prefix,
        ``engine.graph_replay`` (started -> the replay launched)."""
        dev = self.devices[k]
        t_start = now_ns()
        graph = self._graphs[k].get(key)
        t_replayed = None
        with torch.inference_mode():
            if graph is not None:
                sel = graph.run(arrays)
                t_replayed = now_ns()
            else:
                inputs = [self._to_device(a, dev) for a in arrays]
                sel = fn(*inputs, shard=k)
            out = self._soft_nms_tail(*sel)
            if capture and graph is None and self._capturer is not None:
                self._capture(k, key, fn, inputs)
        if queued is not None:
            t_queued, bid, part = queued
            STAGES.record("engine.xfer_wait", t_queued, t_start, bid=bid,
                          part=part)
            STAGES.record("engine.xfer_run", t_start, now_ns(), bid=bid,
                          part=part)
            if t_replayed is not None:
                STAGES.record("engine.graph_replay", t_start, t_replayed,
                              bid=bid, part=part)
        return out

    def _capture(self, k: int, key, fn, inputs) -> None:
        """Capture shard k's prefix ``fn`` of program ``key`` on copies of
        its warm run's device ``inputs``. A capture that fails leaves the
        program eager."""
        try:
            self._graphs[k][key] = graphs.capture(
                self._capturer, functools.partial(fn, shard=k), inputs,
                self.devices[k], k)
        except Exception:
            logger.exception("capture of %s on shard %d failed; it runs "
                             "eagerly", key, k)

    def _run_program(self, fn, *inputs: torch.Tensor, shard: int = 0):
        """The prefix ``fn`` on device ``inputs`` and the tail, eagerly on
        the calling thread: the program's (packed, wire) result."""
        return self._soft_nms_tail(*fn(*inputs, shard=shard))

    def _dispatch_async(self, fn, *arrays: np.ndarray, part: str, key=None,
                        capture: bool = False):
        """Queue (copy inputs to the device, run the prefix ``fn`` and the
        tail) on the transfer worker; returns a Future of the (packed,
        wire) result. ``key`` names the program (see :meth:`_run_shard`).
        On a dp engine each shard's rows go to its own worker and device,
        and the Future gathers them in row order. ``part`` tags the
        work's spans, with the caller's batch (profiling.current_batch)."""
        queued = (now_ns(), profiling.current_batch(), part)
        n = self.n_devices
        if n == 1:
            return self._xfers[0].submit(self._run_shard, fn, 0, arrays,
                                         queued, key, capture)
        return _Gathered([
            self._xfers[k].submit(
                self._run_shard, fn, k,
                [a[mesh_lib.shard_rows(len(a), n, k)] for a in arrays],
                queued, key, capture)
            for k in range(n)])

    def _select(self, x: torch.Tensor, thresholds: torch.Tensor,
                shard: int = 0):
        """(B, H, W, 3) f32 frames -> the prefix's end: the top-K
        candidates (boxes, scores, klass) and the (B,) thresholds,
        through shard ``shard``'s replica of the net. No host sync."""
        heads = self.nets[shard](x)
        return postprocess.select_batch(
            heads, self.spec, thresholds, self.max_candidates) + (
            thresholds,)

    def _soft_nms_tail(self, sel_b, sel_s, sel_k, thresholds):
        """The prefix's candidates -> (packed (B, max_det, 7) f32
        [x, y, w, h, score, klass, valid], wire (B, max_det*10+4) u8),
        fresh tensors: soft-NMS syncs with the host once a trip."""
        res = nms.soft_nms_batch(sel_b, sel_s, sel_k, thresholds,
                                 self.max_det)
        packed = torch.cat([
            res.boxes, res.scores[..., None],
            res.klass.to(torch.float32)[..., None],
            res.valid.to(torch.float32)[..., None]], dim=-1)
        return packed, postprocess.pack_wire_records(res,
                                                     self.spec.image_size)

    def _pipeline(self, images_u8: torch.Tensor, thresholds: torch.Tensor,
                  shard: int = 0):
        x = images_u8.to(torch.float32) * (1.0 / 255.0)
        return self._select(x, thresholds, shard)

    @staticmethod
    def _row_thresholds(packed: torch.Tensor, start: int) -> torch.Tensor:
        """The per-frame f32 LE threshold in a packed row's tail."""
        return packed[:, start:start + 4].contiguous().view(
            torch.float32)[:, 0]

    def _pipeline_coeffs(self, ycoef, cbcoef, crcoef, qy, qc,
                         thresholds, shard: int = 0):
        """Coefficient path: the host entropy-decodes, the device runs
        dequant + IDCT + upsample + colour (decode420_batch) and the net."""
        size = self.spec.image_size
        x = jpeg_device.decode420_batch(ycoef, cbcoef, crcoef, qy, qc,
                                        size, size)
        return self._select(x, thresholds, shard)

    def _pipeline_planes(self, packed: torch.Tensor, layout=(2, 2),
                         shard: int = 0):
        """Host Huffman + IDCT (native), device upsample + colour + net:
        rows [Y | Cb | Cr | thr]. 4:2:0 goes through kernel B2."""
        hs, vs = layout
        size = self.spec.image_size
        yb = size * size
        cw = (size // vs) * (size // hs)
        b = packed.shape[0]
        y = packed[:, :yb].view(b, size, size)
        cb = packed[:, yb:yb + cw].view(b, size // vs, size // hs)
        cr = packed[:, yb + cw:yb + 2 * cw].view(b, size // vs, size // hs)
        thresholds = self._row_thresholds(packed, yb + 2 * cw)
        if layout == (2, 2):
            x = plane_ingest.plane_ingest_batch(y, cb, cr)
        else:
            x = jpeg_device.ycbcr_to_rgb01(
                y.to(torch.float32),
                jpeg_device.upsample_chroma(cb, hs, vs),
                jpeg_device.upsample_chroma(cr, hs, vs))
        return self._select(x, thresholds, shard)

    # ------------------------------------------------------------------
    # Packed sparse coefficient ingest (the fewest-bytes path)
    # ------------------------------------------------------------------

    def _sparse_caps(self, layout: Tuple[int, int],
                     tier: str = "std") -> SparseCaps:
        return sparse_caps(self.spec.image_size, layout,
                           self._sparse_fmt[tier],
                           self._sparse_budgets[tier])

    def _pipeline_sparse(self, packed: torch.Tensor, layout=(2, 2),
                         tier="std", shard: int = 0):
        hs, vs = layout
        size = self.spec.image_size
        caps = self._sparse_caps(layout, tier)
        yb, cbn = native_jpeg.sparse_geometry(size, size, hs, vs)
        b = packed.shape[0]
        bo = [int(v) for v in sparse_offsets(caps)]

        def field(i, dtype=torch.uint8):
            lo = bo[i - 1] if i else 0
            return packed[:, lo:bo[i]].contiguous().view(dtype)

        if caps.fmt == 6:
            coeff = sparse_ingest.sparse6_to_coeffs_batch(
                field(0), field(1), field(2), field(3),
                field(4, torch.int8), field(5, torch.int16),
                field(6, torch.int8), field(7, torch.int16), yb, cbn)
        else:
            coeff = sparse_ingest.sparse5_to_coeffs_batch(
                field(0), field(1), field(2, torch.int8), field(3),
                field(4, torch.int8), field(5, torch.int16),
                field(6, torch.int16), yb, cbn)
        qstart = bo[-1]
        qb = packed[:, qstart:qstart + 384].reshape(b, 3, 64, 2).to(
            torch.float32)
        q = qb[..., 0] + qb[..., 1] * 256.0
        x = jpeg_device.coeffs_to_rgb01(coeff, q[:, 0], q[:, 1], q[:, 2],
                                        size, size, hs, vs)
        return self._select(
            x, self._row_thresholds(packed, qstart + 384), shard)

    def _stage_sparse(self, jpegs, thr_all, groups, tier):
        """Allocate packed rows + decode jobs for {layout: [indices]}."""
        staged = []
        jobs = []
        for layout, idxs in groups.items():
            caps = self._sparse_caps(layout, tier)
            row = sparse_row_bytes(caps)
            b = self.bucket_for(len(idxs))
            packed = np.zeros((b, row), np.uint8)  # zero rows = gray frames
            thr = np.full((b,), 2.0, np.float32)
            thr[: len(idxs)] = thr_all[idxs]
            # padded rows keep the 2.0 sentinel: postprocess skips them
            packed[:, -4:] = thr.view(np.uint8).reshape(b, 4)
            staged.append((layout, idxs, packed, thr))
            for j, i in enumerate(idxs):
                views = sparse_row_views(packed[j], caps)
                jobs.append((jpegs[i], i, caps.fmt, views))
        return staged, jobs

    def _map_decode(self, fn, jobs) -> list:
        if len(jobs) > 1 and self._decode is not None:
            return list(self._decode.map(fn, jobs))
        return [fn(j) for j in jobs]

    def _run_sparse_jobs(self, jobs) -> Tuple[List[int], Dict[int, Any]]:
        """Entropy-decode each job into its row; returns (overflow
        indices, {frame index: (emitter format, TRUE SparseCounts)}).

        A frame whose decode raises (malformed or unsupported stream,
        not a capacity overflow) is reported as overflow with counts
        None: it fits no tier and takes the planes/pixel ladder while
        its batch-mates keep their sparse dispatch."""

        def _decode(job):
            data, i, fmt, views = job
            qrow = views[-1]
            try:
                if fmt == 6:
                    cts, qy, qcb, qcr = native_jpeg.decode_sparse6_into(
                        data, *views[:-1])
                else:
                    cts, qy, qcb, qcr = native_jpeg.decode_sparse5_into(
                        data, *views[:-1])
            except native_jpeg.SparseCapacityExceeded as e:
                return i, False, (fmt, e.counts)
            except (ValueError, native_jpeg.NativeJpegUnavailable):
                return i, False, None
            qrow[:64] = qy
            qrow[64:128] = qcb
            qrow[128:] = qcr
            return i, True, (fmt, cts)

        outcomes = self._map_decode(_decode, jobs)
        overflow = [i for i, ok, _ in outcomes if not ok]
        counts = {i: cts for i, ok, cts in outcomes}
        return overflow, counts

    def _fits_tier(self, layout: Tuple[int, int], tier: str,
                   fmt_cts) -> bool:
        """Would a frame with these emitter counts fit the tier's stream
        capacities AND the tier format's per-block escape caps? The
        emitters report both formats' escape predictors, so this
        evaluates a format-crossing retry (std v6 <-> dense v5) from
        one decode."""
        if fmt_cts is None:
            return False
        src_fmt, cts = fmt_cts
        caps = self._sparse_caps(layout, tier)
        if cts.own_block_cap if caps.fmt == src_fmt else cts.other_block_cap:
            return False
        if caps.fmt == 6:
            vals_need = -((cts.ac * 3) // -8)   # packed 3-bit bytes
            e8_need = cts.ac_gt3
            if cts.dcd_gt7 > caps.dce8:
                return False
        else:
            vals_need = (cts.ac + 1) // 2       # packed nibble bytes
            e8_need = cts.ac_gt7
        return (vals_need <= caps.vals and e8_need <= caps.e8
                and cts.e16 <= caps.e16 and cts.dce16 <= caps.dce16
                and cts.mask <= caps.mask)

    def detect_async_sparse(
        self, jpegs: Sequence[bytes], thresholds: Sequence[float]
    ) -> Optional[PlanesDispatch]:
        """Dispatch via the packed-sparse-coefficient path; None if N/A.

        A frame too dense for the "std" tier retries on the "dense" tier
        (bigger rows, v5 wire); only dense-tier overflow falls back to the
        PLANE path, per frame — its group-mates still ride the sparse
        path. counts keys: "sparse" (std tier), "sparse_dense", "planes".
        Returns None when the whole batch can't take a native path (the
        caller decodes pixels on the host).

        Tier memory: when MOST of a layout group overflows std, the
        engine starts that layout at the dense tier; the emitter's true
        counts clear the hint once most of a dense-staged group would
        have fit std again. Results are identical either way (both tiers
        reconstruct exactly); only wire bytes and host decode time move.
        """
        n = len(jpegs)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} frames; this engine takes "
                             f"1..{self.max_batch}")
        size = self.spec.image_size
        if size % 8 != 0 or not native_jpeg.available():
            return None
        groups: Dict[Tuple[int, int], List[int]] = {}
        probe_failed: List[int] = []
        for i, d in enumerate(jpegs):
            try:
                _, _, hs, vs = native_jpeg.scan_layout(
                    d, expected_size=(size, size))
                native_jpeg.sparse_geometry(size, size, hs, vs)
            except (ValueError, native_jpeg.NativeJpegUnavailable):
                # outside the native decoder's subset: only this frame
                # goes to the host pixel path
                probe_failed.append(i)
                continue
            groups.setdefault((hs, vs), []).append(i)
        if not groups:
            return None

        thr_all = np.asarray(list(thresholds), np.float32)
        parts = []
        counts: Dict[str, int] = {}
        tags: List[str] = []
        pending = {lay: idxs for lay, idxs in groups.items()
                   if self._tier_hint.get(lay) != "dense"}
        dense_start = {lay: idxs for lay, idxs in groups.items()
                       if self._tier_hint.get(lay) == "dense"}
        to_planes: List[int] = []  # overflow frames with no viable tier
        for tier, count_key, tag_fmt in (
            ("std", "sparse", "sparse:%d%d"),
            ("dense", "sparse_dense", "sparse+:%d%d"),
        ):
            if tier == "dense":
                for lay, idxs in dense_start.items():
                    pending.setdefault(lay, []).extend(idxs)
                    pending[lay].sort()
                # Lazy warm-up: while the dense-tier program still warms
                # on the background thread, over-budget frames ride
                # planes or pixels instead of waiting for it.
                for lay in [l for l, idxs in pending.items()
                            if not self._path_ready(
                                ("sparse", l, "dense",
                                 self.bucket_for(len(idxs))))]:
                    to_planes.extend(pending.pop(lay))
            if not pending:
                continue
            staged, jobs = self._stage_sparse(jpegs, thr_all, pending, tier)
            overflow, frame_cts = self._run_sparse_jobs(jobs)
            ov = set(overflow)
            next_pending: Dict[Tuple[int, int], List[int]] = {}
            for layout, idxs, packed, thr in staged:
                ovl = [i for i in idxs if i in ov]
                if ovl and tier == "std":
                    # frames with no chance on the dense tier skip
                    # straight to planes (no second wasted decode)
                    retry = [i for i in ovl
                             if self._fits_tier(layout, "dense",
                                                frame_cts[i])]
                    if retry:
                        next_pending[layout] = retry
                    to_planes.extend(i for i in ovl if i not in set(retry))
                elif ovl:
                    next_pending[layout] = ovl
                if tier == "std" and 2 * len(ovl) > len(idxs):
                    self._tier_hint[layout] = "dense"
                elif tier == "dense" and layout in dense_start:
                    fit = sum(
                        1 for i in idxs
                        if i not in ov
                        and self._fits_tier(layout, "std", frame_cts[i]))
                    if 2 * fit > len(idxs):
                        self._tier_hint.pop(layout, None)
                keep = [k for k, i in enumerate(idxs) if i not in ov]
                if not keep:
                    continue
                if len(keep) != len(idxs):
                    # result row j maps to the j-th kept index: compact
                    # the kept rows to the front and ZERO the vacated
                    # ones (an overflow row carries its plen/mask prefix
                    # with truncated streams; zero rows are gray frames
                    # with all-zero offsets), re-stamping the 2.0 tail
                    packed[: len(keep)] = packed[keep]
                    packed[len(keep):len(idxs)] = 0
                    packed[len(keep):len(idxs), -4:] = _THR_PAD_BYTES
                tags.append(tag_fmt % layout)
                res = self._dispatch_async(functools.partial(
                    self._pipeline_sparse, layout=layout, tier=tier), packed,
                    part=tags[-1],
                    key=("sparse", layout, tier, packed.shape[0]))
                parts.append((res, [idxs[k] for k in keep]))
                counts[count_key] = counts.get(count_key, 0) + len(keep)
            pending = next_pending
        unresolved: List[int] = list(probe_failed)
        if pending or to_planes:
            # too dense even for the dense tier: re-decode via planes
            ovidx = sorted(set(to_planes).union(
                i for idxs in pending.values() for i in idxs))
            sub = self.detect_async_planes(
                [jpegs[i] for i in ovidx], [thr_all[i] for i in ovidx])
            if sub is None:
                if not parts:
                    return None  # nothing in flight: pixel decode for all
                unresolved.extend(ovidx)
            else:
                for dev_res, sub_idxs in sub.parts:
                    parts.append((dev_res, [ovidx[k] for k in sub_idxs]))
                unresolved.extend(ovidx[k] for k in sub.unresolved)
                counts["planes"] = len(ovidx) - len(sub.unresolved)
                tags.extend(sub.tags)
        return PlanesDispatch(
            parts, layouts=tuple(sorted(groups)), tags=tuple(tags),
            counts=counts, unresolved=unresolved)

    def detect_async_planes(
        self, jpegs: Sequence[bytes], thresholds: Sequence[float]
    ) -> Optional[PlanesDispatch]:
        """Dispatch via the subsampled-plane path; None if N/A.

        Any mix of 4:2:0 / 4:2:2 / 4:4:0 / 4:4:4 frames, grouped by
        layout (one device program per group). A frame whose entropy
        decode fails is excluded from its group (rows compacted, tail
        re-neutralized) and reported in ``unresolved``; None only when
        no frame decodes."""
        n = len(jpegs)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} frames; this engine takes "
                             f"1..{self.max_batch}")
        size = self.spec.image_size
        if size % 16 != 0 or not native_jpeg.available():
            return None
        groups: Dict[Tuple[int, int], List[int]] = {}
        probe_failed: List[int] = []
        for i, d in enumerate(jpegs):
            try:
                _, _, hs, vs = native_jpeg.scan_layout(
                    d, expected_size=(size, size))
            except (ValueError, native_jpeg.NativeJpegUnavailable):
                probe_failed.append(i)
                continue
            groups.setdefault((hs, vs), []).append(i)
        # Lazy warm-up: groups whose plane program still warms on the
        # background thread fall through to the pixel path (unresolved)
        # instead of waiting for it.
        for lay in [l for l, idxs in groups.items()
                    if not self._path_ready(
                        ("planes", l, self.bucket_for(len(idxs))))]:
            probe_failed.extend(groups.pop(lay))
        if not groups:
            return None

        thr_all = np.asarray(list(thresholds), np.float32)
        yb = size * size
        staged = []
        jobs = []
        for layout, idxs in groups.items():
            hs, vs = layout
            b = self.bucket_for(len(idxs))
            cw = (size // vs) * (size // hs)
            # one buffer per group, rows [Y | Cb | Cr | thr]: a single
            # host-to-device copy per batch
            packed = np.empty((b, yb + 2 * cw + 4), np.uint8)
            packed[len(idxs):, :yb] = 0               # padded: black...
            packed[len(idxs):, yb:yb + 2 * cw] = 128  # ...neutral chroma
            thr = np.full((b,), 2.0, np.float32)
            thr[: len(idxs)] = thr_all[idxs]
            packed[:, -4:] = thr.view(np.uint8).reshape(b, 4)
            staged.append((layout, idxs, packed))
            for j, i in enumerate(idxs):
                jobs.append((
                    i, jpegs[i],
                    packed[j, :yb].reshape(size, size),
                    packed[j, yb:yb + cw].reshape(size // vs, size // hs),
                    packed[j, yb + cw:yb + 2 * cw].reshape(
                        size // vs, size // hs),
                ))

        def _decode_one(a):
            try:
                native_jpeg.decode_planes_into(*a[1:])
                return None
            except (ValueError, native_jpeg.NativeJpegUnavailable):
                return a[0]

        failed = {i for i in self._map_decode(_decode_one, jobs)
                  if i is not None}
        if len(failed) + len(probe_failed) == n:
            return None  # nothing decodable; caller pixel-decodes all

        parts = []
        tags = []
        for layout, idxs, packed in staged:
            keep = [k for k, i in enumerate(idxs) if i not in failed]
            if not keep:
                continue
            if len(keep) != len(idxs):
                cw = (size // layout[1]) * (size // layout[0])
                packed[: len(keep)] = packed[keep]
                packed[len(keep):len(idxs), :yb] = 0
                packed[len(keep):len(idxs), yb:yb + 2 * cw] = 128
                packed[len(keep):len(idxs), -4:] = _THR_PAD_BYTES
            tags.append("planes:%d%d" % layout)
            res = self._dispatch_async(functools.partial(
                self._pipeline_planes, layout=layout), packed, part=tags[-1],
                key=("planes", layout, packed.shape[0]))
            parts.append((res, [idxs[k] for k in keep]))
        return PlanesDispatch(
            parts, layouts=tuple(sorted(groups)), tags=tuple(tags),
            counts={"planes": n - len(failed) - len(probe_failed)},
            unresolved=sorted(failed.union(probe_failed)))

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               fallbacks: bool = True) -> float:
        """Run each serving program once per bucket on neutral inputs
        (builds the kernels, lets cuDNN pick its algorithms and the
        allocator grow), then, on a card, capture its prefix's CUDA graph
        in the same job; returns the seconds until the first-choice
        programs are warm.

        As the JAX engine splits its compiles: the first-choice programs
        (pixels at the smallest bucket, the std sparse tier per warm
        layout and bucket) run before warmup returns; the fallbacks (the
        dense tier, planes, larger pixel buckets) run on a background
        thread, each shard on its own device and stream, so no serving
        work queues behind them. Until a fallback is warm the routers
        send its frames down the ladder that is (dense -> planes ->
        pixels). FASTDET_LAZY_WARM=0 runs everything before returning.
        While the background thread captures, no thread may synchronize
        the whole device (``torch.cuda.synchronize``; a stream's sync is
        fine): call wait_warm() first.
        ``fallbacks=False`` leaves the fallbacks out (they run cold on
        first use): one-shot CLIs would otherwise warm programs they
        will likely never run. ``buckets`` are rounded to the engine's."""
        t0 = time.time()
        size = self.spec.image_size
        warm_sparse = size % 16 == 0 and native_jpeg.available()
        lazy = os.environ.get("FASTDET_LAZY_WARM", "1") != "0"
        jobs = []       # (fn, arrays, batch, tag), run before returning
        lazy_jobs = []  # the same, on the background thread
        warm_buckets = sorted({self.bucket_for(b)
                               for b in (buckets or self.buckets)})
        for b in warm_buckets:
            thr = np.full((b,), 0.1, np.float32)
            job = (self._pipeline,
                   (np.zeros((b, size, size, 3), np.uint8), thr), b,
                   ("pixels", b))
            (lazy_jobs if lazy and fallbacks and b != warm_buckets[0]
             else jobs).append(job)
            if not warm_sparse:
                continue
            for layout in _warm_layouts():
                hs, vs = layout
                for tier in ("std", "dense") if fallbacks else ("std",):
                    caps = self._sparse_caps(layout, tier)
                    pk = np.zeros((b, sparse_row_bytes(caps)), np.uint8)
                    pk[:, -4:] = thr.view(np.uint8).reshape(b, 4)
                    job = (functools.partial(self._pipeline_sparse,
                                             layout=layout, tier=tier),
                           (pk,), b, ("sparse", layout, tier, b))
                    (lazy_jobs if lazy and tier == "dense"
                     else jobs).append(job)
                if not fallbacks:
                    continue
                cw = (size // vs) * (size // hs)
                pk = np.full((b, size * size + 2 * cw + 4), 128, np.uint8)
                pk[:, -4:] = thr.view(np.uint8).reshape(b, 4)
                job = (functools.partial(self._pipeline_planes,
                                         layout=layout),
                       (pk,), b, ("planes", layout, b))
                (lazy_jobs if lazy else jobs).append(job)

        for fn, arrays, b, tag in jobs:
            t_job = time.time()
            res = self._dispatch_async(fn, *arrays, part="warmup", key=tag,
                                       capture=True)
            self.fetch(res, b)        # the CLI's path: packed results
            self.fetch_wire(res, b)   # the server's: wire records
            self.warm_attribution[str(tag)] = time.time() - t_job
        dt = time.time() - t0

        if lazy_jobs:
            self._lazy_pending.update(tag for _, _, _, tag in lazy_jobs)
            self._lazy_thread = threading.Thread(
                target=self._background_warm, args=(lazy_jobs,),
                daemon=True, name="fd-bg-warm")
            self._lazy_thread.start()
        logger.info("engine warmup: %s buckets=%s in %.1fs (background "
                    "programs: %d)", self.spec.name, self.buckets, dt,
                    len(lazy_jobs))
        return dt

    def _background_warm(self, jobs) -> None:
        """The lazy set of warmup(): each program on every shard, on a
        stream of the warm thread's own per device (serving stays on the
        workers and the current stream), results read back on it."""
        t1 = time.time()
        n = self.n_devices
        streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                   for d in self.devices]
        for fn, arrays, b, tag in jobs:
            t_job = time.time()
            try:
                for k in range(n):
                    rows = [a[mesh_lib.shard_rows(len(a), n, k)]
                            for a in arrays]
                    ctx = (torch.cuda.stream(streams[k])
                           if streams[k] is not None
                           else contextlib.nullcontext())
                    with ctx:
                        for t in self._run_shard(fn, k, rows, key=tag,
                                                 capture=True):
                            t.cpu()
                self.warm_attribution[str(tag)] = time.time() - t_job
            except Exception:  # the program then runs cold on first use
                logger.exception("background warm of %s failed", tag)
            finally:
                self._lazy_pending.discard(tag)
        self.background_warm_s = time.time() - t1
        logger.info("engine background warm: %s in %.1fs", self.spec.name,
                    self.background_warm_s)

    def wait_warm(self, timeout: Optional[float] = None) -> None:
        """Block until the background warm-up (if any) finishes."""
        t = self._lazy_thread
        if t is not None:
            t.join(timeout)

    def _path_ready(self, key) -> bool:
        """False while ``key``'s program still warms on the background
        thread. An engine that never ran warmup() has nothing pending:
        every path runs cold on first use (tests, CLIs)."""
        return key not in self._lazy_pending

    # ------------------------------------------------------------------
    # Synchronous API
    # ------------------------------------------------------------------

    def detect(self, images: Sequence[np.ndarray],
               thresholds: Sequence[float]) -> List[List[ResultTuple]]:
        """Run a batch of RGB uint8 (size, size, 3) images."""
        return self.fetch(self.detect_async(images, thresholds), len(images))

    def detect_one(self, image: np.ndarray,
                   threshold: float) -> List[ResultTuple]:
        return self.detect([image], [threshold])[0]

    def detect_async(self, images: Sequence[np.ndarray],
                     thresholds: Sequence[float]):
        """Pixel path: pad to a bucket and dispatch; returns a Future."""
        n = len(images)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} frames; this engine takes "
                             f"1..{self.max_batch}")
        b = self.bucket_for(n)
        size = self.spec.image_size
        batch = np.zeros((b, size, size, 3), np.uint8)
        for i, img in enumerate(images):
            if img.shape != (size, size, 3):
                raise ValueError("invalid image size")
            batch[i] = img
        thr = np.full((b,), 2.0, np.float32)  # padded slots: empty result
        thr[:n] = np.asarray(thresholds, np.float32)
        return self._dispatch_async(self._pipeline, batch, thr,
                                    part="pixels", key=("pixels", b))

    def detect_async_jpeg(self, jpegs: Sequence[bytes],
                          thresholds: Sequence[float]):
        """Dispatch via the coefficient path (host entropy decode, device
        dequant + IDCT + colour); returns a Future like detect_async.

        Returns None when the path does not apply: the model size is not
        a multiple of 16, the native decoder is missing, or any frame is
        not a 3-component 4:2:0 JPEG at the model size (one chroma
        table). The caller then takes another route."""
        n = len(jpegs)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} frames; this engine takes "
                             f"1..{self.max_batch}")
        size = self.spec.image_size
        if size % 16 != 0 or not native_jpeg.available():
            return None
        try:
            cis = [native_jpeg.decode_coefficients(
                d, expected_size=(size, size)) for d in jpegs]
        except (ValueError, native_jpeg.NativeJpegUnavailable):
            return None
        for ci in cis:
            if not ci.is_420 or (ci.width, ci.height) != (size, size):
                return None
        b = self.bucket_for(n)
        yb, cb = (size // 8) ** 2, (size // 16) ** 2
        ycoef = np.zeros((b, yb, 64), np.int16)
        cbcoef = np.zeros((b, cb, 64), np.int16)
        crcoef = np.zeros((b, cb, 64), np.int16)
        qy = np.ones((b, 64), np.float32)
        qc = np.ones((b, 64), np.float32)
        for i, ci in enumerate(cis):
            ycoef[i] = ci.ycoef
            cbcoef[i] = ci.cbcoef
            crcoef[i] = ci.crcoef
            qy[i] = ci.qy
            qc[i] = ci.qc
        thr = np.full((b,), 2.0, np.float32)  # padded slots: empty result
        thr[:n] = np.asarray(thresholds, np.float32)
        return self._dispatch_async(self._pipeline_coeffs, ycoef, cbcoef,
                                    crcoef, qy, qc, thr, part="coeffs")

    def fetch(self, res, n: int) -> List[List[ResultTuple]]:
        """Wait for a dispatch and convert its first n images to result
        tuples (klass, conf, x, y, w, h) in pixels."""
        if isinstance(res, PlanesDispatch):
            out: List[Optional[List[ResultTuple]]] = [None] * n
            for dev_res, idxs in res.parts:
                part = self.fetch(dev_res, len(idxs))
                for j, i in enumerate(idxs):
                    out[i] = part[j]
            return [r if r is not None else [] for r in out]
        packed = device_result(res).cpu().numpy()[:n]    # (n, max_det, 7)
        size = self.spec.image_size
        # the pixel scale is an f32 product, as in the wire packer, so
        # fetch() tuples and fetch_wire() records truncate alike
        scaled = packed[:, :, [5, 4, 0, 1, 2, 3]]
        scaled[:, :, 2:] *= np.float32(size)
        counts_v = (packed[:, :, 6] > 0.5).sum(axis=1)
        scaled = scaled.astype(np.float64)
        return [[(int(r[0]), r[1], r[2], r[3], r[4], r[5])
                 for r in scaled[i, : int(counts_v[i])].tolist()]
                for i in range(n)]

    def fetch_wire(self, res, n: int) -> List[bytes]:
        """fetch(), but each frame's results come back already packed as
        the response wire's >BBhhhh record blob (the device packed them;
        one uint8 copy of 10 B/slot + a 4-byte LE count per frame)."""
        if isinstance(res, PlanesDispatch):
            out_w: List[Optional[bytes]] = [None] * n
            for dev_res, idxs in res.parts:
                part = self.fetch_wire(dev_res, len(idxs))
                for j, i in enumerate(idxs):
                    out_w[i] = part[j]
            return [r if r is not None else b"" for r in out_w]
        res = res.result() if hasattr(res, "result") else res
        rec = res[1].cpu().numpy()[:n]
        cnt = rec[:, -4:].astype(np.uint32)
        cnt = cnt[:, 0] | (cnt[:, 1] << 8) | (cnt[:, 2] << 16) | (
            cnt[:, 3] << 24)
        return [rec[i, : int(cnt[i]) * 10].tobytes() for i in range(n)]
