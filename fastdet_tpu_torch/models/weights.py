"""Weight import and export for the YOLOv3 family (numpy in, numpy out).

The port reads and writes the JAX package's checkpoint formats, byte for
byte where it writes (tests/test_torch_checkpoint.py):

- **Darknet ``.weights``** — the published YOLOv3 format: a header of
  three int32 (major, minor, revision) and a ``seen`` counter (int64 when
  ``major*10+minor >= 2``, else int32), then per conv [beta, gamma, mean,
  var] (with BN) or [bias], then OIHW float32 weights.
- **``.npz``** — the native format: a flat numpy archive with a tiny
  metadata header (arch, num_classes); f16-stored leaves are upcast.
- **``.onnx``** — models/onnx_io.py, a protobuf walker that needs no
  ``onnx`` package.
- **synthetic** — deterministic random weights from a numpy seed (the
  same generator and draw order as the JAX package, so
  ``synthetic:<arch>`` is the same model in both packages).

Loaders return *unfolded* parameter trees {conv: {"w" HWIO, "b" | "bn"}}
of host numpy arrays; :func:`fold_params` folds BN for inference.
parallel/checkpoint.cached_import caches a darknet conversion as .npz.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from fastdet_tpu_torch.models import layers, yolov3
from fastdet_tpu_torch.models.yolov3 import ModelSpec


def load_darknet(path: str, spec: ModelSpec) -> Dict[str, Any]:
    """Parse a Darknet .weights file against ``spec``'s conv layer order."""
    with open(path, "rb") as fp:
        raw = fp.read()
    return parse_darknet_bytes(raw, spec)


def parse_darknet_bytes(raw: bytes, spec: ModelSpec) -> Dict[str, Any]:
    """Darknet bytes -> unfolded params. Each conv's input width follows
    the layer graph (a Route concatenates its sources' channels:
    yolov3.conv_io_channels); every float of the file must be consumed."""
    buf = memoryview(raw)
    major, minor, _revision = np.frombuffer(buf[:12], dtype=np.int32)
    off = 12 + (8 if major * 10 + minor >= 2 else 4)  # seen: int64 | int32
    floats = np.frombuffer(buf[off:], dtype=np.float32)
    pos = 0

    def take(n: int) -> np.ndarray:
        nonlocal pos
        if pos + n > floats.size:
            raise ValueError(
                f"darknet weights truncated: need {n} floats at {pos}, "
                f"have {floats.size}")
        out = floats[pos:pos + n].copy()
        pos += n
        return out

    params: Dict[str, Any] = {}
    for l, (in_ch, o, k) in zip(spec.conv_specs(),
                                yolov3.conv_io_channels(spec)):
        if l.bn:
            beta, gamma, mean, var = (take(o) for _ in range(4))
            entry: Dict[str, Any] = {"bn": {"gamma": gamma, "beta": beta,
                                            "mean": mean, "var": var}}
        else:
            entry = {"b": take(o)}
        w = take(o * in_ch * k * k).reshape(o, in_ch, k, k)
        entry["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO
        params[l.name] = entry
    if pos != floats.size:
        raise ValueError(
            f"darknet weights size mismatch: consumed {pos} of {floats.size} "
            f"floats — wrong architecture or num_classes?")
    return params


def save_darknet(path: str, spec: ModelSpec, params: Dict[str, Any]) -> None:
    """Write params as a Darknet .weights file (version 0.2.0, seen 0)."""
    chunks = [np.array([0, 2, 0], dtype=np.int32).tobytes(),
              np.array([0], dtype=np.int64).tobytes()]
    for l in spec.conv_specs():
        p = params[l.name]
        if l.bn:
            bn = p["bn"]
            for leaf in (bn["beta"], bn["gamma"], bn["mean"], bn["var"]):
                chunks.append(np.asarray(leaf, dtype=np.float32).tobytes())
        else:
            chunks.append(np.asarray(p["b"], dtype=np.float32).tobytes())
        w = np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1)  # OIHW
        chunks.append(np.ascontiguousarray(w).tobytes())
    with open(path, "wb") as fp:
        fp.write(b"".join(chunks))


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat = {}
    for name, p in params.items():
        flat[f"{name}/w"] = np.asarray(p["w"])
        if "b" in p:
            flat[f"{name}/b"] = np.asarray(p["b"])
        if "bn" in p:
            for k, v in p["bn"].items():
                flat[f"{name}/bn/{k}"] = np.asarray(v)
    return flat


def save_npz(path: str, spec: ModelSpec, params: Dict[str, Any],
             dtype=None) -> None:
    """Write the native .npz archive (``dtype=np.float16`` stores float
    leaves at half size; :func:`load_npz` upcasts them).

    Written to a temporary name and renamed, so a process killed
    mid-save never leaves a truncated archive at ``path`` (conversion
    caches are read back by mtime)."""
    meta = json.dumps(
        {"arch": spec.name, "num_classes": spec.num_classes, "format": 1})
    flat = _flatten(params)
    if dtype is not None:
        flat = {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
                else v for k, v in flat.items()}
    flat["__meta__"] = np.frombuffer(meta.encode("utf-8"),
                                     dtype=np.uint8).copy()
    tmp = path + ".tmp.npz"  # the suffix keeps np.savez from adding one
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_npz(path: str) -> Tuple[ModelSpec, Dict[str, Any]]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        spec = yolov3.get_spec(meta["arch"], meta["num_classes"])
        params: Dict[str, Any] = {}
        for key in z.files:
            if key == "__meta__":
                continue
            v = z[key]
            if v.dtype == np.float16:   # storage-compressed checkpoint
                v = v.astype(np.float32)
            parts = key.split("/")
            node = params.setdefault(parts[0], {})
            if parts[1] == "bn":
                node.setdefault("bn", {})[parts[2]] = v
            else:
                node[parts[1]] = v
    return spec, params


def synthetic_params(spec: ModelSpec, seed: int = 0) -> Dict[str, Any]:
    """Deterministic random weights (Kaiming-style for LeakyReLU, BN at
    identity), drawn in spec order from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    params: Dict[str, Any] = {}
    gain = math.sqrt(2.0 / (1 + layers.LEAKY_SLOPE ** 2))
    for l, (in_ch, o, k) in zip(spec.conv_specs(),
                                yolov3.conv_io_channels(spec)):
        std = gain / math.sqrt(k * k * in_ch)
        w = (rng.randn(k, k, in_ch, o) * std).astype(np.float32)
        if l.bn:
            params[l.name] = {
                "w": w,
                "bn": {
                    "gamma": np.ones((o,), np.float32),
                    "beta": np.zeros((o,), np.float32),
                    "mean": np.zeros((o,), np.float32),
                    "var": np.ones((o,), np.float32),
                },
            }
        else:
            params[l.name] = {"w": w, "b": np.zeros((o,), np.float32)}
    return params


def fold_params(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold every conv's BN into weight + bias (numpy)."""
    return {l.name: layers.fold_conv_bn(params[l.name])
            for l in spec.conv_specs()}


def from_jax_params(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's folded parameters from a JAX-package parameter tree.

    ``params`` is that package's pytree with its leaves as numpy arrays
    ({conv: {"w" HWIO, "b"} or {"w", "bn": {gamma, beta, mean, var}}},
    folded or not); the result feeds YoloNet / DetectionEngine(folded=True).
    """
    return fold_params(spec, {
        name: {k: ({kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
                   if isinstance(v, dict) else np.asarray(v, np.float32))
               for k, v in p.items()}
        for name, p in params.items()})


def from_jax_qparams(spec: ModelSpec,
                     qparams: Dict[str, Any]) -> Dict[str, Any]:
    """The port's int8 parameters from a JAX-package ``quantize_params``
    tree (leaves as numpy arrays: int8 ``w_q``, f32 ``w_scale``, ``b``,
    ``x_scale`` and ``y_scale``; ``w``/``b`` for the float head convs).

    Leaves keep their dtypes and values, so given the same scales both
    packages compute the same int8 network (models/quantize.Int8Net)."""
    out: Dict[str, Any] = {}
    for l in spec.conv_specs():
        p = qparams[l.name]
        if "w_q" not in p:
            out[l.name] = {k: np.asarray(p[k], np.float32)
                           for k in ("w", "b")}
            continue
        out[l.name] = {k: (np.asarray(v, np.int8) if k == "w_q"
                           else np.asarray(v, np.float32))
                       for k, v in p.items()}
    return out


def load_model(
    path: str, arch: Optional[str] = None, num_classes: int = 80
) -> Tuple[ModelSpec, Dict[str, Any]]:
    """Load weights from ``path``; returns (spec, unfolded params).

    Accepted forms:
      - ``*.npz``               our format (arch/classes self-described)
      - ``*.weights``           Darknet (arch inferred from the file size
                                when not given: tries tiny, then full)
      - ``*.onnx``              ONNX (models/onnx_io.py)
      - ``synthetic[:arch]``    deterministic random weights
    """
    if path.startswith("synthetic"):
        _, _, a = path.partition(":")
        spec = yolov3.get_spec(a or arch or "full", num_classes)
        return spec, synthetic_params(spec)
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".weights"):
        last_err: Optional[Exception] = None
        for a in ([arch] if arch else ["tiny", "full"]):
            spec = yolov3.get_spec(a, num_classes)
            try:
                return spec, load_darknet(path, spec)
            except ValueError as e:
                last_err = e
        raise ValueError(
            f"could not match {path} to an architecture: {last_err}")
    if path.endswith(".onnx"):
        from fastdet_tpu_torch.models import onnx_io

        return onnx_io.load_onnx(path, arch=arch, num_classes=num_classes)
    raise ValueError(f"unrecognized weights path: {path!r}")
