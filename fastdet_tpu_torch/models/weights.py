"""Weight loading for the YOLOv3 family (numpy in, numpy out).

The port reads the JAX package's checkpoints unchanged:

- **``.npz``** — the native format: a flat numpy archive with a tiny
  metadata header (arch, num_classes); f16-stored leaves are upcast.
- **synthetic** — deterministic random weights from a numpy seed (the
  same generator and draw order as the JAX package, so
  ``synthetic:<arch>`` is the same model in both packages).

Loaders return *unfolded* parameter trees {conv: {"w" HWIO, "b" | "bn"}}
of numpy arrays; :func:`fold_params` folds BN for inference. Darknet
``.weights`` import is not ported yet.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from fastdet_tpu_torch.models import layers, yolov3
from fastdet_tpu_torch.models.yolov3 import ModelSpec


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
      - ``synthetic[:arch]``    deterministic random weights
    """
    if path.startswith("synthetic"):
        _, _, a = path.partition(":")
        spec = yolov3.get_spec(a or arch or "full", num_classes)
        return spec, synthetic_params(spec)
    if path.endswith(".npz"):
        return load_npz(path)
    raise ValueError(f"unrecognized weights path: {path!r} (the port "
                     f"loads .npz and synthetic[:arch]; darknet .weights "
                     f"and .onnx import are not ported yet)")
