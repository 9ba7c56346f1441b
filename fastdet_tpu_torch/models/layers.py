"""Neural-net layers of the YOLOv3 family, in PyTorch.

Counterparts of the JAX package's models/layers.py. Activations here are
NCHW tensors (kept in channels-last memory by the caller, the layout
cuDNN prefers); the model's public functions stay NHWC
(models/yolov3.YoloNet).

- Convolutions use explicit symmetric padding (k-1)//2 — the Darknet
  convention all YOLOv3 weights were trained under (for stride-2 3x3 it
  reads windows [2i-1, 2i+1]). They are cuDNN calls, as the JAX package
  left its convolutions to XLA.
- Batch norm is folded into the conv weight + bias for inference
  (:func:`fold_conv_bn`, numpy, identical to the JAX package's host
  fold).
- :func:`space_to_depth` keeps the JAX package's phase-major channel
  order on NCHW tensors in channels-last memory.
- Training (:func:`conv2d_train`, :func:`batch_norm_train_stats`,
  :func:`conv_bn_block_train`) keeps the JAX package's conventions: the
  conv runs in the compute dtype, batch norm normalises with the batch
  mean and the *biased* variance computed in float32, and LeakyReLU is
  ``where(x >= 0, ...)``, whose gradient at exactly 0 is 1 (that of
  ``F.leaky_relu`` is 0.1 there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 0.1

Params = Dict[str, Any]


def conv_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int = 1, act: bool = True, pad=None) -> torch.Tensor:
    """Inference conv block: conv + bias (+ LeakyReLU 0.1); NCHW, OIHW.

    ``pad`` is an explicit ((top, bottom), (left, right)) override; None
    means Darknet's symmetric (k-1)//2."""
    if pad is None:
        p = (w.shape[-1] - 1) // 2
        y = F.conv2d(x, w, b, stride=stride, padding=p)
    else:
        (t, bo), (le, r) = pad
        y = F.conv2d(F.pad(x, (le, r, t, bo)), w, b, stride=stride)
    return F.leaky_relu(y, LEAKY_SLOPE) if act else y


def conv2d_train(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pad=None) -> torch.Tensor:
    """Training-path convolution, NCHW / OIHW: operands and output in
    ``x``'s dtype (the compute dtype; cuDNN accumulates bf16 products in
    float32 either way), as the JAX package's ``conv2d_train``. ``pad``
    as in :func:`conv_block`."""
    w = w.to(x.dtype)
    if pad is None:
        return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)
    (t, bo), (le, r) = pad
    return F.conv2d(F.pad(x, (le, r, t, bo)), w, stride=stride)


def batch_norm_train_stats(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor):
    """Training BN over (N, H, W) of an NCHW tensor; returns (y, batch
    mean, batch var) so the train step can EMA the running statistics.

    The statistics are float32 (float64 for a float64 ``x``, so the step
    can run in float64 as a reference) and the variance is the biased one
    (the JAX package's ``jnp.var``); ``y`` is ``(x - mean) * rsqrt(var +
    eps) * gamma + beta`` at that precision, cast back to ``x``'s dtype.
    No ``nn.BatchNorm2d``: its running-stat update uses the unbiased
    variance and another momentum convention."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var + BN_EPS)
    y = ((x32 - mean[:, None, None]) * inv[:, None, None]
         * gamma[:, None, None] + beta[:, None, None])
    return y.to(x.dtype), mean, var


def conv_bn_block_train(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                        act: bool = True, pad=None, *, bn=None,
                        b: Optional[torch.Tensor] = None):
    """Training conv block: conv + batch-stat BN (``bn`` = (gamma, beta))
    or + bias ``b`` in the compute dtype, then LeakyReLU when ``act``.
    Returns (y, stats): stats = (batch mean, batch var) with ``bn``, else
    None."""
    y = conv2d_train(x, w, stride, pad)
    stats = None
    if bn is not None:
        y, mean, var = batch_norm_train_stats(y, *bn)
        stats = (mean, var)
    else:
        y = y + b.to(y.dtype)[:, None, None]
    return (leaky_relu(y) if act else y), stats


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``where(x >= 0, x, 0.1 * x)``, the JAX package's spelling (the int8
    epilogue must match it bit for bit)."""
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def space_to_depth(x: torch.Tensor, factor: int = 2,
                   pad_channels: int = 0) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, f*f*C [+ pad zeros], H/f, W/f), returned
    in channels-last memory; any dtype.

    Phase-major channel order, as the JAX package's NHWC version: out
    channel = p*(f*C) + q*C + c for row phase p and column phase q (the
    value at row f*i + p, column f*j + q). ``pad_channels`` appends zero
    channels."""
    f = factor
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)                       # (B, H, W, C)
    y = nhwc.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, h // f, w // f, f * f * c)
    if pad_channels:
        y = F.pad(y, (0, pad_channels))
    return y.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def fold_conv_bn(params: Params) -> Params:
    """Fold BN statistics into conv weight+bias for inference (numpy).

    w' = w * gamma / sqrt(var + eps)   (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)
    """
    if "bn" not in params:
        return {"w": np.asarray(params["w"]), "b": np.asarray(params["b"])}
    bn = {k: np.asarray(v) for k, v in params["bn"].items()}
    inv = bn["gamma"] / np.sqrt(bn["var"] + BN_EPS)
    w = np.asarray(params["w"]) * inv[None, None, None, :]
    b = bn["beta"] - bn["mean"] * inv
    return {"w": w, "b": b}


def maxpool2d(x: torch.Tensor, size: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pooling with Darknet padding semantics (NCHW).

    size=2/stride=2 on even inputs needs no padding; size=2/stride=1 (the
    yolov3-tiny 13x13 pool) pads (0, 1) on each spatial dim with -inf,
    matching Darknet's asymmetric maxpool padding."""
    if not (stride == size and x.shape[2] % size == 0):
        total = size - 1
        lo = total // 2
        x = F.pad(x, (lo, total - lo, lo, total - lo), value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample (Darknet 'upsample' layer)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
