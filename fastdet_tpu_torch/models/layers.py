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
- Under a ('dp', 'tp') mesh (parallel/mesh.py) batch norm reduces its
  statistics over the dp group, and a channel-sharded conv
  (:func:`conv_bn_block_train` with ``tp``) runs on its shard of the
  output channels between two collectives of the tp group: the input's
  gradient is summed over the group, the output gathered. The gather is
  an all-reduce of a zero-filled full buffer (x + 0 = x, exact), which
  gloo runs on CUDA tensors too, where it has no all-gather.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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
                           beta: torch.Tensor, group=None):
    """Training BN over (N, H, W) of an NCHW tensor; returns (y, batch
    mean, batch var) so the train step can EMA the running statistics.

    The statistics are float32 (float64 for a float64 ``x``, so the step
    can run in float64 as a reference) and the variance is the biased one
    (the JAX package's ``jnp.var``); ``y`` is ``(x - mean) * rsqrt(var +
    eps) * gamma + beta`` at that precision, cast back to ``x``'s dtype.
    No ``nn.BatchNorm2d``: its running-stat update uses the unbiased
    variance and another momentum convention.

    Under a process group of more than one rank (the data-parallel step,
    parallel/train.make_sharded_train_step) the statistics are the
    global batch's, as the JAX step's under GSPMD: :func:`_global_var_mean`
    over ``group``, the ranks that hold other rows of the same channels
    (None: the default group).
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if _world_size(group) > 1:
        var, mean = _global_var_mean(x32, group)
    else:
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var + BN_EPS)
    y = ((x32 - mean[:, None, None]) * inv[:, None, None]
         * gamma[:, None, None] + beta[:, None, None])
    return y.to(x.dtype), mean, var


def _world_size(group=None) -> int:
    dist = torch.distributed
    return (dist.get_world_size(group)
            if dist.is_available() and dist.is_initialized() else 1)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in a new dense tensor (an NCHW
    gradient in channels-last memory, as the convolutions keep it)."""
    fmt = (torch.channels_last if t.dim() == 4 and not t.is_contiguous()
           else torch.contiguous_format)
    t = t.clone(memory_format=fmt)
    torch.distributed.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the backward pass sums the
    gradients the same way, so each rank's rows get the gradient of every
    rank's loss through the shared statistic."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _global_var_mean(x32: torch.Tensor, group=None):
    """(biased var, mean) per channel over every rank's (N, H, W) in
    ``group``, the two-pass ``jnp.var`` of the JAX step: all-reduce the
    per-channel sums for the mean, then the sums of squared deviations
    from it. Every rank holds an equal shard."""
    count = x32.shape[0] * x32.shape[2] * x32.shape[3] * _world_size(group)
    mean = _AllReduceSum.apply(x32.sum(dim=(0, 2, 3)), group) / count
    dev = x32 - mean[:, None, None]
    var = _AllReduceSum.apply((dev * dev).sum(dim=(0, 2, 3)), group) / count
    return var, mean


class TensorParallel(NamedTuple):
    """A net's tensor-parallel layout on this rank: its tp group, the
    group's size, the rank's index in it and the convs whose output
    channels are sharded over it (parallel/mesh.MeshGroups.
    tensor_parallel)."""

    group: Any
    size: int
    rank: int
    convs: frozenset = frozenset()


class _CopyToTP(torch.autograd.Function):
    """The identity forward; the backward sums the input's gradient over
    the tp group (each rank's shard of output channels contributes its
    part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather_channels(t: torch.Tensor, tp: TensorParallel,
                    dim: int = 0) -> torch.Tensor:
    """The full tensor of which ``t`` is tp rank ``tp.rank``'s shard along
    ``dim``: every shard written into its place in a zero-filled buffer,
    all-reduced over the tp group. Every rank of the group must call it."""
    c = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = c * tp.size
    full = t.new_zeros(shape)
    full.narrow(dim, tp.rank * c, c).copy_(t)
    torch.distributed.all_reduce(full, group=tp.group)
    return full


class _GatherChannels(torch.autograd.Function):
    """NCHW shards of channels -> the full NCHW tensor (channels-last
    memory) on every rank of the tp group; the backward keeps this rank's
    channels of the gradient (every rank computes the same full gradient
    downstream, which runs replicated)."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp, ctx.c = tp, y.shape[1]
        full = gather_channels(y.permute(0, 2, 3, 1), tp, dim=3)
        return full.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.tp.rank * ctx.c, ctx.c), None


def conv_bn_block_train(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                        act: bool = True, pad=None, *, bn=None,
                        b: Optional[torch.Tensor] = None, bn_group=None,
                        tp: Optional[TensorParallel] = None):
    """Training conv block: conv + batch-stat BN (``bn`` = (gamma, beta),
    statistics over ``bn_group``) or + bias ``b`` in the compute dtype,
    then LeakyReLU when ``act``. Returns (y, stats): stats = (batch mean,
    batch var) with ``bn``, else None.

    With ``tp`` the block is channel-sharded: ``w``, ``bn`` and ``b`` hold
    this rank's output channels, the input passes :class:`_CopyToTP`, and
    the block's output is gathered to every channel (``stats`` stay this
    rank's channels)."""
    if tp is not None:
        x = _CopyToTP.apply(x, tp.group)
    y = conv2d_train(x, w, stride, pad)
    stats = None
    if bn is not None:
        y, mean, var = batch_norm_train_stats(y, *bn, group=bn_group)
        stats = (mean, var)
    else:
        y = y + b.to(y.dtype)[:, None, None]
    y = leaky_relu(y) if act else y
    if tp is not None:
        y = _GatherChannels.apply(y, tp)
    return y, stats


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
