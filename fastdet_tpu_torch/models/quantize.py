"""Post-training int8 quantization for the YOLOv3 family.

The port of the JAX package's models/quantize.py: the same scheme, the
same scales and the same int8 network, bit for bit where the arithmetic
is integer or elementwise (tests/test_torch_quantize.py).

- **weights**: symmetric per-output-channel int8
  (w_scale[o] = max|w[..,o]| / 127), quantized in numpy as there;
- **activations**: symmetric per-tensor int8 with static scales from one
  calibration forward (f32, TF32 off) over representative frames, which
  records each conv input's and each bn-conv output's absolute maximum;
- **int8-through**: a bn-conv whose successor consumes int8 (a bn-conv,
  a max-pool or a space-to-depth) requantizes its own output in the
  epilogue and the next conv reads the int8 tensor directly; routes,
  shortcuts and the detection heads are float boundaries, and the head
  convs (bn=False) stay float.

The int8 convolution (an XLA convolution with ``preferred_element_type
=int32`` in the JAX package, no Pallas kernel) has two routes with the
same int32 sums:

- on the card, :func:`conv_int8_mm`: NHWC patches built from the
  channels-last activation as k*k shifted views concatenated on channels,
  then ``torch._int_mm`` — an exact int32 accumulation on the int8
  tensor cores;
- on the CPU, :func:`conv_int8_split`, the JAX package's CPU route and
  the plain version: both operands split into 4-bit halves, four f32
  convolutions whose sums stay below 2^22 (exact in f32), recombined in
  int32.

The epilogue keeps the JAX package's float operations one for one:
requantize by multiplying with the f32 reciprocal ``1 / s`` (round half
to even, clip to +-127), ``y * scale + b`` as two separate f32 operations
(no fused multiply-add), leaky ReLU as ``where(x >= 0, x, 0.1 * x)``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.models import layers
from fastdet_tpu_torch.models.yolov3 import (
    Conv, MaxPool, ModelSpec, Route, Shortcut, SpaceToDepth, Upsample,
    YoloHead, YoloNet)


def emits_int8(spec: ModelSpec) -> Dict[str, bool]:
    """Per bn-conv: does its output stay int8 (chain successor consumes
    int8 directly)? Routes/shortcuts/heads force a float boundary."""
    out: Dict[str, bool] = {}
    ls = spec.layers
    for i, l in enumerate(ls):
        if isinstance(l, Conv) and l.bn:
            nxt = ls[i + 1] if i + 1 < len(ls) else None
            out[l.name] = isinstance(nxt, (MaxPool, SpaceToDepth)) or (
                isinstance(nxt, Conv) and nxt.bn
            )
    return out


def _nchw(images, dev: torch.device) -> torch.Tensor:
    """(N, H, W, 3) f32 numpy/tensor -> NCHW channels-last f32 on dev."""
    x = torch.as_tensor(images, dtype=torch.float32).to(dev)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def collect_act_absmax(spec: ModelSpec, folded_params: Dict[str, Any],
                       images, device="cuda"):
    """One calibration forward in f32: per-conv input absmax and bn-conv
    output absmax (post-activation), as 0-d float32 tensors."""
    dev = device_mod.resolve(device)
    device_mod.strict_fp32()
    net = YoloNet(spec, folded_params, dtype=torch.float32, device=dev)
    stats_in: Dict[str, torch.Tensor] = {}
    stats_out: Dict[str, torch.Tensor] = {}

    def record(l: Conv, x, y):
        stats_in[l.name] = x.abs().amax()
        if l.bn:
            stats_out[l.name] = y.abs().amax()

    with torch.inference_mode():
        net(torch.as_tensor(images, dtype=torch.float32).to(dev),
            on_conv=record)
    return stats_in, stats_out


def calibrate(
    spec: ModelSpec,
    folded_params: Dict[str, Any],
    calib_images: np.ndarray,        # (N, H, W, 3) uint8 or f32 [0,1]
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Static per-layer activation scales from representative frames.

    Returns {conv_name: {"x": input_scale, "y": output_scale}} ("y" only
    for bn convs). The forward runs on ``device`` in true f32."""
    imgs = np.asarray(calib_images)
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    sin, sout = collect_act_absmax(spec, folded_params, imgs, device)
    names_in = list(sin)
    names_out = list(sout)
    # two device-to-host copies, not one per layer
    vin = torch.stack([sin[n] for n in names_in]).cpu().numpy()
    vout = torch.stack([sout[n] for n in names_out]).cpu().numpy()
    scales: Dict[str, Dict[str, float]] = {}
    for name, v in zip(names_in, vin):
        scales[name] = {"x": float(max(v, 1e-6)) / 127.0}
    for name, v in zip(names_out, vout):
        scales[name]["y"] = float(max(v, 1e-6)) / 127.0
    return scales


def quantize_params(
    spec: ModelSpec,
    folded_params: Dict[str, Any],
    act_scales: Dict[str, Dict[str, float]],
) -> Dict[str, Any]:
    """int8 weights + scales (numpy); head (bn=False) convs pass through
    float. ``y_scale`` is attached only where the conv's output stays
    int8 (see emits_int8); elsewhere the epilogue emits f32 directly."""
    emit = emits_int8(spec)
    out: Dict[str, Any] = {}
    for l in spec.layers:
        if not isinstance(l, Conv):
            continue
        p = folded_params[l.name]
        if not l.bn:  # float head conv
            out[l.name] = {"w": p["w"], "b": p["b"]}
            continue
        w = np.asarray(p["w"], np.float32)
        w_scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-8) / 127.0
        w_q = np.clip(np.round(w / w_scale[None, None, None, :]), -127, 127)
        entry = {
            "w_q": w_q.astype(np.int8),
            "w_scale": w_scale,
            "b": p["b"],
            "x_scale": np.float32(act_scales[l.name]["x"]),
        }
        if emit.get(l.name) and "y" in act_scales[l.name]:
            entry["y_scale"] = np.float32(act_scales[l.name]["y"])
        out[l.name] = entry
    return out


# ---------------------------------------------------------------------------
# The int8 convolution: int32 accumulators of an int8 activation and int8
# HWIO weights, NCHW logical / channels-last memory in and out
# ---------------------------------------------------------------------------

def _padding(ksize: int, pad):
    """((top, bottom), (left, right)): Darknet's symmetric (k-1)//2 or
    the explicit override."""
    if pad is None:
        p = (ksize - 1) // 2
        return (p, p), (p, p)
    return pad


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def mm_weight(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (k, k, C, O) -> the GEMM weight (O8, K8) int8, K = k*k*C
    in (row tap, column tap, channel) order, both padded with zeros to
    multiples of 8 (torch._int_mm's K and N)."""
    k1, k2, c, o = w_q.shape
    wm = w_q.reshape(k1 * k2 * c, o).t()
    return F.pad(wm, (0, _round_up(k1 * k2 * c, 8) - k1 * k2 * c,
                      0, _round_up(o, 8) - o)).contiguous()


def conv_int8_mm(xq: torch.Tensor, wmat: torch.Tensor, ksize: int,
                 stride: int, pad, out_channels: int) -> torch.Tensor:
    """The card's route: patches + ``torch._int_mm`` (exact int32).

    xq (B, C, H, W) int8, any memory format (channels-last is free);
    ``wmat`` from :func:`mm_weight`. Returns (B, O, Ho, Wo) int32 in
    channels-last memory."""
    (t, bo), (le, r) = _padding(ksize, pad)
    x = F.pad(xq.permute(0, 2, 3, 1), (0, 0, le, r, t, bo))   # NHWC
    b, hp, wp, c = x.shape
    ho = (hp - ksize) // stride + 1
    wo = (wp - ksize) // stride + 1
    taps = [x[:, di:di + stride * (ho - 1) + 1:stride,
              dj:dj + stride * (wo - 1) + 1:stride, :]
            for di in range(ksize) for dj in range(ksize)]
    k = ksize * ksize * c
    if wmat.shape[1] > k:
        taps.append(x.new_zeros((b, ho, wo, wmat.shape[1] - k)))
    a = torch.cat(taps, dim=-1).reshape(b * ho * wo, -1)
    m = a.shape[0]
    if m <= 16:                                   # _int_mm needs M > 16
        a = F.pad(a, (0, 0, 0, 17 - m))
    acc = torch._int_mm(a, wmat.t())[:m, :out_channels]
    return acc.reshape(b, ho, wo, out_channels).permute(0, 3, 1, 2)


def conv_int8_split(xq: torch.Tensor, w_q: torch.Tensor, stride: int,
                    pad) -> torch.Tensor:
    """The plain version (the JAX package's CPU route): exact int32 sums
    from four f32 convolutions of 4-bit halves.

    xq (B, C, H, W) int8, w_q (k, k, C, O) HWIO int8 -> (B, O, Ho, Wo)
    int32. Every partial sum stays below 2^22, exact in f32 in any
    order; on the card cuDNN is switched off around the four calls (a
    process-wide switch: the card's route is meant for checks), so no
    Winograd or FFT algorithm can round them — PyTorch's own im2col +
    GEMM runs, TF32 off."""
    (t, bo), (le, r) = _padding(w_q.shape[0], pad)
    x = F.pad(xq.to(torch.int32), (le, r, t, bo))
    xh = x >> 4
    xl = x - (xh << 4)                                # in [0, 15]
    w = w_q.to(torch.int32).permute(3, 2, 0, 1)        # OIHW
    wh = w >> 4
    wl = w - (wh << 4)

    def c(a, b):
        return torch.round(F.conv2d(a.float(), b.float(),
                                    stride=stride)).to(torch.int32)

    bypass = (torch.backends.cudnn.flags(enabled=False, allow_tf32=False)
              if x.device.type == "cuda" else contextlib.nullcontext())
    with bypass:
        return ((c(xh, wh) << 8) + ((c(xh, wl) + c(xl, wh)) << 4)
                + c(xl, wl))


def _quantize(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x * (1/s)), -127, 127) as int8; round half to even."""
    return torch.clamp(torch.round(x.float() * inv_scale),
                       -127, 127).to(torch.int8)


def _int8_safe(fn, x: torch.Tensor) -> torch.Tensor:
    """Max-pool / upsample of an int8 tensor through f32 (exact: both
    only select values)."""
    if x.dtype == torch.int8:
        return fn(x.float()).to(torch.int8)
    return fn(x)


class Int8Net(nn.Module):
    """int8-through quantized forward over :func:`quantize_params`
    output; the same interface as YoloNet: (B, H, W, 3) float in [0, 1]
    -> per-scale NHWC float32 heads.

    The walk carries (tensor, scale): scale None means the tensor is f32;
    otherwise it is int8 and ``tensor * scale`` recovers the float value.
    Scales and reciprocals are 0-d float32 tensors computed in numpy
    (f32 division, as XLA's). Int8 convolutions go through
    :meth:`accumulate`: :func:`conv_int8_mm` on the card,
    :func:`conv_int8_split` on the CPU. ``device`` is the card by
    default (:func:`fastdet_tpu_torch.device.resolve`)."""

    def __init__(self, spec: ModelSpec, qparams: Dict[str, Any], *,
                 device="cuda"):
        super().__init__()
        self.spec = spec
        self.device = device_mod.resolve(device)
        dev = self.device

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        self.float_convs: Dict[str, tuple] = {}
        self.w_q: Dict[str, torch.Tensor] = {}    # HWIO, the CPU's route
        self.wmat: Dict[str, torch.Tensor] = {}   # GEMM form, the card's
        self.w_scale: Dict[str, torch.Tensor] = {}
        self.bias: Dict[str, torch.Tensor] = {}
        self.x_scale: Dict[str, torch.Tensor] = {}
        self.x_inv: Dict[str, torch.Tensor] = {}
        self.y_scale: Dict[str, torch.Tensor] = {}
        self.y_inv: Dict[str, torch.Tensor] = {}
        one = np.float32(1.0)
        for l in spec.conv_specs():
            p = qparams[l.name]
            if "w_q" not in p:
                w = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
                self.float_convs[l.name] = (
                    w.to(dev).contiguous(memory_format=torch.channels_last),
                    f32(p["b"]))
                continue
            w_q = torch.from_numpy(np.asarray(p["w_q"], np.int8)).to(dev)
            if dev.type == "cuda":
                self.wmat[l.name] = mm_weight(w_q)
            else:
                self.w_q[l.name] = w_q
            self.w_scale[l.name] = f32(p["w_scale"])
            self.bias[l.name] = f32(p["b"])
            self.x_scale[l.name] = f32(p["x_scale"])
            self.x_inv[l.name] = f32(one / np.float32(p["x_scale"]))
            if "y_scale" in p:
                self.y_scale[l.name] = f32(p["y_scale"])
                self.y_inv[l.name] = f32(one / np.float32(p["y_scale"]))

    def accumulate(self, xq: torch.Tensor, l: Conv) -> torch.Tensor:
        """int32 accumulators of conv ``l`` on the int8 input ``xq``."""
        if xq.device.type == "cuda":
            return conv_int8_mm(xq, self.wmat[l.name], l.ksize, l.stride,
                                l.pad, l.filters)
        return conv_int8_split(xq, self.w_q[l.name], l.stride, l.pad)

    def epilogue(self, y: torch.Tensor, l: Conv, s_in: torch.Tensor):
        """Accumulators of conv ``l`` (input scale ``s_in``) -> (output,
        its scale): ``y * (s_in * w_scale) + b`` as two f32 operations,
        leaky ReLU, and the requantization to int8 where the output stays
        int8 (scale None: an f32 output)."""
        scale = (s_in * self.w_scale[l.name])[None, :, None, None]
        yf = y.float() * scale
        yf = yf + self.bias[l.name][None, :, None, None]
        if l.act:
            yf = layers.leaky_relu(yf)
        if l.name in self.y_scale:
            return _quantize(yf, self.y_inv[l.name]), self.y_scale[l.name]
        return yf, None

    def _next_conv(self, li: int) -> Optional[Conv]:
        return next((m for m in self.spec.layers[li + 1:]
                     if isinstance(m, Conv)), None)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        def deq(t, s):
            return t if s is None else t.float() * s

        outputs: List[Any] = []   # (tensor, scale)
        heads: List[torch.Tensor] = []
        cur, cs = _nchw(x, self.device), None
        for li, l in enumerate(self.spec.layers):
            if isinstance(l, Conv) and l.name in self.float_convs:
                w, b = self.float_convs[l.name]          # float head conv
                cur, cs = layers.conv_block(deq(cur, cs), w, b, l.stride,
                                            l.act, l.pad), None
            elif isinstance(l, Conv):
                if cs is None:
                    s_in = self.x_scale[l.name]
                    xq = _quantize(cur, self.x_inv[l.name])
                else:
                    # int8-through: consume the producer's tensor directly
                    s_in, xq = cs, cur
                cur, cs = self.epilogue(self.accumulate(xq, l), l, s_in)
            elif isinstance(l, SpaceToDepth):
                # quantize BEFORE the relayout when the consumer conv is
                # int8: s2d is value-preserving and the scale per tensor,
                # so quantize -> s2d == s2d -> quantize exactly
                nxt = self._next_conv(li)
                if cs is None and nxt is not None and nxt.name in self.w_scale:
                    cur = _quantize(cur, self.x_inv[nxt.name])
                    cs = self.x_scale[nxt.name]
                cur = layers.space_to_depth(cur, l.factor, l.pad_channels)
            elif isinstance(l, MaxPool):
                cur = _int8_safe(
                    lambda t: layers.maxpool2d(t, l.size, l.stride), cur)
            elif isinstance(l, Upsample):
                cur = _int8_safe(layers.upsample2x, cur)
            elif isinstance(l, Route):
                srcs = [outputs[i] for i in l.sources]
                if len(srcs) == 1:
                    cur, cs = srcs[0]
                else:
                    cur, cs = torch.cat([deq(t, s) for t, s in srcs],
                                        dim=1), None
            elif isinstance(l, Shortcut):
                t2, s2 = outputs[l.source]
                cur, cs = deq(cur, cs) + deq(t2, s2), None
            elif isinstance(l, YoloHead):
                heads.append(deq(cur, cs).permute(0, 2, 3, 1).float()
                             .contiguous())
            outputs.append((cur, cs))
        return heads
