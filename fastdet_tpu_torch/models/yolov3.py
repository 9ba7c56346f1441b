"""YOLOv3 model family: declarative graph specs + a PyTorch interpreter.

The specs are plain dataclasses, field for field those of the JAX
package's models/yolov3.py (a flat layer list in Darknet .cfg order, conv
names conv0..convN). :class:`YoloNet` walks a spec as an ``nn.Module``;
its public interface is NHWC like the JAX interpreter (input (B, H, W, 3)
in [0, 1], heads (B, h, w, 3*(5+C)) float32), while inside it runs NCHW
tensors in channels-last memory, the layout cuDNN prefers.
:class:`TrainNet` is the trainable interpreter, the counterpart of the
JAX ``apply(train=True)``.

Models:

- ``yolov3``       full Darknet-53 backbone, 3 detection scales (13/26/52)
- ``yolov3-tiny``  7-conv backbone, 2 detection scales (13/26)

Output order matches the reference anchor-table order: largest-stride grid
first (13x13, biggest anchors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.models import layers

IMAGE_SIZE = 416

# Anchor tables, pixel units at 416x416 — identical values to the
# reference's ONNXDetector.ANCHORS (server/detector.py:96-106).
ANCHORS_FULL = (
    ((116, 90), (156, 198), (373, 326)),  # 13x13
    ((30, 61), (62, 45), (59, 119)),      # 26x26
    ((10, 13), (16, 30), (33, 23)),       # 52x52
)
ANCHORS_TINY = (
    ((81, 82), (135, 169), (344, 319)),   # 13x13
    ((10, 14), (23, 27), (37, 58)),       # 26x26
)


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Conv:
    filters: int
    ksize: int = 3
    stride: int = 1
    bn: bool = True
    act: bool = True           # LeakyReLU(0.1) when True, linear when False
    name: str = ""             # filled in by _finalize
    # Explicit ((top, bottom), (left, right)) padding override; None =
    # Darknet SAME ((k-1)//2 each side). Set by the space-to-depth stem
    # rewrite (models/s2d.py), whose 2x2 conv needs asymmetric pads.
    pad: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None


@dataclass(frozen=True)
class MaxPool:
    size: int = 2
    stride: int = 2


@dataclass(frozen=True)
class SpaceToDepth:
    """(H, W, C) -> (H/f, W/f, f*f*C [+ pad_channels zeros]), phase-major
    channel order (row phase, column phase, source channel). A pure
    relayout, inserted by the inference-only stem rewrite (models/s2d.py)
    in front of the rewritten first convolutions; value-preserving, so
    int8 tensors pass through it unchanged. ``pad_channels`` appends
    zero channels (the consumer conv's weights get matching zero rows)."""
    factor: int = 2
    pad_channels: int = 0


@dataclass(frozen=True)
class Upsample:
    pass


@dataclass(frozen=True)
class Route:
    """Concatenate the outputs of earlier layers along channels."""
    sources: Tuple[int, ...]


@dataclass(frozen=True)
class Shortcut:
    """Residual add with the output of an earlier layer."""
    source: int


@dataclass(frozen=True)
class YoloHead:
    """Marks the previous layer's output as a detection output."""
    scale: int  # 0 = 13x13 (largest anchors), 1 = 26x26, 2 = 52x52


Spec = Any


@dataclass(frozen=True)
class ModelSpec:
    name: str
    num_classes: int
    layers: Tuple[Spec, ...]
    anchors: Tuple[Tuple[Tuple[int, int], ...], ...]
    image_size: int = IMAGE_SIZE

    @property
    def num_outputs(self) -> int:
        return len(self.anchors)

    @property
    def head_channels(self) -> int:
        return 3 * (5 + self.num_classes)

    def conv_specs(self) -> List[Conv]:
        return [l for l in self.layers if isinstance(l, Conv)]


def _finalize(name: str, num_classes: int, specs: List[Spec], anchors) -> ModelSpec:
    """Assign stable conv names (conv0..convN in graph order)."""
    out: List[Spec] = []
    ci = 0
    for s in specs:
        if isinstance(s, Conv):
            out.append(Conv(s.filters, s.ksize, s.stride, s.bn, s.act,
                            f"conv{ci}", s.pad))
            ci += 1
        else:
            out.append(s)
    return ModelSpec(name, num_classes, tuple(out), anchors)


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------

def yolov3_tiny_spec(num_classes: int = 80) -> ModelSpec:
    """YOLOv3-tiny: 2 detection scales, anchors per ANCHORS_TINY."""
    head = 3 * (5 + num_classes)
    s: List[Spec] = [
        Conv(16), MaxPool(),                   # 0,1   416 -> 208
        Conv(32), MaxPool(),                   # 2,3   -> 104
        Conv(64), MaxPool(),                   # 4,5   -> 52
        Conv(128), MaxPool(),                  # 6,7   -> 26
        Conv(256),                             # 8     26x26x256 (routed below)
        MaxPool(),                             # 9     -> 13
        Conv(512),                             # 10
        MaxPool(size=2, stride=1),             # 11    stays 13
        Conv(1024),                            # 12
        Conv(256, ksize=1),                    # 13    (routed below)
        Conv(512),                             # 14
        Conv(head, ksize=1, bn=False, act=False),  # 15
        YoloHead(0),                           # 16    13x13 output
        Route((13,)),                          # 17
        Conv(128, ksize=1),                    # 18
        Upsample(),                            # 19    -> 26
        Route((19, 8)),                        # 20    128+256 ch
        Conv(256),                             # 21
        Conv(head, ksize=1, bn=False, act=False),  # 22
        YoloHead(1),                           # 23    26x26 output
    ]
    return _finalize("yolov3-tiny", num_classes, s, ANCHORS_TINY)


def yolov3_spec(num_classes: int = 80) -> ModelSpec:
    """Full YOLOv3: Darknet-53 backbone + FPN-style 3-scale head."""
    head = 3 * (5 + num_classes)
    s: List[Spec] = []

    def res_block(in_half: int):
        # 1x1 squeeze + 3x3 expand + residual add with the block input.
        base = len(s) - 1
        s.append(Conv(in_half, ksize=1))
        s.append(Conv(in_half * 2))
        s.append(Shortcut(base))

    s.append(Conv(32))                          # 0
    s.append(Conv(64, stride=2))                # 1   416 -> 208
    res_block(32)                               # 2,3,4
    s.append(Conv(128, stride=2))               # 5   -> 104
    for _ in range(2):
        res_block(64)                           # 6..11
    s.append(Conv(256, stride=2))               # 12  -> 52
    for _ in range(8):
        res_block(128)                          # 13..36 (layer 36 routed)
    s.append(Conv(512, stride=2))               # 37  -> 26
    for _ in range(8):
        res_block(256)                          # 38..61 (layer 61 routed)
    s.append(Conv(1024, stride=2))              # 62  -> 13
    for _ in range(4):
        res_block(512)                          # 63..74

    # Head, scale 0 (13x13)
    s += [Conv(512, ksize=1), Conv(1024), Conv(512, ksize=1),
          Conv(1024), Conv(512, ksize=1)]       # 75..79
    s += [Conv(1024),                           # 80
          Conv(head, ksize=1, bn=False, act=False),  # 81
          YoloHead(0)]                          # 82

    # Head, scale 1 (26x26)
    s += [Route((79,)), Conv(256, ksize=1), Upsample(), Route((85, 61))]  # 83..86
    s += [Conv(256, ksize=1), Conv(512), Conv(256, ksize=1),
          Conv(512), Conv(256, ksize=1)]        # 87..91
    s += [Conv(512),                            # 92
          Conv(head, ksize=1, bn=False, act=False),  # 93
          YoloHead(1)]                          # 94

    # Head, scale 2 (52x52)
    s += [Route((91,)), Conv(128, ksize=1), Upsample(), Route((97, 36))]  # 95..98
    s += [Conv(128, ksize=1), Conv(256), Conv(128, ksize=1),
          Conv(256), Conv(128, ksize=1)]        # 99..103
    s += [Conv(256),                            # 104
          Conv(head, ksize=1, bn=False, act=False),  # 105
          YoloHead(2)]                          # 106

    return _finalize("yolov3", num_classes, s, ANCHORS_FULL)


def get_spec(arch: str, num_classes: int = 80) -> ModelSpec:
    if arch in ("tiny", "yolov3-tiny"):
        return yolov3_tiny_spec(num_classes)
    if arch in ("full", "yolov3", "rsu"):
        return yolov3_spec(num_classes)
    raise ValueError(f"unknown architecture: {arch!r}")


# ---------------------------------------------------------------------------
# Channel flow and the spec interpreter
# ---------------------------------------------------------------------------

def conv_io_channels(spec: ModelSpec) -> List[Tuple[int, int, int]]:
    """(in_channels, filters, ksize) per conv in spec order, simulating
    channel flow through the layer graph (Route concatenates;
    MaxPool/Upsample/Shortcut/YoloHead preserve channels).

    The single channel-flow walker: weights.synthetic_params sizes
    weights from it, so a new layer type changes the flow in exactly one
    place.
    """
    out: List[Tuple[int, int, int]] = []
    channels: List[int] = []  # output channels per layer index
    in_ch = 3
    for l in spec.layers:
        if isinstance(l, Conv):
            out.append((in_ch, l.filters, l.ksize))
            in_ch = l.filters
        elif isinstance(l, Route):
            in_ch = sum(channels[i] for i in l.sources)
        elif isinstance(l, (MaxPool, Upsample, Shortcut, YoloHead)):
            pass
        channels.append(in_ch)
    return out


def _walk(spec: ModelSpec, x: torch.Tensor,
          conv: Callable[[Conv, torch.Tensor], torch.Tensor]
          ) -> List[torch.Tensor]:
    """Run ``spec``'s layers over (B, H, W, 3) ``x`` in NCHW channels-last
    memory, calling ``conv(layer, input)`` for each Conv; -> per-scale
    NHWC float32 heads. YoloNet and TrainNet differ only in ``conv``."""
    cur = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    outputs: List[torch.Tensor] = []
    heads: List[torch.Tensor] = []
    for l in spec.layers:
        if isinstance(l, Conv):
            cur = conv(l, cur)
        elif isinstance(l, SpaceToDepth):
            cur = layers.space_to_depth(cur, l.factor, l.pad_channels)
        elif isinstance(l, MaxPool):
            cur = layers.maxpool2d(cur, l.size, l.stride)
        elif isinstance(l, Upsample):
            cur = layers.upsample2x(cur)
        elif isinstance(l, Route):
            srcs = [outputs[i] for i in l.sources]
            cur = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
        elif isinstance(l, Shortcut):
            cur = cur + outputs[l.source]
        elif isinstance(l, YoloHead):
            heads.append(cur.permute(0, 2, 3, 1).float().contiguous())
        outputs.append(cur)
    assert len(heads) == spec.num_outputs
    return heads


class YoloNet(nn.Module):
    """Inference interpreter of a spec over FOLDED parameters.

    ``params`` is {conv_name: {"w": (k, k, in, out) HWIO, "b": (out,)}}
    as numpy arrays (:func:`fastdet_tpu_torch.models.weights.fold_params`);
    weights are stored OIHW in ``dtype`` on ``device`` (the card by
    default; :func:`fastdet_tpu_torch.device.resolve`). ``dtype`` is the
    compute dtype (bfloat16 or float32): activations, weights and biases
    all carry it, as the JAX interpreter casts them (layers.conv_block);
    cuDNN accumulates in float32 either way.
    """

    def __init__(self, spec: ModelSpec, params: Dict[str, Any], *,
                 dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        device = device_mod.resolve(device)
        self.spec = spec
        self.dtype = dtype
        self.weights = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for l in spec.conv_specs():
            p = params[l.name]
            w = torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
            w = w.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
            b = torch.from_numpy(np.asarray(p["b"], np.float32)).to(
                device=device, dtype=dtype)
            self.weights[l.name] = nn.Parameter(w, requires_grad=False)
            self.biases[l.name] = nn.Parameter(b, requires_grad=False)

    def forward(self, x: torch.Tensor,
                on_conv: Optional[Callable[[Conv, torch.Tensor,
                                            torch.Tensor], None]] = None
                ) -> List[torch.Tensor]:
        """(B, H, W, 3) float in [0, 1] -> per-scale NHWC float32 heads.

        ``on_conv(layer, x, y)``, when given, sees each conv's input and
        output (int8 calibration reads their absolute maxima)."""
        def conv(l: Conv, cur: torch.Tensor) -> torch.Tensor:
            y = layers.conv_block(cur, self.weights[l.name],
                                  self.biases[l.name], l.stride, l.act,
                                  l.pad)
            if on_conv is not None:
                on_conv(l, cur, y)
            return y

        return _walk(self.spec, x.to(self.dtype), conv)


class _TrainConv(nn.Module):
    """One conv's trainable state: the float32 master weight ``w`` (OIHW)
    and either BN ``gamma`` / ``beta`` with the running ``mean`` / ``var``
    as buffers, or the head conv's bias ``b``."""

    def __init__(self, p: Dict[str, Any], device: torch.device):
        super().__init__()

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(device)

        w = t(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
        self.w = nn.Parameter(w.contiguous(memory_format=torch.channels_last))
        if "bn" in p:
            bn = p["bn"]
            self.gamma = nn.Parameter(t(bn["gamma"]))
            self.beta = nn.Parameter(t(bn["beta"]))
            self.register_buffer("mean", t(bn["mean"]))
            self.register_buffer("var", t(bn["var"]))
        else:
            self.b = nn.Parameter(t(p["b"]))

    @property
    def has_bn(self) -> bool:
        return hasattr(self, "gamma")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).clone().numpy()


class TrainNet(nn.Module):
    """Trainable interpreter of a spec over UNFOLDED parameters: the
    counterpart of the JAX package's ``apply(train=True)``
    (fastdet_tpu/models/yolov3.py:288).

    Parameters are float32 masters (conv ``w``, BN ``gamma`` / ``beta``,
    head ``b``); BN's running ``mean`` / ``var`` are buffers, which only
    the train step's EMA changes (parallel/train.py). The forward casts
    the input and each weight to ``compute_dtype`` itself, as the JAX
    code does (no ``torch.autocast``, whose policy would run BN and other
    ops in other dtypes), normalises with batch statistics, and returns
    NHWC float32 heads. Build it with :meth:`from_params`; read it back
    with :meth:`to_params`."""

    def __init__(self, spec: ModelSpec, convs: Dict[str, _TrainConv]):
        super().__init__()
        self.spec = spec
        self.convs = nn.ModuleDict(convs)

    @classmethod
    def from_params(cls, spec: ModelSpec, params: Dict[str, Any], *,
                    device="cuda") -> "TrainNet":
        """From the unfolded numpy tree {conv: {"w" HWIO, "bn": {gamma,
        beta, mean, var}} or {"w", "b"}} that weights.load_model and the
        JAX package both use, on ``device`` (the card by default; true
        float32 there: :func:`fastdet_tpu_torch.device.strict_fp32`)."""
        device = device_mod.resolve(device)
        if device.type == "cuda":
            device_mod.strict_fp32()
        return cls(spec, {l.name: _TrainConv(params[l.name], device)
                          for l in spec.conv_specs()})

    def to_params(self) -> Dict[str, Any]:
        """The unfolded numpy tree (HWIO ``w``), float32 host copies."""
        out: Dict[str, Any] = {}
        for name, c in self.convs.items():
            w = np.ascontiguousarray(_host(c.w).transpose(2, 3, 1, 0))
            if c.has_bn:
                out[name] = {"w": w, "bn": {
                    k: _host(getattr(c, k))
                    for k in ("gamma", "beta", "mean", "var")}}
            else:
                out[name] = {"w": w, "b": _host(c.b)}
        return out

    def forward(self, x: torch.Tensor, compute_dtype=None,
                with_stats: bool = False):
        """(B, H, W, 3) float in [0, 1] -> per-scale NHWC float32 heads,
        and with ``with_stats`` also {conv: (batch mean, batch var)} of
        every BN layer (float32, still on the autograd graph)."""
        stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

        def conv(l: Conv, cur: torch.Tensor) -> torch.Tensor:
            c = self.convs[l.name]
            y, st = layers.conv_bn_block_train(
                cur, c.w, l.stride, l.act, l.pad,
                bn=(c.gamma, c.beta) if c.has_bn else None,
                b=None if c.has_bn else c.b)
            if st is not None:
                stats[l.name] = st
            return y

        if compute_dtype is not None:
            x = x.to(compute_dtype)
        heads = _walk(self.spec, x, conv)
        return (heads, stats) if with_stats else heads


def head_grid_sizes(spec: ModelSpec) -> List[int]:
    """Grid side length per head output, e.g. [13, 26, 52] for full."""
    return [spec.image_size // (32 >> i) for i in range(spec.num_outputs)]
