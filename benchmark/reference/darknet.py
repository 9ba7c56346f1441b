"""A Darknet layer list as a plain float32 PyTorch network.

Follows the published description (pjreddie/darknet ``cfg/yolov3.cfg``,
``cfg/yolov3-tiny.cfg``, arXiv:1804.02767; AlexeyAB/darknet's
``cfg/yolov4.cfg``, arXiv:2004.10934, for Mish and grouped routes):

- ``convolutional`` with ``pad=1`` pads (size-1)/2 on every side, batch
  norm in inference form ``(x - mean) / sqrt(var + eps) * gamma + beta``,
  then the activation: ``leaky`` (LeakyReLU(0.1)), ``mish``
  (``x * tanh(softplus(x))``) or ``linear``;
- ``maxpool`` pads ``size - 1`` in all (Darknet's default ``padding``),
  ``(size - 1) // 2`` of it before the window: size 2 pads right and
  bottom only, sizes 5, 9 and 13 (SPP) centre the window; the output is
  ``(n + size - 1 - size) // stride + 1`` wide;
- ``upsample`` repeats each pixel; ``route`` concatenates channels, of
  each source the ``group_id``-th of ``groups`` equal slices (the whole
  of it by default); ``shortcut`` adds; ``yolo`` marks a detection
  output (its ``scale_x_y`` is the decode's, :mod:`.detect`).

What it does not implement it refuses when built (:data:`READS`): a layer
key it does not read, a convolution's activation other than those above,
a shortcut's other than ``linear``. A configuration that needs more is
refused, never computed as another network.

Weights are a dict ``conv<i>`` -> ``{"w": (k, k, in, out), "bn":
{gamma, beta, mean, var}}`` or ``{"w", "b"}`` for the linear head convs,
numbered in layer order (the layout of the repository's ``.npz``
checkpoints, read here with numpy alone).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def load_npz(path: str) -> Dict[str, dict]:
    """A checkpoint ``.npz`` (keys ``conv<i>/w``, ``conv<i>/b``,
    ``conv<i>/bn/<field>``, ``__meta__``) as float32 numpy leaves."""
    out: Dict[str, dict] = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__meta__":
                continue
            parts = key.split("/")
            node = out.setdefault(parts[0], {})
            v = np.asarray(z[key], np.float32)
            if parts[1] == "bn":
                node.setdefault("bn", {})[parts[2]] = v
            else:
                node[parts[1]] = v
    return out


#: the keys of each layer type that :class:`DarknetF32` reads (besides
#: ``type``); any other key is refused
READS = {
    "convolutional": {"filters", "size", "stride", "pad", "batch_normalize",
                      "activation"},
    "maxpool": {"size", "stride"},
    "upsample": {"stride"},
    "route": {"layers", "groups", "group_id"},
    "shortcut": {"from", "activation"},
    "yolo": {"mask", "scale_x_y"},
}

#: a convolution's activations
ACTIVATIONS = ("leaky", "mish", "linear")


def check_layer(i: int, l: dict) -> None:
    """Raise ValueError, naming layer ``i`` and the key, where ``l`` asks
    for what this network does not compute."""
    t = l.get("type")
    if t not in READS:
        raise ValueError(f"layer {i}: unknown type {t!r}")
    extra = sorted(set(l) - READS[t] - {"type"})
    if extra:
        raise ValueError(f"layer {i} ({t}): key {extra[0]!r} is not "
                         f"implemented")
    if t == "convolutional" and l.get("activation") not in ACTIVATIONS:
        raise ValueError(f"layer {i} ({t}): key 'activation' "
                         f"{l.get('activation')!r} is not implemented")
    if t == "shortcut" and l.get("activation", "linear") != "linear":
        raise ValueError(f"layer {i} ({t}): key 'activation' "
                         f"{l['activation']!r} is not implemented")


class DarknetF32:
    """The network of ``cfg["layers"]`` over unfolded ``weights``, in
    float32 on ``device``. ``__call__`` takes (B, H, W, 3) uint8 frames
    and returns one (B, H', W', anchors, 5 + classes) float32 tensor per
    ``yolo`` layer, in layer order. Raises ValueError on a layer it does
    not implement (:func:`check_layer`)."""

    def __init__(self, cfg: dict, weights: Dict[str, dict], device):
        self.layers: List[dict] = cfg["layers"]
        for i, l in enumerate(self.layers):
            check_layer(i, l)
        self.classes = int(cfg["classes"])
        self.eps = float(cfg["bn_epsilon"])
        self.device = torch.device(device)
        self.convs = []
        ci = 0
        for l in self.layers:
            if l["type"] != "convolutional":
                continue
            p = weights[f"conv{ci}"]
            w = torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
            entry = {"w": w.to(self.device)}
            if l.get("batch_normalize"):
                entry["bn"] = {k: torch.from_numpy(
                    np.asarray(v, np.float32)).to(self.device)
                    for k, v in p["bn"].items()}
            else:
                entry["b"] = torch.from_numpy(
                    np.asarray(p["b"], np.float32)).to(self.device)
            self.convs.append(entry)
            ci += 1

    @torch.no_grad()
    def __call__(self, frames_u8: torch.Tensor,
                 batch_stats: Optional[List] = None) -> List[torch.Tensor]:
        """``batch_stats``, when given a list, makes every batch norm use
        the batch's own per-channel mean and variance (as in training)
        and receives them, one (mean, var) per batch-norm conv."""
        x = frames_u8.to(self.device, torch.float32).permute(0, 3, 1, 2)
        x = x / 255.0
        outs: List[torch.Tensor] = []
        heads: List[torch.Tensor] = []
        ci = 0
        for i, l in enumerate(self.layers):
            t = l["type"]
            if t == "convolutional":
                p = self.convs[ci]
                ci += 1
                k = int(l["size"])
                x = F.conv2d(x, p["w"], stride=int(l["stride"]),
                             padding=(k - 1) // 2 if l.get("pad") else 0)
                if "bn" in p:
                    bn = p["bn"]
                    mean, var = bn["mean"], bn["var"]
                    if batch_stats is not None:
                        mean = x.mean(dim=(0, 2, 3))
                        var = x.var(dim=(0, 2, 3), unbiased=False)
                        batch_stats.append((mean, var))
                    x = ((x - mean[None, :, None, None])
                         / torch.sqrt(var + self.eps)[None, :, None, None]
                         * bn["gamma"][None, :, None, None]
                         + bn["beta"][None, :, None, None])
                else:
                    x = x + p["b"][None, :, None, None]
                if l["activation"] == "leaky":
                    x = F.leaky_relu(x, 0.1)
                elif l["activation"] == "mish":
                    x = x * torch.tanh(F.softplus(x))
            elif t == "maxpool":
                s, k = int(l["stride"]), int(l["size"])
                lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
                x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
                x = F.max_pool2d(x, k, s)
            elif t == "upsample":
                s = int(l["stride"])
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            elif t == "route":
                idx = [j if j >= 0 else i + j for j in l["layers"]]
                g, gid = int(l.get("groups", 1)), int(l.get("group_id", 0))
                parts = []
                for j in idx:
                    c = outs[j].shape[1] // g
                    parts.append(outs[j][:, gid * c:(gid + 1) * c])
                x = torch.cat(parts, dim=1)
            elif t == "shortcut":
                x = x + outs[i + int(l["from"])]
            elif t == "yolo":
                b, c, h, w = x.shape
                na = len(l["mask"])
                heads.append(x.reshape(b, na, c // na, h, w)
                             .permute(0, 3, 4, 1, 2).contiguous())
            else:
                raise ValueError(f"layer {i}: unknown type {t!r}")
            outs.append(x)
        return heads
