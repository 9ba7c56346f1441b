"""A Darknet layer list as a plain float32 PyTorch network.

Follows the published description (pjreddie/darknet ``cfg/yolov3.cfg``,
``cfg/yolov3-tiny.cfg``; arXiv:1804.02767): ``convolutional`` with
``pad=1`` pads (size-1)/2 on every side, batch norm in inference form
``(x - mean) / sqrt(var + eps) * gamma + beta`` before LeakyReLU(0.1);
``maxpool`` of stride 1 pads right and bottom (Darknet's window starts at
offset 0); ``upsample`` repeats each pixel; ``route`` concatenates
channels; ``shortcut`` adds; ``yolo`` marks a detection output.

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


class DarknetF32:
    """The network of ``cfg["layers"]`` over unfolded ``weights``, in
    float32 on ``device``. ``__call__`` takes (B, H, W, 3) uint8 frames
    and returns one (B, H', W', anchors, 5 + classes) float32 tensor per
    ``yolo`` layer, in layer order."""

    def __init__(self, cfg: dict, weights: Dict[str, dict], device):
        self.layers: List[dict] = cfg["layers"]
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
            elif t == "maxpool":
                s, k = int(l["stride"]), int(l["size"])
                if s == 1:
                    x = F.pad(x, (0, k - 1, 0, k - 1), value=float("-inf"))
                x = F.max_pool2d(x, k, s)
            elif t == "upsample":
                s = int(l["stride"])
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            elif t == "route":
                idx = [j if j >= 0 else i + j for j in l["layers"]]
                x = torch.cat([outs[j] for j in idx], dim=1)
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
