"""Device selection and numeric precision for the port.

Every entry point takes an explicit ``device``; the default is the CUDA
card. There is no fallback: asking for the card on a machine without
one raises.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device for an entry point's ``device`` argument.

    Raises RuntimeError for a CUDA device when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fastdet_tpu_torch: a CUDA device was requested (the default) "
            "but torch.cuda.is_available() is False; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def strict_fp32() -> None:
    """Run float32 convolutions and matmuls in true float32.

    cuDNN convolutions default to TF32 on Ampere and later, which keeps
    ~10 mantissa bits: the IDCT matmul and the f32 model path would then
    shift pixels by whole levels and move boxes — the card's analogue of
    the TPU's default-precision matmul that truncated f32 integers past
    256 (docs/ROUND10.md §1)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
