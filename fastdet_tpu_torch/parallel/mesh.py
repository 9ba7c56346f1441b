"""Device list and data-parallel layout of the port.

The counterpart of the JAX package's ``fastdet_tpu/parallel/mesh.py``,
data parallel only: a batch is split over the devices in equal shards of
rows, and every device holds a whole replica of the parameters (the
model's 62M parameters fit one card many times over). The JAX module's
``tp`` axis (the wide convolutions' output channels split over devices)
is not ported; a dp-only step computes the same global step as any
('dp', 'tp') layout.

A device list may name a device more than once: each entry is one
shard. Tests pass ``[torch.device("cpu")] * 8``, the counterpart of the
JAX tests' eight virtual CPU devices, and a one-card machine can run two
shards on ``cuda:0``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from fastdet_tpu_torch import device as device_mod


class Mesh(NamedTuple):
    """A one-axis ('dp',) mesh: ``devices[k]`` runs shard k."""

    devices: Tuple[torch.device, ...]

    @property
    def dp(self) -> int:
        return len(self.devices)


def make_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """Every visible card when ``devices`` is None (as ``jax.devices()``;
    raises without one), else the given list as ``torch.device``s."""
    if devices is None:
        device_mod.resolve("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [device_mod.resolve(d) for d in devices]
    if not devs:
        raise ValueError("an empty device list")
    return devs


def make_mesh(devices: Optional[Sequence] = None,
              dp: Optional[int] = None) -> Mesh:
    """A ('dp',) mesh over the given (or every visible) device; ``dp``,
    when given, must be the device count (no 'tp' axis)."""
    devs = make_devices(devices)
    if dp is not None and dp != len(devs):
        raise ValueError(f"dp={dp} over {len(devs)} devices: the port's "
                         f"mesh is data parallel only")
    return Mesh(tuple(devs))


def dp_buckets(buckets: Sequence[int], n: int) -> Tuple[int, ...]:
    """Batch buckets rounded up to multiples of the dp degree ``n``, so
    every shard gets the same number of rows (the JAX engine's rule)."""
    return tuple(sorted({max(b, n) - (max(b, n) % -n) for b in buckets}))


def shard_rows(rows: int, n: int, k: int) -> slice:
    """Shard k's rows of a batch of ``rows`` split over ``n`` shards."""
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n} equal shards")
    per = rows // n
    return slice(k * per, (k + 1) * per)
