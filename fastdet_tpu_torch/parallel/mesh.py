"""Device mesh and sharding layout of the port: ('dp', 'tp').

The counterpart of the JAX package's ``fastdet_tpu/parallel/mesh.py``:

- **dp**, data parallel: a batch is split over the dp ranks in equal
  shards of rows (:func:`shard_rows`); the serving engine and
  ``dp_buckets`` use this axis only, as the JAX engine does.
- **tp**, tensor (channel) parallel, training only: the output channels
  of every conv with at least ``TP_MIN_CHANNELS`` filters are split over
  the tp ranks (:func:`param_shardings`, :func:`shard_params`); the
  tensor-parallel conv block of models/layers.py inserts the collectives
  that GSPMD inserts for the JAX step. Every other layer is replicated.

:func:`make_mesh` lays the devices out row-major over (dp, tp), tp the
inner axis, with the JAX default: tp = 2 on an even count above 1 unless
dp or tp is pinned. A training process is one rank of that mesh; its
process groups come from :func:`process_groups`.

A device list may name a device more than once: each entry is one
shard. Tests pass ``[torch.device("cpu")] * 8``, the counterpart of the
JAX tests' eight virtual CPU devices, and a one-card machine can run two
shards on ``cuda:0``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.models.layers import TensorParallel

TP_MIN_CHANNELS = 256


class Mesh(NamedTuple):
    """A ('dp', 'tp') mesh: ``devices[d * tp + t]`` is rank (d, t)."""

    devices: Tuple[torch.device, ...]
    tp: int = 1

    @property
    def dp(self) -> int:
        return len(self.devices) // self.tp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


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


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> Mesh:
    """A ('dp', 'tp') mesh over the given (or every visible) device, by
    the JAX rule: with neither degree given tp = 2 on an even count above
    1, else 1; a pinned dp takes tp = n // dp; dp * tp must be n."""
    devs = make_devices(devices)
    n = len(devs)
    if tp is None:
        if dp is not None:
            tp = n // dp if dp > 0 else 0
        else:
            tp = 2 if (n % 2 == 0 and n > 1) else 1
    if dp is None:
        dp = n // tp if tp > 0 else 0
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    return Mesh(tuple(devs), tp)


def param_shardings(spec, tp: int) -> Dict[str, bool]:
    """{conv name: channel-sharded over 'tp'} for every conv of ``spec``:
    the convs with at least ``TP_MIN_CHANNELS`` filters that split evenly
    over ``tp`` (the JAX ``param_shardings``: their kernel, bias and BN
    leaves shard with the output channels, whole at tp = 1; everything
    else replicated)."""
    return {l.name: l.filters >= TP_MIN_CHANNELS and l.filters % tp == 0
            for l in spec.conv_specs()}


def channel_slice(channels: int, tp: int, rank: int) -> slice:
    """Tp rank ``rank``'s output channels of a sharded conv."""
    per = channels // tp
    return slice(rank * per, (rank + 1) * per)


def shard_params(spec, mesh: Mesh, params: Dict[str, Any],
                 tp_rank: int) -> Dict[str, Any]:
    """Tp rank ``tp_rank``'s slice of a numpy parameter tree (unfolded
    {"w" HWIO, "bn": {...}} or folded {"w", "b"}): the sharded convs' w,
    b and BN leaves cut along the output channels, the rest as given."""
    sharded = param_shardings(spec, mesh.tp)
    out: Dict[str, Any] = {}
    for name, p in params.items():
        if not sharded.get(name):
            out[name] = p
            continue
        cut = channel_slice(np.shape(p["w"])[-1], mesh.tp, tp_rank)
        entry = {"w": np.asarray(p["w"])[..., cut]}
        if "b" in p:
            entry["b"] = np.asarray(p["b"])[cut]
        if "bn" in p:
            entry["bn"] = {k: np.asarray(v)[cut] for k, v in p["bn"].items()}
        out[name] = entry
    return out


class MeshGroups(NamedTuple):
    """One rank's tp index in a mesh and its process groups: ``dp_group``
    joins the ranks of its tp index (None: the default group, when tp is
    1), ``tp_group`` those of its dp index (None when tp is 1)."""

    mesh: Mesh
    tp_rank: int
    dp_group: Any
    tp_group: Any

    def tensor_parallel(self, spec) -> Optional[TensorParallel]:
        """A net of ``spec``'s tp layout on this rank: the tp group and
        the convs :func:`param_shardings` shards (None at tp = 1)."""
        if self.mesh.tp == 1:
            return None
        return TensorParallel(
            self.tp_group, self.mesh.tp, self.tp_rank,
            frozenset(n for n, s in param_shardings(spec, self.mesh.tp)
                      .items() if s))


def process_groups(mesh: Mesh) -> MeshGroups:
    """This rank's :class:`MeshGroups` under the initialized default
    group, whose size must be the mesh's: rank r is (r // tp, r % tp).
    Every rank must call it (each group is made by all ranks in one
    order)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if world != len(mesh.devices):
        raise ValueError(f"a mesh of {len(mesh.devices)} ranks under a "
                         f"process group of {world}")
    d, t = divmod(rank, mesh.tp)
    if mesh.tp == 1:
        return MeshGroups(mesh, 0, None, None)
    dp_group = tp_group = None
    for tt in range(mesh.tp):
        g = dist.new_group([dd * mesh.tp + tt for dd in range(mesh.dp)])
        if tt == t:
            dp_group = g
    for dd in range(mesh.dp):
        g = dist.new_group([dd * mesh.tp + tt for tt in range(mesh.tp)])
        if dd == d:
            tp_group = g
    return MeshGroups(mesh, t, dp_group, tp_group)


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
