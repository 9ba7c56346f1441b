"""Checkpoint / resume for training state, and weight export and import.

The port of the JAX package's ``fastdet_tpu/parallel/checkpoint.py``:

- :func:`save` / :func:`restore` persist a full TrainState (parameters,
  BN running statistics, optimizer state and step) so training is
  resumable. The JAX package writes an orbax directory; the port writes
  one ``torch.save`` file, under a temporary name renamed into place, so
  a process killed mid-save never leaves a truncated checkpoint;
- :func:`export_inference` writes the trained parameters, unfolded, as a
  fastdet .npz that both packages' ``weights.load_model`` serve;
- :func:`cached_import`: the server loads every registry path through
  it, so a darknet ``model.weights`` is converted once and later
  start-ups read ``model.weights.npz`` beside it.

A state of a ('dp', 'tp') mesh holds shards of the wide convs: ``save``
and ``export_inference`` gather them over the tp group into the full
tree (every rank calls them; global rank 0 writes), so the files are
those of a one-device run, and ``restore`` cuts a full file back to its
template's shards.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch

from fastdet_tpu_torch.models import weights as weights_io
from fastdet_tpu_torch.models.yolov3 import ModelSpec
from fastdet_tpu_torch.parallel import mesh as mesh_lib
from fastdet_tpu_torch.parallel.train import TrainState

logger = logging.getLogger(__name__)


def _writer() -> bool:
    """Whether this process writes: global rank 0, or no process group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _conv_of_slot(state: TrainState) -> Dict[int, str]:
    """{optimizer state_dict index: conv name} (the net's parameters are
    named "convs.<conv>.<leaf>")."""
    conv = {id(p): n.split(".")[1] for n, p in state.net.named_parameters()}
    opt = state.optimizer
    return {idx: conv[id(p)]
            for gsd, g in zip(opt.state_dict()["param_groups"],
                              opt.param_groups)
            for idx, p in zip(gsd["params"], g["params"])}


def _map_state(state: TrainState, net: Dict, opt: Dict, fn
               ) -> Tuple[Dict, Dict]:
    """(net state_dict, optimizer state_dict) of ``state``'s structure
    with ``fn(conv, tensor)`` applied to every per-channel tensor:
    parameters, BN buffers and Adam moments (their step counts pass
    through)."""
    conv = _conv_of_slot(state)
    return ({k: fn(k.split(".")[1], v) for k, v in net.items()},
            {"param_groups": opt["param_groups"],
             "state": {i: {k: (fn(conv[i], v) if k != "step" else v)
                           for k, v in st.items()}
                       for i, st in opt["state"].items()}})


def save(path: str, state: TrainState) -> None:
    """Write ``state`` to the file ``path`` (atomically: a temporary name,
    then a rename), over every channel of a tp-sharded state."""
    net, opt = state.net.state_dict(), state.optimizer.state_dict()
    if state.net.tp is not None:
        net, opt = _map_state(state, net, opt, state.net.full)
    if not _writer():
        return
    tmp = path + ".tmp"
    torch.save({"net": net, "optimizer": opt, "step": state.step}, tmp)
    os.replace(tmp, path)


def restore(path: str, template: TrainState) -> TrainState:
    """Load a :func:`save` file into ``template`` (a freshly initialized
    state of the same spec supplies the structure, the device and, under
    a tp mesh, the shards to cut) and return it. The file is read to host
    memory: loading copies the net's tensors to their device, and the
    optimizer places its moments beside their parameters and keeps
    AdamW's step counts on the host, where a fresh optimizer keeps them."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    net, opt = blob["net"], blob["optimizer"]
    tp = template.net.tp
    if tp is not None:
        def cut(conv, t):
            if not template.net.tp_of(conv):
                return t
            return t[mesh_lib.channel_slice(t.shape[0], tp.size,
                                            tp.rank)].clone()

        net, opt = _map_state(template, net, opt, cut)
    template.net.load_state_dict(net)
    template.optimizer.load_state_dict(opt)
    template.step = int(blob["step"])
    return template


def export_inference(path: str, spec: ModelSpec, state: TrainState) -> None:
    """Write trained parameters as a servable fastdet .npz (a tp-sharded
    state's gathered to the full tree)."""
    params = state.net.to_params()
    if _writer():
        weights_io.save_npz(path, spec, params)


def cached_import(
    path: str, arch: Optional[str] = None, num_classes: int = 80
) -> Tuple[ModelSpec, Dict[str, Any]]:
    """weights.load_model with a .npz conversion cache for darknet files.

    The first load of ``model.weights`` writes ``model.weights.npz``;
    later loads take the cache while its mtime is no older than the
    source's. An unreadable cache is logged and reconverted (the rewrite
    is atomic); a location that cannot be written skips caching. Other
    paths pass straight through."""
    if not path.endswith(".weights"):
        return weights_io.load_model(path, arch=arch, num_classes=num_classes)
    cache = path + ".npz"
    if (os.path.exists(cache)
            and os.path.getmtime(cache) >= os.path.getmtime(path)):
        try:
            return weights_io.load_npz(cache)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):  # a corrupt or stale archive
            logger.warning("conversion cache %s unreadable; reconverting",
                           cache)
    spec, params = weights_io.load_model(path, arch=arch,
                                         num_classes=num_classes)
    try:
        weights_io.save_npz(cache, spec, params)
    except OSError:
        pass  # read-only location: skip caching
    return spec, params
