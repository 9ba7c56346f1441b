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
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch

from fastdet_tpu_torch.models import weights as weights_io
from fastdet_tpu_torch.models.yolov3 import ModelSpec
from fastdet_tpu_torch.parallel.train import TrainState

logger = logging.getLogger(__name__)


def save(path: str, state: TrainState) -> None:
    """Write ``state`` to the file ``path`` (atomically: a temporary name,
    then a rename)."""
    tmp = path + ".tmp"
    torch.save({"net": state.net.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def restore(path: str, template: TrainState) -> TrainState:
    """Load a :func:`save` file into ``template`` (a freshly initialized
    state of the same spec supplies the structure and the device) and
    return it. The file is read to host memory: loading copies the net's
    tensors to their device, and the optimizer places its moments beside
    their parameters and keeps AdamW's step counts on the host, where a
    fresh optimizer keeps them."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    template.net.load_state_dict(blob["net"])
    template.optimizer.load_state_dict(blob["optimizer"])
    template.step = int(blob["step"])
    return template


def export_inference(path: str, spec: ModelSpec, state: TrainState) -> None:
    """Write trained parameters as a servable fastdet .npz."""
    weights_io.save_npz(path, spec, state.net.to_params())


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
