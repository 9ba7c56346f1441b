"""Checkpoint import for serving: a .npz cache for darknet conversions.

The port's counterpart of ``cached_import`` in the JAX package's
``fastdet_tpu/parallel/checkpoint.py``. The server loads every registry
path through it, so a darknet ``model.weights`` is converted once and
later start-ups read ``model.weights.npz`` beside it.

That module's ``save``, ``restore`` and ``export_inference`` persist the
training state; they come with the port of training.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

from fastdet_tpu_torch.models import weights as weights_io
from fastdet_tpu_torch.models.yolov3 import ModelSpec

logger = logging.getLogger(__name__)


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
