"""The system under test, as the benchmark drives it.

The only module of the benchmark that imports the program
(``fastdet_tpu_torch``): it builds the engine of a configuration on one
device, wraps it in the batcher (``ModelService``) and, for the stream
mixes, the protocol server (``DetectionServer``) on a thread with its
own event loop, and reads the program's counters and spans.
"""

from __future__ import annotations

import asyncio
import os
import threading
from typing import Dict, Optional

import numpy as np

#: the path the server registers the configuration's model under
PATH = "detect"


def build_engine(cfg: dict, weights: Optional[Dict[str, dict]], device,
                 root: str, mode: Optional[str] = None,
                 calibration_images: Optional[np.ndarray] = None):
    """The configuration's ``DetectionEngine`` on ``device`` alone, its
    buckets warmed (the background warm-up joined). ``weights`` are the
    benchmark's unfolded weights, or None for a checkpoint the program
    loads from the configuration's file. ``mode`` overrides the
    configuration's (the lower-precision control)."""
    import torch

    from fastdet_tpu_torch.models import yolov3
    from fastdet_tpu_torch.parallel.checkpoint import cached_import
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    w = cfg["weights"]
    if w["kind"] == "checkpoint":
        spec, params = cached_import(os.path.join(root, w["file"]),
                                     num_classes=int(cfg["classes"]))
    else:
        spec, params = yolov3.get_spec(cfg["arch"], int(cfg["classes"])), \
            weights
    if spec.name != cfg["arch"] or spec.num_classes != int(cfg["classes"]):
        raise ValueError(f"the program's model is {spec.name}:"
                         f"{spec.num_classes}, the configuration's "
                         f"{cfg['arch']}:{cfg['classes']}")
    engine = DetectionEngine(spec, params, mode=mode or cfg["mode"],
                             buckets=tuple(cfg["buckets"]),
                             devices=[torch.device(device)],
                             max_candidates=int(cfg["max_candidates"]),
                             max_det=int(cfg["max_detections"]),
                             calibration_images=calibration_images)
    engine.warmup(buckets=tuple(cfg["buckets"]))
    engine.wait_warm()
    return engine


def service(engine):
    from fastdet_tpu_torch.runtime.server import ModelService

    return ModelService(engine, name=PATH)


def counters(svc) -> dict:
    """The batcher's counters and the ingest kernels' launch counts."""
    from fastdet_tpu_torch.ops import plane_ingest, sparse_ingest

    return {"batch_hist": dict(svc.batch_hist), "frames": svc.frames,
            "batches": svc.batches, "ingest": dict(svc.ingest),
            "b1_launches": sparse_ingest.LAUNCHES,
            "b2_launches": plane_ingest.LAUNCHES}


def reset_spans() -> None:
    from fastdet_tpu_torch.utils.profiling import GLOBAL

    GLOBAL.reset()


def spans() -> dict:
    from fastdet_tpu_torch.utils.profiling import GLOBAL

    return GLOBAL.snapshot()


class Server:
    """``DetectionServer`` over one service on 127.0.0.1 (a free port),
    on a thread of its own with its own event loop."""

    def __init__(self, svc):
        from fastdet_tpu_torch.runtime.server import DetectionServer

        self.svc = svc
        self.server = DetectionServer({PATH: svc}, port=0, host="127.0.0.1")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-server",
                                        daemon=True)

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop

        async def main():
            ev = asyncio.Event()
            self._task = asyncio.ensure_future(self.server.serve(ev))
            await ev.wait()
            self._ready.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

        try:
            loop.run_until_complete(main())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            self._ready.set()
            loop.close()

    def start(self) -> int:
        self._thread.start()
        if not self._ready.wait(120) or self.server.bound_port is None:
            raise RuntimeError("the server did not start")
        return self.server.bound_port

    def call(self, fn):
        """Run ``fn()`` on the server's loop and return its result."""
        async def run():
            return fn()
        return asyncio.run_coroutine_threadsafe(run(), self._loop).result(60)

    def stop(self) -> None:
        if self._loop is not None and self._task is not None:
            task = self._task
            self._loop.call_soon_threadsafe(
                lambda: (self.server.request_shutdown(), task.cancel()))
        self._thread.join(60)
        if self._thread.is_alive():
            raise RuntimeError("the server thread did not stop")
