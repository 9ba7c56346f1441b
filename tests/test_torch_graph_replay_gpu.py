"""CUDA-graph replay of the engine's sync-free prefix on the card: a
replayed part gives the wire records and packed results of the eager run
of its program bit for bit, on the trained 80-class checkpoint in bf16,
f32 and int8, for the pixel, sparse (std and dense tiers) and planes
programs at buckets 1 and 16; two parts of one program in flight at once
keep their own records; a lazy capture on the background warm thread
while the transfer worker serves breaks neither.

Marked ``gpu``: they skip without a CUDA card. This file imports no JAX,
so on the card it runs on its own:

    python -m pytest -q -m gpu --noconftest tests/test_torch_graph_replay_gpu.py
"""

import contextlib
import functools
import os
import pathlib

import numpy as np
import pytest
import torch

from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.ops import plane_ingest as pi
from fastdet_tpu_torch.ops import sparse_ingest as si
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDATA = REPO / "testdata"
CHECKPOINT = REPO / "weights" / "detect80_full.npz"
SCENES = ("scene1.jpg", "scene2.jpg", "scene3.jpg")
BUCKETS = (1, 16)
THR = 0.3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _build(mode, lazy="0"):
    spec, params = weights.load_model(str(CHECKPOINT), num_classes=80)
    eng = DetectionEngine(spec, params, mode=mode, buckets=BUCKETS,
                          device=_card())
    with _env(FASTDET_LAZY_WARM=lazy, FASTDET_WARM_LAYOUTS="22"):
        eng.warmup()
    return eng


_ENGINES = {}


@pytest.fixture(scope="module")
def engines():
    yield _ENGINES
    for eng in _ENGINES.values():
        eng.close()
    _ENGINES.clear()


def _engine(engines, mode):
    if mode not in engines:
        engines[mode] = _build(mode)
    return engines[mode]


@contextlib.contextmanager
def _eager(eng):
    """The engine's programs with their graphs set aside."""
    graphs, eng._graphs = eng._graphs, [{} for _ in eng._graphs]
    try:
        yield
    finally:
        eng._graphs = graphs


def _frames(n, offset=0):
    return [(TESTDATA / SCENES[(i + offset) % len(SCENES)]).read_bytes()
            for i in range(n)]


def _pixels(n, offset=0):
    from fastdet_tpu_torch.runtime import jpeg

    return [jpeg.decode_rgb(d) for d in _frames(n, offset)]


def _dispatch(eng, route, n, offset=0):
    """One part of ``route``'s program for ``n`` frames: (key, result)."""
    b = eng.bucket_for(n)
    thr = [THR] * n
    if route == "pixels":
        return ("pixels", b), eng.detect_async(_pixels(n, offset), thr)
    if route == "planes":
        res = eng.detect_async_planes(_frames(n, offset), thr)
        assert res.tags == ("planes:22",)
        return ("planes", (2, 2), b), res
    tier = route.split()[1]
    staged, jobs = eng._stage_sparse(
        _frames(n, offset), np.full((n,), THR, np.float32),
        {(2, 2): list(range(n))}, tier)
    overflow, _ = eng._run_sparse_jobs(jobs)
    assert not overflow
    (layout, idxs, packed, _), = staged
    key = ("sparse", layout, tier, b)
    return key, eng._dispatch_async(
        functools.partial(eng._pipeline_sparse, layout=layout, tier=tier),
        packed, part=route, key=key)


def _results(eng, res, n):
    return eng.fetch_wire(res, n), eng.fetch(res, n)


def _replayed(eng, route, n, offset=0):
    """The route's part replayed and run eagerly: both results, after
    checking that the replay engaged and counted B1/B2 as eagerly."""
    counts = []
    out = []
    for graphs in (True, False):
        ctx = contextlib.nullcontext() if graphs else _eager(eng)
        with ctx:
            STAGES.reset()
            before = (si.LAUNCHES, pi.LAUNCHES)
            key, res = _dispatch(eng, route, n, offset)
            out.append(_results(eng, res, n))
            counts.append((si.LAUNCHES - before[0],
                           pi.LAUNCHES - before[1]))
            replays = (STAGES.snapshot().get("engine.graph_replay")
                       or {}).get("count", 0)
            assert replays == (1 if graphs else 0), (route, key)
        if graphs:
            assert key in eng._graphs[0]
    assert counts[0] == counts[1], (route, counts)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("route", ["pixels", "sparse std", "sparse dense",
                                   "planes"])
@pytest.mark.parametrize("n", BUCKETS)
def test_replay_bit_equal_to_eager(engines, mode, route, n):
    eng = _engine(engines, mode)
    (wire, tuples), (want_wire, want_tuples) = _replayed(eng, route, n)
    assert wire == want_wire
    assert tuples == want_tuples
    assert sum(len(w) for w in wire) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["sparse std", "planes"])
def test_two_parts_in_flight_keep_their_records(engines, route):
    """Two parts of one program dispatched back to back (the second
    replay queued before the first is fetched) with other frames: each
    keeps its own records, those of its eager run."""
    eng = _engine(engines, "bf16")
    n = 2
    _, first = _dispatch(eng, route, n, 0)
    _, second = _dispatch(eng, route, n, 1)
    got = [_results(eng, second, n), _results(eng, first, n)][::-1]
    with _eager(eng):
        want = [_results(eng, _dispatch(eng, route, n, o)[1], n)
                for o in (0, 1)]
    assert got == want
    assert got[0][0] != got[1][0]


@pytest.mark.gpu
def test_lazy_capture_while_serving():
    """A lazy engine serves std-tier parts (replayed graphs of the eager
    set) while the background thread warms and captures the dense tier,
    planes and the larger pixel bucket on its own stream: every part
    served meanwhile equals its eager run, and afterwards every lazy key
    is captured and replays bit-equal to its eager run."""
    eng = _build("bf16", lazy="1")
    try:
        served = []
        while eng._lazy_thread.is_alive() or len(served) < 4:
            n = BUCKETS[len(served) % 2]
            _, res = _dispatch(eng, "sparse std", n, len(served))
            served.append((n, len(served), _results(eng, res, n)))
        eng.wait_warm()
        assert not eng._lazy_pending
        assert set(eng._graphs[0]) == {
            k for b in BUCKETS for k in (
                ("pixels", b), ("sparse", (2, 2), "std", b),
                ("sparse", (2, 2), "dense", b), ("planes", (2, 2), b))}
        with _eager(eng):
            for n, offset, got in served:
                _, res = _dispatch(eng, "sparse std", n, offset)
                assert got == _results(eng, res, n)
        for route in ("pixels", "sparse dense", "planes"):
            got, want = _replayed(eng, route, BUCKETS[-1])
            assert got == want
    finally:
        eng.close()
