"""Lazy warm-up of the port's engine, against the JAX engine's.

The counterpart of tests/test_lazy_warmup.py on ``synthetic:tiny`` with
the same tight std budgets: while a fallback program still warms on the
background thread, the routers treat its path as unavailable, and an
over-budget frame rides the next ready path (planes, then the host pixel
path) instead of waiting. The gates are driven through the engine's
pending set, as the JAX tests drive them, so the routing is
deterministic. Routing (counts, tags, unresolved frames) must equal the
JAX engine's under the same pending set; each route's results must
equal that route's own single-frame dispatch exactly.
"""

import io
import pathlib

import numpy as np
import pytest

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.runtime.engine import DetectionEngine as JaxEngine
from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.runtime.engine import DetectionEngine

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
TIGHT_STD = (5.0, 5.0, 0.25, 0.03, 0.3, 0.04)


def _flat_jpeg():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((416, 416, 3), 96, np.uint8)).save(
        buf, format="JPEG", quality=90, subsampling=2)
    return buf.getvalue()


def _scene(idx=2):
    from PIL import Image

    p = TESTDATA / f"scene{1 + idx % 3}.jpg"
    img = Image.open(io.BytesIO(p.read_bytes())).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90, subsampling=2)
    return buf.getvalue()


def _tight(eng):
    eng._sparse_budgets = dict(eng._sparse_budgets, std=TIGHT_STD)
    return eng


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's tight engines (f32, buckets
    (1, 2)); tests set the pending sets themselves."""
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = _tight(DetectionEngine(spec, params, mode="f32", buckets=(1, 2),
                                 device="cpu"))
    jspec, jparams = jax_weights.load_model("synthetic:tiny", num_classes=80)
    jeng = _tight(JaxEngine(jspec, jparams, mode="f32", buckets=(1, 2)))
    yield eng, jeng
    eng.close()


def _route(eng, jeng, pending, frames):
    """Dispatch ``frames`` through both engines under ``pending``; the
    routing must agree. Returns the port's dispatch and results."""
    out = []
    for e in (eng, jeng):
        e._tier_hint.clear()
        e._lazy_pending = set(pending)
        res = e.detect_async_sparse(frames, [0.5] * len(frames))
        assert res is not None
        out.append((res, e.fetch(res, len(frames))))
        e._lazy_pending = set()
    (res, got), (jres, _) = out
    assert res.counts == jres.counts
    assert res.tags == jres.tags
    assert tuple(res.unresolved) == tuple(jres.unresolved)
    return res, got


def _dense_keys(eng):
    return {("sparse", (2, 2), "dense", b) for b in eng.buckets}


def _planes_keys(eng):
    return {("planes", (2, 2), b) for b in eng.buckets}


def test_pending_dense_routes_overflow_to_planes(engines, native_ready):
    """Dense-tier program still warming: the over-budget frame rides
    planes; its std group-mate keeps the sparse wire. Once the warm
    lands (pending cleared), the dense tier serves."""
    eng, jeng = engines
    flat, dense = _flat_jpeg(), _scene(2)
    res, got = _route(eng, jeng, _dense_keys(eng), [dense, flat])
    assert res.counts == {"sparse": 1, "planes": 1}, res.counts
    assert tuple(res.unresolved) == ()

    res2, got2 = _route(eng, jeng, set(), [dense, flat])
    assert res2.counts == {"sparse": 1, "sparse_dense": 1}, res2.counts
    assert got[1] == got2[1]
    ref_planes = eng.fetch(eng.detect_async_planes([dense], [0.5]), 1)[0]
    assert got[0] == ref_planes
    eng._tier_hint.clear()
    ref_dense = eng.fetch(eng.detect_async_sparse([dense], [0.5]), 1)[0]
    eng._tier_hint.clear()
    assert got2[0] == ref_dense


def test_pending_planes_routes_to_unresolved(engines, native_ready):
    """Both fallbacks still warming: the over-budget frame is reported
    unresolved (host pixel path) and the std dispatch is kept."""
    eng, jeng = engines
    flat, dense = _flat_jpeg(), _scene(2)
    res, got = _route(eng, jeng, _dense_keys(eng) | _planes_keys(eng),
                      [dense, flat])
    assert res.counts == {"sparse": 1}, res.counts
    assert tuple(res.unresolved) == (0,)
    assert got[0] == []
    eng._tier_hint.clear()
    ref = eng.fetch(eng.detect_async_sparse([flat, flat], [0.5, 0.5]), 2)
    assert got[1] == ref[0]   # at bucket 2, as it was served
    # the planes gate alone: detect_async_planes reports the frames
    eng._lazy_pending = _planes_keys(eng)
    try:
        assert eng.detect_async_planes([dense], [0.5]) is None
    finally:
        eng._lazy_pending = set()


def _fresh(buckets=(1,)):
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    return DetectionEngine(spec, params, mode="f32", buckets=buckets,
                           device="cpu")


def test_warmup_lazy_background_completes(native_ready, monkeypatch):
    """Real warmup() with lazy on: it returns after the first-choice
    programs, the background thread exists, and wait_warm() drains the
    pending set; the fallback paths then serve."""
    monkeypatch.setenv("FASTDET_LAZY_WARM", "1")
    eng = _fresh((1, 2))
    try:
        eng.warmup()
        assert eng._lazy_thread is not None
        assert eng._lazy_thread.daemon
        eng.wait_warm(timeout=120)
        assert not eng._lazy_thread.is_alive()
        assert eng._lazy_pending == set()
        assert eng.background_warm_s is not None
        # every program of both sets warmed once
        assert len(eng.warm_attribution) == 2 + 2 * (2 + 2 + 2)
        eng._tier_hint.clear()
        res = eng.detect_async_planes([_scene(0)], [0.5])
        assert res is not None and res.unresolved == ()
        eng.fetch(res, 1)
    finally:
        eng.close()
    assert not eng._lazy_thread.is_alive()


def test_warmup_eager_when_disabled(native_ready, monkeypatch):
    """FASTDET_LAZY_WARM=0 runs every program before warmup returns and
    starts no thread."""
    monkeypatch.setenv("FASTDET_LAZY_WARM", "0")
    eng = _fresh()
    try:
        eng.warmup()
        assert eng._lazy_thread is None
        assert eng._lazy_pending == set()
        assert eng.background_warm_s is None
        assert len(eng.warm_attribution) == 7
    finally:
        eng.close()


def test_warmup_without_fallbacks(native_ready, monkeypatch):
    """fallbacks=False (the one-shot CLIs): only the first-choice
    programs warm, no thread starts, nothing is pending, and the
    fallbacks still serve cold on first use."""
    monkeypatch.setenv("FASTDET_LAZY_WARM", "1")
    eng = _tight(_fresh())
    try:
        eng.warmup((1,), fallbacks=False)
        assert eng._lazy_thread is None and eng._lazy_pending == set()
        assert set(eng.warm_attribution) == {
            str(("pixels", 1)), str(("sparse", (2, 2), "std", 1)),
            str(("sparse", (2, 1), "std", 1))}
        eng._tier_hint.clear()
        res = eng.detect_async_sparse([_scene(2)], [0.5])
        assert res.counts == {"sparse_dense": 1}
        eng.fetch(res, 1)
    finally:
        eng.close()


@pytest.mark.parametrize("fallbacks", [True, False])
def test_warm_attribution_keys_match_jax(native_ready, monkeypatch,
                                         fallbacks):
    """The programs warmed, keyed by str(tag), are the JAX engine's (one
    warm layout keeps the JAX side's compiles few)."""
    monkeypatch.setenv("FASTDET_LAZY_WARM", "0")
    monkeypatch.setenv("FASTDET_WARM_LAYOUTS", "22")
    eng = _fresh()
    jspec, jparams = jax_weights.load_model("synthetic:tiny", num_classes=80)
    jeng = JaxEngine(jspec, jparams, mode="f32", buckets=(1,))
    try:
        eng.warmup(fallbacks=fallbacks)
        jeng.warmup(fallbacks=fallbacks)
        assert set(eng.warm_attribution) == set(jeng.warm_attribution)
        assert len(eng.warm_attribution) == (4 if fallbacks else 2)
    finally:
        eng.close()
