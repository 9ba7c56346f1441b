"""CUDA-graph replay of the engine's sync-free prefix, on the CPU.

The CPU cannot capture, so a stand-in capturer is injected into the
engine: it gives what ``torch.cuda.CUDAGraph`` gives (static outputs the
replay overwrites in place, the hand-written kernels' launches tallied
at capture, not counted) by running the prefix again at each replay.
The card's own checks (a replay bit-equal to the eager run in bf16, f32
and int8) are in tests/test_torch_graph_replay_gpu.py.

Held here: the keys warmup() captures, eagerly and lazily; an uncaptured
key runs eagerly; ``engine.graph_replay`` counts replayed parts and only
those; a replay gives the eager records, also for two parts of one key
in flight at once; B1 and B2 launch counts advance per replay as they do
eagerly."""

import io
import pathlib

import numpy as np
import pytest
import torch

from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.ops import _build
from fastdet_tpu_torch.ops import plane_ingest as pi
from fastdet_tpu_torch.ops import sparse_ingest as si
from fastdet_tpu_torch.runtime.engine import DetectionEngine
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIXTURES = sorted(p.name for p in TESTDATA.glob("*.jpg"))
BUCKETS = (1, 2)
LAYOUTS = ((2, 2), (2, 1))   # FASTDET_WARM_LAYOUTS' default "22,21"


class StandInCapturer:
    """The CUDA capturer's contract on the CPU. ``calls`` lists each
    capture's pool key."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn, inputs, device, pool_key):
        self.calls.append(pool_key)
        with _build.capturing() as tally:
            outputs = tuple(t.clone() for t in fn(*inputs))

        def replay():
            # a graph's replay runs no Python: its launches are counted
            # by the engine from the tally
            with _build.capturing():
                fresh = fn(*inputs)
            for s, t in zip(outputs, fresh):
                s.copy_(t)

        return outputs, replay, tally


def _expected_keys():
    keys = set()
    for b in BUCKETS:
        keys.add(("pixels", b))
        for layout in LAYOUTS:
            keys.update({("sparse", layout, "std", b),
                         ("sparse", layout, "dense", b),
                         ("planes", layout, b)})
    return keys


@pytest.fixture(scope="module")
def model():
    return weights.load_model("synthetic:tiny", num_classes=80)


def _engine(model, capturer=None):
    eng = DetectionEngine(*model, mode="f32", buckets=BUCKETS, device="cpu")
    eng._capturer = capturer
    return eng


def _warmed(model, lazy: str):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FASTDET_LAZY_WARM", lazy)
        mp.delenv("FASTDET_WARM_LAYOUTS", raising=False)
        eng = _engine(model, StandInCapturer())
        eng.warmup()
        eng.wait_warm()
    return eng


@pytest.fixture(scope="module")
def engines(model, native_ready):
    """A lazily warmed engine with the stand-in capturer and a plain one
    that never warmed (every part eager)."""
    graphed, plain = _warmed(model, "1"), _engine(model)
    yield graphed, plain
    graphed.close()
    plain.close()


def _jpegs(names):
    return [(TESTDATA / n).read_bytes() for n in names]


def _wire(eng, datas, thr=0.3):
    eng._tier_hint.clear()
    res = eng.detect_async_sparse(datas, [thr] * len(datas))
    return res, eng.fetch_wire(res, len(datas))


def _jpeg_444():
    from PIL import Image

    img = Image.open(TESTDATA / "scene1.jpg").convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90, subsampling=0)
    return buf.getvalue()


@pytest.mark.parametrize("lazy", ["0", "1"])
def test_warmup_captures_every_warmed_key(model, native_ready, lazy):
    """Eagerly (FASTDET_LAZY_WARM=0) and lazily, warmup() captures one
    graph per program it warms, on the shard's pool, in the program's
    warm-up job."""
    eng = _warmed(model, lazy)
    try:
        keys = set(eng._graphs[0])
        assert keys == _expected_keys()
        assert {str(k) for k in keys} == set(eng.warm_attribution)
        assert eng._capturer.calls == [0] * len(keys)
    finally:
        eng.close()


def test_fallbacks_false_captures_only_what_it_warms(model, native_ready):
    eng = _engine(model, StandInCapturer())
    try:
        eng.warmup(fallbacks=False)
        eng.wait_warm()
        assert set(eng._graphs[0]) == {("pixels", b) for b in BUCKETS} | {
            ("sparse", layout, "std", b) for layout in LAYOUTS
            for b in BUCKETS}
    finally:
        eng.close()


@pytest.mark.parametrize("route", ["never warmed", "coeffs", "layout 444"])
def test_uncaptured_key_runs_eagerly(engines, route):
    """A program that was never captured (an engine that never warmed,
    the coefficient route, a layout outside FASTDET_WARM_LAYOUTS) runs
    eagerly: no replay, the plain engine's records."""
    graphed, plain = engines
    datas = (_jpeg_444(),) if route == "layout 444" else _jpegs(
        ["scene1.jpg", "scene2.jpg"])
    eng = plain if route == "never warmed" else graphed
    STAGES.reset()
    if route == "coeffs":
        got = eng.fetch_wire(eng.detect_async_jpeg(datas, [0.3] * 2), 2)
        want = plain.fetch_wire(plain.detect_async_jpeg(datas, [0.3] * 2),
                                2)
    else:
        _, got = _wire(eng, list(datas))
        _, want = _wire(plain, list(datas))
    snap = STAGES.snapshot()
    assert got == want
    assert snap["engine.xfer_run"]["count"] > 0
    assert "engine.graph_replay" not in snap
    if route == "layout 444":
        assert ("sparse", (1, 1), "std", 1) not in graphed._graphs[0]


def test_graph_replay_span_once_per_replayed_part(engines):
    """Every part on a captured key records one ``engine.graph_replay``
    (same batch and part as its ``engine.xfer_run``, inside it); an
    eager part records none."""
    graphed, _ = engines
    STAGES.reset()
    for i in range(0, len(FIXTURES), 2):
        _wire(graphed, _jpegs(FIXTURES[i:i + 2]))
    snap = STAGES.snapshot()
    runs = [e for e in snap["events"] if e["name"] == "engine.xfer_run"]
    replays = [e for e in snap["events"]
               if e["name"] == "engine.graph_replay"]
    assert len(runs) >= len(FIXTURES) // 2
    assert snap["engine.graph_replay"]["count"] == len(replays) == len(runs)
    by_part = {(e["bid"], e["part"], e["start_us"]): e for e in runs}
    for e in replays:
        run = by_part[(e["bid"], e["part"], e["start_us"])]
        assert e["end_us"] <= run["end_us"]
    datas = _jpegs(["scene1.jpg", "scene2.jpg"])
    graphed.fetch_wire(graphed.detect_async_jpeg(datas, [0.3] * 2), 2)
    snap2 = STAGES.snapshot()
    assert snap2["engine.xfer_run"]["count"] == len(runs) + 1
    assert snap2["engine.graph_replay"]["count"] == len(replays)


def test_replay_gives_eager_records(engines):
    """Each pair of fixtures, through the captured programs and through
    the plain engine: the same wire records; and two parts of one key in
    flight at once (both dispatched before either is fetched) each keep
    their own records."""
    graphed, plain = engines
    for i in range(0, len(FIXTURES), 2):
        datas = _jpegs(FIXTURES[i:i + 2])
        res, got = _wire(graphed, datas)
        assert got == _wire(plain, datas)[1], FIXTURES[i:i + 2]
    a, b = _jpegs(["scene1.jpg"]), _jpegs(["scene2.jpg"])
    graphed._tier_hint.clear()
    ra = graphed.detect_async_sparse(a, [0.3])
    rb = graphed.detect_async_sparse(b, [0.3])
    assert ra.tags == rb.tags == ("sparse:22",)
    got_b, got_a = graphed.fetch_wire(rb, 1), graphed.fetch_wire(ra, 1)
    assert got_a == _wire(plain, a)[1] and got_b == _wire(plain, b)[1]
    assert got_a != got_b


def _counting(plain, add):
    """A CPU kernel stand-in that counts its launches as the card's
    kernels do."""
    def launch(*args, **kw):
        if not _build.captured(add):
            add(1)
        return plain(*args, **kw)
    return launch


def test_launch_counts_advance_per_replay_as_eagerly(model, native_ready,
                                                     monkeypatch):
    """B1 and B2 launch counts: the capture adds nothing beyond the warm
    runs, and each replayed part adds what its eager run adds."""
    monkeypatch.setattr(si, "reconstruct",
                        _counting(si.reconstruct_plain, si.add_launches))
    monkeypatch.setattr(pi, "plane_ingest_batch",
                        _counting(pi.plane_ingest_plain, pi.add_launches))
    monkeypatch.setenv("FASTDET_LAZY_WARM", "0")
    monkeypatch.delenv("FASTDET_WARM_LAYOUTS", raising=False)
    graphed, plain = _engine(model, StandInCapturer()), _engine(model)
    try:
        warm = []
        for eng in (graphed, plain):
            before = (si.LAUNCHES, pi.LAUNCHES)
            eng.warmup()
            warm.append((si.LAUNCHES - before[0], pi.LAUNCHES - before[1]))
        assert warm[0] == warm[1] and warm[0][0] > 0 and warm[0][1] > 0
        tally = {}
        for g in graphed._graphs[0].values():
            for add, n in g.launches.items():
                tally[add] = tally.get(add, 0) + n
        assert tally == {si.add_launches: 2 * 2 * len(BUCKETS),
                         pi.add_launches: len(BUCKETS)}
        for names in (FIXTURES[:2], FIXTURES[2:4], FIXTURES[4:6]):
            counts = []
            for eng in (graphed, plain):
                before = (si.LAUNCHES, pi.LAUNCHES)
                res, _ = _wire(eng, _jpegs(names))
                counts.append((si.LAUNCHES - before[0],
                               pi.LAUNCHES - before[1], res.tags))
            assert counts[0] == counts[1] and sum(counts[0][:2]) > 0, names
        planes = [[(TESTDATA / "scene3.jpg").read_bytes()]]
        for eng in (graphed, plain):
            before = pi.LAUNCHES
            eng.fetch_wire(eng.detect_async_planes(planes[0], [0.3]), 1)
            assert pi.LAUNCHES == before + 1
    finally:
        graphed.close()
        plain.close()


def test_replayed_outputs_stay_inside_the_worker(engines):
    """What fetch reads is the tail's own: no tensor of a part's result
    shares storage with a graph's static outputs."""
    graphed, _ = engines
    graphed._tier_hint.clear()
    res = graphed.detect_async_sparse(_jpegs(["scene2.jpg"]), [0.3])
    packed, wire = res.parts[0][0].result()
    owned = {t.untyped_storage().data_ptr()
             for g in graphed._graphs[0].values() for t in g.outputs}
    assert packed.untyped_storage().data_ptr() not in owned
    assert wire.untyped_storage().data_ptr() not in owned
    assert isinstance(packed, torch.Tensor) and packed.shape[-1] == 7
    assert np.asarray(wire).dtype == np.uint8
