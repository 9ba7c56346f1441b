"""The port's data-parallel engine on the CPU, against the port's
one-device engine and the JAX package's dp engine.

The counterpart of tests/test_engine_multichip.py: a port engine over
``[torch.device("cpu")] * 8`` (eight shards, one replica each, the
JAX tests' eight virtual CPU devices) against the one-device port engine
and against the JAX engine over the ``cpu_devices`` fixture. Tolerance:
result tuples and packed device results within rtol/atol 1e-4 (the
JAX tests' own bound between their dp and one-device engines; the
shards run the same float program on fewer rows, the JAX side sums its
convolutions in XLA's order). Buckets, tier counts and the split of the
ingest kernels' plain versions are exact.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.runtime.engine import DetectionEngine as JaxEngine
from fastdet_tpu.runtime.engine import device_result as jax_device_result
from fastdet_tpu_torch.models import weights
from fastdet_tpu_torch.ops import plane_ingest
from fastdet_tpu_torch.ops import sparse_ingest as si
from fastdet_tpu_torch.parallel import mesh
from fastdet_tpu_torch.runtime.engine import DetectionEngine, device_result

CPU8 = [torch.device("cpu")] * 8


def _imgs(n, size=416):
    rng = np.random.RandomState(0)
    return [np.kron(rng.randint(0, 255, (size // 8, size // 8, 3), np.uint8),
                    np.ones((8, 8, 1), np.uint8)) for _ in range(n)]


def _small_jpegs(n, subsampling=2):
    """tests/test_engine_multichip.py's 64x64 frames (8x8 flat blocks)."""
    from PIL import Image

    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        img = np.kron(rng.randint(0, 255, (8, 8, 3), np.uint8),
                      np.ones((8, 8, 1), np.uint8))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                  subsampling=subsampling)
        out.append(buf.getvalue())
    return out


def _assert_results_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert ra[0] == rb[0]
            np.testing.assert_allclose(ra[1:], rb[1:], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny416():
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    multi = DetectionEngine(spec, params, mode="f32", buckets=(8,),
                            devices=CPU8)
    single = DetectionEngine(spec, params, mode="f32", buckets=(8,),
                             device="cpu")
    yield multi, single
    multi.close()
    single.close()


@pytest.fixture(scope="module")
def small64(cpu_devices):
    """The tiny arch at 64x64 (tests/test_engine_multichip.py's
    _small_spec): the port's dp and one-device engines and the JAX dp
    engine over the eight virtual CPU devices."""
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    spec = dataclasses.replace(spec, image_size=64)
    jspec, jparams = jax_weights.load_model("synthetic:tiny",
                                            num_classes=80)
    jspec = dataclasses.replace(jspec, image_size=64)
    multi = DetectionEngine(spec, params, mode="f32", buckets=(8,),
                            devices=CPU8)
    single = DetectionEngine(spec, params, mode="f32", buckets=(8,),
                             device="cpu")
    jmulti = JaxEngine(jspec, jparams, mode="f32", buckets=(8,),
                       devices=cpu_devices)
    yield multi, single, jmulti
    multi.close()
    single.close()


def test_dp_engine_matches_single_device(tiny416):
    multi, single = tiny416
    assert multi.n_devices == 8 and multi.devices == tuple(CPU8)
    assert single.n_devices == 1
    assert multi.buckets == (8,)
    imgs = _imgs(8)
    _assert_results_close(multi.detect(imgs, [0.5] * 8),
                          single.detect(imgs, [0.5] * 8))


def test_dp_engine_input_actually_sharded(tiny416):
    """Every shard runs its own rows through its own replica, on its own
    transfer worker."""
    import threading

    multi, _ = tiny416
    seen = []
    select = multi._select

    def spy(x, thresholds, shard=0):
        seen.append((shard, x.shape[0], threading.current_thread().name))
        return select(x, thresholds, shard)

    multi._select = spy
    try:
        multi.detect(_imgs(8), [0.5] * 8)
    finally:
        del multi._select
    assert sorted(s for s, _, _ in seen) == list(range(8))
    assert {b for _, b, _ in seen} == {1}
    assert {t.rsplit("_", 1)[0] for _, _, t in seen} == {
        f"fd-xfer{k}" for k in range(8)}
    assert {t.rsplit("_", 1)[0] for s, _, t in seen} == {
        f"fd-xfer{s}" for s, _, _ in seen}


def _replica_tensors(net):
    """{name: tensor} of a YoloNet's parameters or of an Int8Net's
    quantized weights, biases and scales."""
    if hasattr(net, "y_scale"):
        out = {}
        for field in ("w_q", "wmat", "w_scale", "bias", "x_scale",
                      "y_scale"):
            out.update({f"{field}/{k}": v
                        for k, v in getattr(net, field).items()})
        for k, (w, b) in net.float_convs.items():
            out[f"float/{k}/w"], out[f"float/{k}/b"] = w, b
        return out
    return dict(net.state_dict())


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_dp_replicas_hold_equal_parameters(mode):
    """One replica per device, parameters equal across them; int8
    calibrates once, so every replica quantizes with the same scales."""
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    calib = _imgs(2)
    eng = DetectionEngine(spec, params, mode=mode, buckets=(4,),
                          devices=[torch.device("cpu")] * 4,
                          calibration_images=np.stack(calib))
    try:
        assert len(eng.nets) == 4 and eng.net is eng.nets[0]
        tensors = [_replica_tensors(net) for net in eng.nets]
        assert len(tensors[0]) > 0
        if mode == "int8":
            assert any(k.startswith("y_scale/") for k in tensors[0])
        for t in tensors[1:]:
            assert t.keys() == tensors[0].keys()
            for k, v in t.items():
                assert torch.equal(v, tensors[0][k]), k
    finally:
        eng.close()


def test_dp_bucket_rounding(cpu_devices):
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1, 2, 4, 8, 12),
                          devices=[torch.device("cpu")] * 4)
    try:
        # all buckets become multiples of 4
        assert eng.buckets == (4, 8, 12)
        assert eng.bucket_for(1) == 4 and eng.bucket_for(9) == 12
        jspec, jparams = jax_weights.load_model("synthetic:tiny",
                                                num_classes=80)
        for buckets, n in (((1, 2, 4, 8, 12), 4), ((1, 2, 4, 8, 16), 8),
                           ((3, 5), 2)):
            jeng = JaxEngine(jspec, jparams, mode="f32", buckets=buckets,
                             devices=cpu_devices[:n])
            assert mesh.dp_buckets(buckets, n) == jeng.buckets
    finally:
        eng.close()


@pytest.mark.parametrize("route", ["pixels", "sparse", "planes"])
def test_dp_engine_matches_jax_dp_engine(small64, native_ready, route):
    """The port's 8-shard engine against its one-device engine and the
    JAX engine's 8-device mesh, per ingest route (64x64 frames)."""
    multi, single, jmulti = small64
    thrs = [0.5] * 8
    if route == "pixels":
        imgs = _imgs(8, 64)
        outs = [e.fetch(e.detect_async(imgs, thrs), 8)
                for e in (multi, single)]
        jout = jmulti.fetch(jmulti.detect_async(imgs, thrs), 8)
        packed = None
    else:
        jpegs = _small_jpegs(8)
        fn = "detect_async_sparse" if route == "sparse" else \
            "detect_async_planes"
        res = []
        for e in (multi, single, jmulti):
            e._tier_hint.clear()
            res.append(getattr(e, fn)(jpegs, thrs))
        assert all(r is not None for r in res)
        assert res[0].counts == res[1].counts == res[2].counts
        assert res[0].tags == res[2].tags
        if route == "sparse":
            assert "planes" not in res[0].counts  # no fallback
        outs = [multi.fetch(res[0], 8), single.fetch(res[1], 8)]
        jout = jmulti.fetch(res[2], 8)
        packed = [[(device_result(d).numpy(), idx) for d, idx in r.parts]
                  for r in res[:2]]
        packed.append([(np.asarray(jax_device_result(d)), idx)
                       for d, idx in res[2].parts])
    _assert_results_close(outs[0], outs[1])
    _assert_results_close(outs[0], jout)
    if packed is not None:
        for (pm, im), (ps, is_), (pj, ij) in zip(*packed):
            assert im == is_ == ij
            np.testing.assert_allclose(pm, ps, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(pm, pj, rtol=1e-4, atol=1e-5)


def test_shard_split_ingest_plain_bit_exact():
    """Kernel B1's and B2's plain versions run shard by shard over the
    dp split of a batch equal the unsplit call bit for bit: splitting
    the batch changes no coefficient and no pixel."""
    from tests.test_sparse_path import _random_v5_case

    rng = np.random.RandomState(3)
    arrs = _random_v5_case(rng, B=8, NB=16, MCAP=128, NCAPB=160, E8CAP=128,
                           E16CAP=64, DCECAP=64)
    args = [torch.from_numpy(a) for a in arrs]
    whole = si.sparse5_to_coeffs_batch(*args, yb=8, cb=4)
    for n in (2, 4, 8):
        split = torch.cat([
            si.sparse5_to_coeffs_batch(
                *[a[mesh.shard_rows(8, n, k)] for a in args], yb=8, cb=4)
            for k in range(n)])
        assert torch.equal(split, whole)

    y = torch.from_numpy(rng.randint(0, 256, (8, 32, 48), np.uint8))
    cb = torch.from_numpy(rng.randint(0, 256, (8, 16, 24), np.uint8))
    cr = torch.from_numpy(rng.randint(0, 256, (8, 16, 24), np.uint8))
    whole = plane_ingest.plane_ingest_batch(y, cb, cr)
    for n in (2, 8):
        split = torch.cat([plane_ingest.plane_ingest_batch(
            *[t[mesh.shard_rows(8, n, k)] for t in (y, cb, cr)])
            for k in range(n)])
        assert torch.equal(split, whole)
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_rows(6, 4, 0)


def test_dp_engine_sparse_ingest_matches_single_device(tiny416, native_ready):
    """The 416x416 sparse route under dp agrees with the one-device
    engine: camera-clean scenes ride the std tier on both."""
    from tests.test_sparse_path import _scene

    multi, single = tiny416
    jpegs = [_scene(i) for i in range(8)]
    thrs = [0.5] * 8
    res = []
    for e in (multi, single):
        e._tier_hint.clear()
        res.append(e.detect_async_sparse(jpegs, thrs))
    assert res[0].counts == res[1].counts == {"sparse": 8}
    _assert_results_close(multi.fetch(res[0], 8), single.fetch(res[1], 8))
    assert multi.fetch_wire(res[0], 8) == single.fetch_wire(res[1], 8)


def test_make_devices_and_mesh(monkeypatch):
    """Every visible card by default (raising without one, as the
    engine's default does), the given list otherwise; a dp degree must
    divide the device count, the rest going to 'tp'."""
    assert mesh.make_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh.make_mesh(CPU8, dp=8).dp == 8
    assert mesh.make_mesh(CPU8, dp=4).shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError, match="devices"):
        mesh.make_mesh(CPU8, dp=3)
    assert mesh.dp_buckets((1, 4, 5, 8, 9), 4) == (4, 8, 12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_devices()
    spec, params = weights.load_model("synthetic:tiny", num_classes=80)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionEngine(spec, params, mode="f32")
