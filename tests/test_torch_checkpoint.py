"""The port's checkpoint import and export against the JAX package's.

Every check here is exact: both packages write the same bytes (darknet
.weights, .onnx) and read the same arrays (numpy leaves on the port's
side, numpy views of JAX arrays on the other), and the server loads a
registry path through the port's own ``cached_import``.
"""

import os
import pathlib

import numpy as np
import pytest

from fastdet_tpu.models import onnx_io as jax_onnx_io
from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu.parallel import checkpoint as jax_checkpoint
from fastdet_tpu_torch.models import onnx_io, weights, yolov3
from fastdet_tpu_torch.parallel import checkpoint
from tests.test_onnx_io import _torch_export, _torch_tiny_twin

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"


def _assert_trees_equal(got, want):
    """Unfolded param trees: same convs, same leaves, same f32 values."""
    assert list(got) == list(want)
    for name, e in want.items():
        g = got[name]
        assert sorted(g) == sorted(e), name
        for k, v in e.items():
            if isinstance(v, dict):
                assert sorted(g[k]) == sorted(v), (name, k)
                pairs = [(g[k][kk], v[kk]) for kk in v]
            else:
                pairs = [(g[k], v)]
            for a, b in pairs:
                assert isinstance(a, np.ndarray), (name, k, type(a))
                assert a.dtype == np.float32, (name, k)
                np.testing.assert_array_equal(a, np.asarray(b))


def _same_file(a, b, chunk=1 << 24):
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def _both_synthetic(arch, num_classes, seed=0):
    spec = yolov3.get_spec(arch, num_classes)
    jspec = jax_yolov3.get_spec(arch, num_classes)
    return (spec, weights.synthetic_params(spec, seed),
            jspec, jax_weights.synthetic_params(jspec, seed))


# ---------------------------------------------------------------------------
# Darknet .weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [80, 4])
def test_darknet_tiny_bytes_and_arrays_equal_jax(tmp_path, num_classes):
    spec, params, jspec, jparams = _both_synthetic("tiny", num_classes, 3)
    mine, theirs = str(tmp_path / "p.weights"), str(tmp_path / "j.weights")
    weights.save_darknet(mine, spec, params)
    jax_weights.save_darknet(theirs, jspec, jparams)
    assert _same_file(mine, theirs)
    raw = pathlib.Path(mine).read_bytes()
    got = weights.parse_darknet_bytes(raw, spec)
    _assert_trees_equal(got, jax_weights.parse_darknet_bytes(raw, jspec))
    _assert_trees_equal(got, params)
    # the arch is inferred from the file size: tiny is tried first
    spec2, params2 = weights.load_model(mine, num_classes=num_classes)
    assert (spec2.name, spec2.num_classes) == ("yolov3-tiny", num_classes)
    _assert_trees_equal(params2, params)


def test_darknet_full_and_onnx_full_equal_jax(tmp_path):
    """synthetic:full (Darknet-53, 61.9 M floats) through both writers
    and both readers; load_model infers "full" after "tiny" fails."""
    spec, params, jspec, jparams = _both_synthetic("full", 80)
    mine, theirs = str(tmp_path / "p.weights"), str(tmp_path / "j.weights")
    weights.save_darknet(mine, spec, params)
    jax_weights.save_darknet(theirs, jspec, jparams)
    assert _same_file(mine, theirs)
    os.remove(theirs)
    spec2, params2 = weights.load_model(mine)
    assert (spec2.name, spec2.num_classes) == ("yolov3", 80)
    _assert_trees_equal(params2, jax_weights.load_model(mine)[1])
    del params2
    ox, jox = str(tmp_path / "p.onnx"), str(tmp_path / "j.onnx")
    onnx_io.save_onnx(ox, spec, params)
    jax_onnx_io.save_onnx(jox, jspec, jparams)
    assert _same_file(ox, jox)
    os.remove(jox)
    del jparams
    spec3, params3 = weights.load_model(ox)
    assert (spec3.name, spec3.num_classes) == ("yolov3", 80)
    _assert_trees_equal(params3, params)


def test_darknet_old_header_has_int32_seen(tmp_path):
    """major*10+minor < 2: the seen counter is int32, not int64."""
    spec, params, jspec, _ = _both_synthetic("tiny", 4, 5)
    new = str(tmp_path / "new.weights")
    weights.save_darknet(new, spec, params)
    body = pathlib.Path(new).read_bytes()[20:]
    old = (np.array([0, 1, 0], np.int32).tobytes()
           + np.array([7], np.int32).tobytes() + body)
    got = weights.parse_darknet_bytes(old, spec)
    _assert_trees_equal(got, params)
    _assert_trees_equal(got, jax_weights.parse_darknet_bytes(old, jspec))


@pytest.mark.parametrize("cut, match", [(-4, "truncated"),
                                        (+8, "consumed")])
def test_darknet_wrong_size_raises_like_jax(tmp_path, cut, match):
    spec, params, jspec, _ = _both_synthetic("tiny", 4)
    p = tmp_path / "m.weights"
    weights.save_darknet(str(p), spec, params)
    raw = p.read_bytes()
    raw = raw[:cut] if cut < 0 else raw + b"\0" * cut
    errors = []
    for parse, s in ((weights.parse_darknet_bytes, spec),
                     (jax_weights.parse_darknet_bytes, jspec)):
        with pytest.raises(ValueError, match=match) as e:
            parse(raw, s)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    p.write_bytes(raw)
    with pytest.raises(ValueError, match="could not match"):
        weights.load_model(str(p), num_classes=4)


# ---------------------------------------------------------------------------
# ONNX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [80, 9])
def test_onnx_tiny_bytes_and_arrays_equal_jax(tmp_path, num_classes):
    spec, params, jspec, jparams = _both_synthetic("tiny", num_classes, 5)
    mine, theirs = str(tmp_path / "p.onnx"), str(tmp_path / "j.onnx")
    onnx_io.save_onnx(mine, spec, params)
    jax_onnx_io.save_onnx(theirs, jspec, jparams)
    assert _same_file(mine, theirs)
    spec2, params2 = weights.load_model(mine, num_classes=num_classes)
    jspec2, jparams2 = jax_weights.load_model(mine, num_classes=num_classes)
    assert (spec2.name, spec2.num_classes) == (jspec2.name,
                                               jspec2.num_classes)
    _assert_trees_equal(params2, jparams2)
    _assert_trees_equal(params2, params)


def test_onnx_bn_folded_export_equals_jax(tmp_path):
    """The folded dialect (no BatchNormalization nodes): both readers
    give the same exact identity-BN entries."""
    spec, params, jspec, jparams = _both_synthetic("tiny", 80, 9)
    folded = {k: {"w": v["w"], "b": v["b"]}
              for k, v in weights.fold_params(spec, params).items()}
    mine, theirs = str(tmp_path / "p.onnx"), str(tmp_path / "j.onnx")
    onnx_io.save_onnx(mine, spec, folded)
    jax_onnx_io.save_onnx(theirs, jspec, jax_yolov3.fold_params(jspec,
                                                                 jparams))
    assert _same_file(mine, theirs)
    spec2, params2 = onnx_io.load_onnx(mine, num_classes=80)
    _assert_trees_equal(params2, jax_onnx_io.load_onnx(mine,
                                                       num_classes=80)[1])
    for cs in spec2.conv_specs():
        assert ("bn" in params2[cs.name]) == cs.bn
    refolded = weights.fold_params(spec2, params2)
    for name, e in folded.items():
        np.testing.assert_array_equal(refolded[name]["w"], e["w"])
        np.testing.assert_array_equal(refolded[name]["b"], e["b"])


def test_onnx_torch_exported_dialect_equals_jax(tmp_path):
    """A torch.onnx.export file (BN folded by the exporter, Resize,
    Pad + MaxPool, Constant plumbing) reads the same on both sides."""
    p = str(tmp_path / "torch.onnx")
    _torch_export(_torch_tiny_twin(nc=4), p)
    spec, params = onnx_io.load_onnx(p)
    jspec, jparams = jax_onnx_io.load_onnx(p)
    assert (spec.name, spec.num_classes) == (jspec.name, jspec.num_classes) \
        == ("yolov3-tiny", 4)
    assert "bn" in params["conv0"] and "b" not in params["conv0"]
    _assert_trees_equal(params, jparams)


def test_onnx_bad_files_raise_like_jax(tmp_path):
    spec, params, _, _ = _both_synthetic("tiny", 9)
    p = str(tmp_path / "m.onnx")
    onnx_io.save_onnx(p, spec, params)
    for load in (weights.load_model, jax_weights.load_model):
        with pytest.raises(ValueError, match="classes"):
            load(p, num_classes=80)
    bad = str(tmp_path / "bad.onnx")
    with open(bad, "wb") as fp:
        fp.write(b"\x00\x01not a protobuf model")
    errors = []
    for load in (weights.load_model, jax_weights.load_model):
        with pytest.raises(ValueError) as e:
            load(bad, num_classes=80)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_onnx_bn_node_without_initializers_refused(tmp_path):
    """A BatchNormalization node whose parameters are not initializers
    is refused on both sides, not read as a folded conv."""
    spec, params, _, _ = _both_synthetic("tiny", 4)
    p = tmp_path / "m.onnx"
    onnx_io.save_onnx(str(p), spec, params)
    raw = p.read_bytes()
    # rename conv0's BN gamma initializer: the node's input then names
    # no initializer
    name = b"conv0.bn.gamma"
    assert raw.count(name) == 2
    i = raw.index(name, raw.index(name) + 1)
    assert raw[i - 1] == len(name)  # the initializer's name field
    p.write_bytes(raw[:i] + b"conv0.bn.gammX" + raw[i + len(name):])
    for load in (onnx_io.load_onnx, jax_onnx_io.load_onnx):
        with pytest.raises(ValueError, match="not plain initializers"):
            load(str(p))


def test_onnx_conv_order_mismatch_rejected(tmp_path):
    spec, params, _, _ = _both_synthetic("tiny", 80, 10)
    heads = [c.name for c in spec.conv_specs() if not c.bn]
    params = dict(params)
    params[heads[0]], params[heads[1]] = params[heads[1]], params[heads[0]]
    p = str(tmp_path / "swapped.onnx")
    onnx_io.save_onnx(p, spec, params)
    for load in (onnx_io.load_onnx, jax_onnx_io.load_onnx):
        with pytest.raises(ValueError, match="does not match"):
            load(p)


# ---------------------------------------------------------------------------
# .npz and cached_import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, np.float16])
def test_npz_round_trips_with_jax(tmp_path, dtype):
    spec, params, jspec, jparams = _both_synthetic("tiny", 9, 2)
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    weights.save_npz(mine, spec, params, dtype=dtype)
    jax_weights.save_npz(theirs, jspec, jparams, dtype=dtype)
    assert not os.path.exists(mine + ".tmp.npz")
    jspec2, jgot = jax_weights.load_npz(mine)
    spec2, got = weights.load_npz(theirs)
    assert (jspec2.name, jspec2.num_classes) == (spec2.name,
                                                 spec2.num_classes) \
        == ("yolov3-tiny", 9)
    _assert_trees_equal(got, jgot)
    _assert_trees_equal(weights.load_npz(mine)[1], got)
    if dtype is None:
        _assert_trees_equal(got, params)


def test_npz_reads_committed_checkpoint():
    path = str(pathlib.Path(__file__).resolve().parent.parent / "weights"
               / "detect3_tiny.npz")
    spec, got = weights.load_model(path)
    jspec, want = jax_weights.load_model(path)
    assert (spec.name, spec.num_classes) == (jspec.name, jspec.num_classes)
    _assert_trees_equal(got, want)


def test_cached_import_writes_takes_and_repairs_its_cache(tmp_path,
                                                          monkeypatch):
    spec, params, _, _ = _both_synthetic("tiny", 4)
    p = str(tmp_path / "m.weights")
    weights.save_darknet(p, spec, params)
    cache = p + ".npz"
    spec1, params1 = checkpoint.cached_import(p, arch="tiny", num_classes=4)
    assert os.path.exists(cache)
    _assert_trees_equal(params1, params)
    # the JAX package reads the port's cache, and the port the JAX one's
    _assert_trees_equal(jax_weights.load_npz(cache)[1], params)

    darknet_loads = []
    real = weights.load_darknet
    monkeypatch.setattr(weights, "load_darknet",
                        lambda *a: darknet_loads.append(a) or real(*a))
    spec2, params2 = checkpoint.cached_import(p, arch="tiny", num_classes=4)
    assert darknet_loads == [] and spec2 == spec1
    _assert_trees_equal(params2, params)

    # a corrupt cache (no older than its source) is reconverted
    with open(cache, "wb") as fp:
        fp.write(b"PK\x03\x04 not an archive")
    spec3, params3 = checkpoint.cached_import(p, arch="tiny", num_classes=4)
    assert len(darknet_loads) == 1
    _assert_trees_equal(params3, params)
    _assert_trees_equal(weights.load_npz(cache)[1], params)

    # a cache older than its source is reconverted
    os.utime(cache, (1, 1))
    checkpoint.cached_import(p, arch="tiny", num_classes=4)
    assert len(darknet_loads) == 2
    assert os.path.getmtime(cache) >= os.path.getmtime(p)

    # the JAX package's cache is taken as is
    os.remove(cache)
    jax_checkpoint.cached_import(p, arch="tiny", num_classes=4)
    checkpoint.cached_import(p, arch="tiny", num_classes=4)
    assert len(darknet_loads) == 2


def test_cached_import_skips_caching_where_it_cannot_write(tmp_path,
                                                          monkeypatch):
    spec, params, _, _ = _both_synthetic("tiny", 4)
    p = str(tmp_path / "m.weights")
    weights.save_darknet(p, spec, params)

    def read_only(path, *a, **k):
        raise PermissionError(13, "read-only file system", path)

    monkeypatch.setattr(weights, "save_npz", read_only)
    _, got = checkpoint.cached_import(p, num_classes=4)
    _assert_trees_equal(got, params)
    assert not os.path.exists(p + ".npz")
    # other forms pass straight through
    spec2, _ = checkpoint.cached_import("synthetic:tiny", num_classes=4)
    assert spec2 == spec


def test_server_builds_from_a_darknet_registry_path(tmp_path, native_ready):
    """build_services(["t:4:<x.weights>"]) converts once, caches, and
    serves the same records as the same weights from .npz."""
    from fastdet_tpu_torch.runtime.server import build_services

    spec, params, _, _ = _both_synthetic("tiny", 4, 11)
    dk = str(tmp_path / "m.weights")
    npz = str(tmp_path / "m.npz")
    weights.save_darknet(dk, spec, params)
    weights.save_npz(npz, spec, params)
    services = build_services([f"t:4:{dk}", f"n:4:{npz}"], mode="f32",
                              warmup=False, device="cpu", buckets=(1,))
    try:
        assert os.path.exists(dk + ".npz")
        assert services["t"].engine.spec == services["n"].engine.spec
        data = (TESTDATA / "scene2.jpg").read_bytes()
        wires = []
        for name in ("t", "n"):
            eng = services[name].engine
            res = eng.detect_async_sparse([data], [0.05])
            assert res.counts == {"sparse": 1}
            wires.append(eng.fetch_wire(res, 1)[0])
        assert len(wires[0]) > 0 and wires[0] == wires[1]
    finally:
        for svc in services.values():
            svc.engine.close()
