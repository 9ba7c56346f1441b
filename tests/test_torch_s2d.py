"""The space-to-depth stem rewrite (fastdet_tpu_torch/models/s2d.py) and
its layer against the JAX package's models/s2d.py and
layers.space_to_depth: the same channel order on the port's NCHW
channels-last tensors, the same rewritten spec and parameters bit for
bit, and an f32 forward equivalent to the canonical one (summation order
differs: the JAX package's own tolerance, tests/test_s2d.py)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fastdet_tpu.models import layers as jax_layers
from fastdet_tpu.models import s2d as jax_s2d
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu_torch.models import layers, s2d, weights, yolov3
from fastdet_tpu_torch.runtime.engine import DetectionEngine


def _spec(arch, num_classes=7, image_size=64, mod=yolov3):
    spec = mod.get_spec(arch, num_classes)
    return mod.ModelSpec(spec.name, spec.num_classes, spec.layers,
                         spec.anchors, image_size)


def _folded(spec, seed=0):
    """Folded params with random BN statistics (non-zero biases)."""
    params = weights.synthetic_params(spec, seed)
    rng = np.random.RandomState(seed + 1)
    for p in params.values():
        if "bn" in p:
            o = p["w"].shape[-1]
            p["bn"] = {
                "gamma": rng.uniform(0.5, 1.5, o).astype(np.float32),
                "beta": rng.normal(0, 0.1, o).astype(np.float32),
                "mean": rng.normal(0, 0.1, o).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, o).astype(np.float32)}
    return weights.fold_params(spec, params)


def _layer_list(spec):
    return [(type(l).__name__, dataclasses.asdict(l)) for l in spec.layers]


@pytest.mark.parametrize("dtype,pad", [(np.float32, 0), (np.float32, 20),
                                       (np.int8, 20)])
def test_space_to_depth_equals_jax(dtype, pad):
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (2, 8, 6, 3)).astype(dtype)      # NHWC
    want = np.asarray(jax_layers.space_to_depth(jnp.asarray(x), 2, pad))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = layers.space_to_depth(nchw, 2, pad)
    assert got.shape == (2, 12 + pad, 4, 3)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == nchw.dtype
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # phase-major: channel (2p + q) * C + c holds rows p::2, cols q::2
    for p in (0, 1):
        for q in (0, 1):
            np.testing.assert_array_equal(
                got[:, (2 * p + q) * 3:(2 * p + q + 1) * 3].numpy(),
                nchw[:, :, p::2, q::2].numpy())


@pytest.mark.parametrize("size", [64, 416])
def test_stem_to_s2d_equals_jax(size):
    spec = _spec("full", 80, size)
    folded = _folded(spec, seed=size)
    got_spec, got = s2d.stem_to_s2d(spec, folded)
    want_spec, want = jax_s2d.stem_to_s2d(
        _spec("full", 80, size, jax_yolov3), folded)
    assert _layer_list(got_spec) == _layer_list(want_spec)
    assert got_spec.image_size == want_spec.image_size == size
    assert isinstance(got_spec.layers[0], yolov3.SpaceToDepth)
    assert got_spec.layers[0].pad_channels == 20
    assert got.keys() == want.keys()
    for name in want:
        for k in ("w", "b"):
            g, w = np.asarray(got[name][k]), np.asarray(want[name][k])
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")


def test_stem_to_s2d_skips_tiny():
    spec = _spec("tiny")
    assert s2d.stem_to_s2d(spec, _folded(spec)) is None


def test_s2d_f32_forward_equals_canonical():
    """Same values, other summation order: heads agree to float
    tolerance (the bound of the JAX package's own test)."""
    spec = _spec("full")
    folded = _folded(spec, seed=5)
    spec2, folded2 = s2d.stem_to_s2d(spec, folded)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        h1 = yolov3.YoloNet(spec, folded, device="cpu")(x)
        h2 = yolov3.YoloNet(spec2, folded2, device="cpu")(x)
    assert len(h1) == len(h2) == 3
    for a, b in zip(h1, h2):
        a, b = a.numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-4 * np.abs(b).max())


def test_engine_rewrites_the_stem_in_every_mode():
    spec = _spec("full", 5)
    folded = _folded(spec, seed=2)
    calib = np.random.RandomState(4).randint(0, 255, (1, 64, 64, 3),
                                             np.uint8)
    for mode in ("bf16", "f32", "int8"):
        eng = DetectionEngine(spec, folded, mode=mode, folded=True,
                              buckets=(1,), device="cpu",
                              calibration_images=calib)
        try:
            assert isinstance(eng.spec.layers[0], yolov3.SpaceToDepth), mode
            assert eng.spec.layers[2].pad == ((1, 0), (1, 0))
        finally:
            eng.close()
    tiny = _spec("tiny", 5)
    eng = DetectionEngine(tiny, _folded(tiny), mode="f32", folded=True,
                          buckets=(1,), device="cpu")
    try:
        assert eng.spec.layers == tiny.layers
    finally:
        eng.close()
