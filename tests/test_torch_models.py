"""The port's model layer (fastdet_tpu_torch/models/) against the JAX
package's: the same layer lists, the same synthetic weights, and heads
within float32 tolerance of yolov3.apply (bf16 within the JAX package's
own bf16 bound, tests/test_models.py)."""

import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu_torch.models import weights, yolov3

WEIGHTS = pathlib.Path(__file__).resolve().parent.parent / "weights"


def _layer_list(spec):
    return [(type(l).__name__, dataclasses.asdict(l)) for l in spec.layers]


@pytest.mark.parametrize("arch,classes", [("tiny", 80), ("full", 80),
                                          ("full", 9)])
def test_spec_equals_jax_spec(arch, classes):
    ours, theirs = yolov3.get_spec(arch, classes), jax_yolov3.get_spec(
        arch, classes)
    assert _layer_list(ours) == _layer_list(theirs)
    assert (ours.name, ours.num_classes, ours.anchors, ours.image_size) == (
        theirs.name, theirs.num_classes, theirs.anchors, theirs.image_size)
    assert yolov3.head_grid_sizes(ours) == jax_yolov3.head_grid_sizes(theirs)
    assert yolov3.conv_io_channels(ours) == jax_yolov3.conv_io_channels(
        theirs)


def test_synthetic_params_equal_jax():
    spec = yolov3.get_spec("tiny", 80)
    ours = weights.synthetic_params(spec)
    theirs = jax_weights.synthetic_params(jax_yolov3.get_spec("tiny", 80))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k]["w"], theirs[k]["w"])


def _heads_both(arch_or_path, size, dtype=torch.float32, seed=0):
    if arch_or_path.endswith(".npz"):
        jspec, jparams = jax_weights.load_npz(arch_or_path)
    else:
        jspec, jparams = jax_weights.load_model(arch_or_path, num_classes=80)
    spec = yolov3.get_spec(jspec.name, jspec.num_classes)
    jax_np = jax.tree_util.tree_map(np.asarray, jparams)
    folded = weights.from_jax_params(spec, jax_np)
    x = np.random.RandomState(seed).rand(2, size, size, 3).astype(np.float32)
    want = jax_yolov3.apply(jspec, jax_yolov3.fold_params(jspec, jparams),
                            jnp.asarray(x))
    net = yolov3.YoloNet(spec, folded, dtype=dtype, device="cpu")
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    return [h.numpy() for h in got], [np.asarray(h) for h in want]


@pytest.mark.parametrize("source", ["synthetic:tiny", "detect9_tiny.npz"])
def test_f32_heads_match_jax(source):
    if source.endswith(".npz"):
        source = str(WEIGHTS / source)
    got, want = _heads_both(source, 96)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        # float reduction order differs between the two conv libraries
        assert np.abs(g - w).max() <= 1e-4 * (1 + np.abs(w).max())


def test_bf16_heads_within_jax_bf16_bound():
    got, want = _heads_both("synthetic:tiny", 96, dtype=torch.bfloat16,
                            seed=1)
    for g, w in zip(got, want):
        # the bound tests/test_models.py holds the JAX bf16 forward to
        assert np.abs(g - w).max() < 0.15 * (np.abs(w).max() + 1)


def test_maxpool_stride1_pads_like_darknet():
    from fastdet_tpu.models import layers as jax_layers
    from fastdet_tpu_torch.models import layers

    x = np.random.RandomState(2).randn(1, 5, 5, 3).astype(np.float32)
    want = np.asarray(jax_layers.maxpool2d(jnp.asarray(x), 2, 1))
    got = layers.maxpool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("net", ["YoloNet", "Int8Net"])
def test_nets_default_to_the_card(monkeypatch, net):
    """The port's public nets default to device="cuda" and raise when no
    card is present (device.resolve); the CPU is asked for by name."""
    from fastdet_tpu_torch.models import quantize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = yolov3.get_spec("tiny", 80)
    folded = weights.fold_params(spec, weights.synthetic_params(spec))
    if net == "YoloNet":
        make = lambda **kw: yolov3.YoloNet(spec, folded, **kw)
    else:
        scales = {l.name: {"x": 0.05, "y": 0.05}
                  for l in spec.conv_specs()}
        qparams = quantize.quantize_params(spec, folded, scales)
        make = lambda **kw: quantize.Int8Net(spec, qparams, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu") is not None
