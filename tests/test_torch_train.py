"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs (tiny spec at 64 px with 4 classes, as
tests/test_train.py uses; synthetic weights from one seed) go through
fastdet_tpu.parallel.train and fastdet_tpu_torch.parallel.train.
Tolerances, stated per test:

- targets, sparse targets and flipped slots: equal;
- loss and its parts in float32: rtol 1e-5; in bfloat16: rtol 1e-2;
- gradients: within 1e-4 of each tensor's max |g| (the convolutions sum
  in another order than XLA's);
- one AdamW step: the first step moves each parameter by about lr·sign(g)
  (m̂/√v̂ = ±1 wherever |g| >> eps), so a gradient near zero may take
  either sign under another summation order. Parameters after the step
  agree within 1e-6 wherever |g| is at least 1e-3 of its tensor's max,
  and within 2·lr + 1e-6 elsewhere; BN running statistics rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu.parallel import train as jax_train
from fastdet_tpu_torch.models import layers, weights, yolov3
from fastdet_tpu_torch.models.yolov3 import TrainNet
from fastdet_tpu_torch.parallel import train

LR = 1e-3


def _small_spec(mod, num_classes=4, image_size=64):
    s = mod.yolov3_tiny_spec(num_classes)
    return mod.ModelSpec(s.name, s.num_classes, s.layers, s.anchors,
                         image_size=image_size)


SPEC = _small_spec(yolov3)
JSPEC = _small_spec(jax_yolov3)

BOXES = [np.array([[0.3, 0.3, 0.4, 0.4], [0.7, 0.6, 0.2, 0.3]], np.float32),
         np.array([[0.5, 0.5, 0.6, 0.5]], np.float32),
         np.zeros((0, 4), np.float32)]
LABELS = [np.array([0, 3]), np.array([2]), np.zeros((0,), np.int32)]


def _images(b=3, seed=3):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _targets(sparse):
    if sparse:
        return [train.build_sparse_targets(SPEC, BOXES, LABELS)]
    return train.build_targets(SPEC, BOXES, LABELS)


def _jax_params(seed=5):
    return jax.tree_util.tree_map(jnp.asarray,
                                  jax_weights.synthetic_params(JSPEC, seed))


def _jax_loss_fn(sparse, images, targets, compute_dtype=None):
    imgs = jnp.asarray(images)
    tg = [jnp.asarray(t) for t in targets]
    if sparse:
        return lambda p: jax_train.yolo_loss_sparse(
            JSPEC, p, imgs, tg[0], train=True, compute_dtype=compute_dtype)
    return lambda p: jax_train.yolo_loss(
        JSPEC, p, imgs, tg, train=True, compute_dtype=compute_dtype)


def _port_loss(net, sparse, images, targets, compute_dtype=None):
    imgs = torch.from_numpy(images)
    tg = [torch.from_numpy(t) for t in targets]
    if sparse:
        return train.yolo_loss_sparse(SPEC, net, imgs, tg[0],
                                      compute_dtype=compute_dtype)
    return train.yolo_loss(SPEC, net, imgs, tg, compute_dtype=compute_dtype)


def _net(seed=5):
    return TrainNet.from_params(SPEC, weights.synthetic_params(SPEC, seed),
                                device="cpu")


def _port_grads(net):
    """The port's .grad tensors as the JAX gradient tree's layout."""
    out = {}
    for name, c in net.convs.items():
        g = {"w": c.w.grad.permute(2, 3, 1, 0).numpy()}
        if c.has_bn:
            g["bn"] = {"gamma": c.gamma.grad.numpy(),
                       "beta": c.beta.grad.numpy()}
        else:
            g["b"] = c.b.grad.numpy()
        out[name] = g
    return out


def _leaf_pairs(port_tree, jax_tree):
    for name, p in port_tree.items():
        for k, v in p.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    yield f"{name}/{k}/{kk}", vv, np.asarray(jax_tree[name][k][kk])
            else:
                yield f"{name}/{k}", v, np.asarray(jax_tree[name][k])


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------

def _random_boxes(seed, n_img=4):
    rng = np.random.RandomState(seed)
    boxes, labels = [], []
    for _ in range(n_img):
        n = rng.randint(0, 5)
        cxcy = rng.uniform(0.05, 0.95, (n, 2))
        wh = rng.uniform(0.05, 0.9, (n, 2))
        boxes.append(np.concatenate([cxcy, wh], 1).astype(np.float32))
        labels.append(rng.randint(-1, 4, n))
    # two same-size objects in one cell (the collision rule)
    boxes.append(np.array([[0.30, 0.30, 0.5, 0.5], [0.42, 0.42, 0.5, 0.5]],
                          np.float32))
    labels.append(np.array([0, 2]))
    return boxes, labels


@pytest.mark.parametrize("thr", [0.35, None])
@pytest.mark.parametrize("seed", [0, 1])
def test_targets_equal_jax(seed, thr):
    boxes, labels = _random_boxes(seed)
    got = train.build_targets(SPEC, boxes, labels, multi_anchor_thr=thr)
    want = jax_train.build_targets(JSPEC, boxes, labels, multi_anchor_thr=thr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = train.build_sparse_targets(SPEC, boxes, labels, multi_anchor_thr=thr)
    want = jax_train.build_sparse_targets(JSPEC, boxes, labels,
                                          multi_anchor_thr=thr)
    np.testing.assert_array_equal(got, want)
    assert train.MAX_SLOTS == jax_train.MAX_SLOTS


def test_targets_refuse_out_of_range_label():
    with pytest.raises(ValueError, match="out of range"):
        train.build_targets(SPEC, [np.array([[0.5, 0.5, 0.2, 0.2]])],
                            [np.array([4])])


@pytest.mark.parametrize("fh,fv", [(1, 0), (0, 1), (1, 1), (0, 0)])
def test_flip_slots_equal_jax(fh, fv):
    boxes, labels = _random_boxes(2)
    grids = [2, 4]
    slots = train.build_sparse_targets(SPEC, boxes, labels, grids)
    b = slots.shape[0]
    fh_a = np.array([bool(fh) ^ (i % 2 == 1) for i in range(b)])
    fv_a = np.array([bool(fv)] * b)
    got = train.flip_slots(torch.from_numpy(slots), torch.from_numpy(fh_a),
                           torch.from_numpy(fv_a), grids).numpy()
    want = np.asarray(jax_train.flip_slots(
        jnp.asarray(slots), jnp.asarray(fh_a), jnp.asarray(fv_a), grids))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Layers and the network
# ---------------------------------------------------------------------------

def test_batch_norm_train_stats_biased_variance():
    """Batch mean and the BIASED variance, as jnp.var (torch's BatchNorm
    would keep the unbiased one); y equal to the JAX formula."""
    from fastdet_tpu.models import layers as jax_layers

    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 2, 2).astype(np.float32) * 3 + 1
    gamma = rng.rand(3).astype(np.float32) + 0.5
    beta = rng.randn(3).astype(np.float32)
    y, mean, var = layers.batch_norm_train_stats(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    xn = x.transpose(0, 2, 3, 1)
    jy, jm, jv = jax_layers.batch_norm_train_stats(
        {"gamma": gamma, "beta": beta}, jnp.asarray(xn))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), xn.var(axis=(0, 1, 2)), rtol=1e-6)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), rtol=1e-5, atol=1e-6)
    # a float64 input keeps float64 statistics (the float64 reference step)
    y64, m64, v64 = layers.batch_norm_train_stats(
        torch.from_numpy(x).double(), torch.from_numpy(gamma).double(),
        torch.from_numpy(beta).double())
    assert y64.dtype == m64.dtype == v64.dtype == torch.float64
    np.testing.assert_allclose(v64.numpy(),
                               xn.astype(np.float64).var(axis=(0, 1, 2)),
                               rtol=1e-12)


@pytest.mark.parametrize("with_bn", [True, False], ids=["bn", "bias"])
def test_conv_bn_block_train_matches_jax(with_bn):
    """conv + batch-stat BN or + bias, then LeakyReLU: within 1e-5 of
    the output's max against the JAX block (f32)."""
    from fastdet_tpu.models import layers as jax_layers

    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 9, 5).astype(np.float32)
    w = rng.randn(3, 3, 5, 4).astype(np.float32) * 0.3
    gamma, beta, b = (rng.randn(4).astype(np.float32) for _ in range(3))
    jp = ({"w": w, "bn": {"gamma": gamma, "beta": beta}} if with_bn
          else {"w": w, "b": b})
    want = np.asarray(jax_layers.conv_bn_block_train(jp, jnp.asarray(x), 2))
    t = torch.from_numpy
    kw = ({"bn": (t(gamma), t(beta))} if with_bn else {"b": t(b)})
    got, stats = layers.conv_bn_block_train(
        t(x).permute(0, 3, 1, 2), t(w.transpose(3, 2, 0, 1).copy()), 2,
        **kw)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (stats is not None) == with_bn


def test_leaky_relu_gradient_at_zero_is_one():
    """where(x >= 0, ...) passes gradient 1 at exactly 0, as the JAX
    package's leaky_relu does; F.leaky_relu would pass 0.1."""
    from fastdet_tpu.models import layers as jax_layers

    x = torch.zeros(3, requires_grad=True)
    layers.leaky_relu(x).sum().backward()
    want = jax.grad(lambda v: jax_layers.leaky_relu(v).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [1.0, 1.0, 1.0]


def test_train_net_params_round_trip_exact():
    params = weights.synthetic_params(SPEC, seed=7)
    for name, p in params.items():   # non-trivial BN statistics
        if "bn" in p:
            p["bn"]["mean"] = p["bn"]["mean"] + 0.25
            p["bn"]["var"] = p["bn"]["var"] * 1.5
    back = TrainNet.from_params(SPEC, params, device="cpu").to_params()
    assert back.keys() == params.keys()
    for key, got, want in _leaf_pairs(back, params):
        assert got.dtype == np.float32, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_forward_heads_match_jax(dtype):
    """TrainNet's NHWC heads against apply(train=True), per compute
    dtype: f32 within 1e-4 of the head's max, bf16 within 5e-2."""
    images = _images()
    cd, jcd, tol = ((None, None, 1e-4) if dtype == "f32"
                    else (torch.bfloat16, jnp.bfloat16, 5e-2))
    heads = _net()(torch.from_numpy(images), cd)
    want = jax.jit(lambda p, x: jax_yolov3.apply(
        JSPEC, p, x, train=True, compute_dtype=jcd))(
            _jax_params(), jnp.asarray(images))
    assert len(heads) == len(want)
    for h, w in zip(heads, want):
        w = np.asarray(w)
        assert h.dtype == torch.float32 and h.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(h.detach().numpy() - w).max() <= tol * scale


# ---------------------------------------------------------------------------
# Loss, gradients, train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_loss_and_gradients_match_jax(sparse):
    """Loss and parts within rtol 1e-5; every gradient within 1e-4 of its
    tensor's max |g| against jax.grad."""
    images, targets = _images(), _targets(sparse)
    net = _net()
    total, metrics = _port_loss(net, sparse, images, targets)
    total.backward()
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(sparse, images, targets), has_aux=True))(_jax_params())
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for key in ("loss", "coord", "obj", "cls"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    n = 0
    for key, got, want in _leaf_pairs(_port_grads(net), jgrads):
        scale = np.abs(want).max()
        assert scale > 0, key
        assert np.abs(got - want).max() <= 1e-4 * scale, key
        n += 1
    assert n == 2 * len(SPEC.conv_specs()) + sum(
        l.bn for l in SPEC.conv_specs())


def test_dense_and_sparse_loss_agree():
    images = _images()
    dense, _ = _port_loss(_net(), False, images, _targets(False))
    sparse, _ = _port_loss(_net(), True, images, _targets(True))
    np.testing.assert_allclose(float(dense), float(sparse), rtol=1e-5)


def test_bf16_loss_matches_jax():
    """compute_dtype bfloat16 on both sides: loss within rtol 1e-2."""
    images, targets = _images(), _targets(False)
    total, _ = _port_loss(_net(), False, images, targets,
                          compute_dtype=torch.bfloat16)
    jtotal, _ = jax.jit(_jax_loss_fn(False, images, targets,
                                     jnp.bfloat16))(_jax_params())
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-2)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_train_step_matches_jax(sparse):
    """One step of make_train_step against the JAX package's, from the
    same parameters on the same batch (tolerances in the module
    docstring)."""
    images, targets = _images(), _targets(sparse)
    state = train.init_train_state(SPEC, weights.synthetic_params(SPEC, 5),
                                   lr=LR, device="cpu")
    state, metrics = train.make_train_step(SPEC, sparse=sparse)(
        state, torch.from_numpy(images), *[torch.from_numpy(t)
                                           for t in targets])
    assert state.step == 1
    grads = _port_grads(state.net)

    opt = jax_train.make_optimizer(LR)
    jstate = jax_train.init_train_state(JSPEC, _jax_params(), opt)
    jstate, jmetrics = jax.jit(jax_train.make_train_step(
        JSPEC, opt, sparse=sparse))(jstate, jnp.asarray(images),
                                    *[jnp.asarray(t) for t in targets])
    for key in ("loss", "coord", "obj", "cls"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=1e-5)
    after = state.net.to_params()
    for key, got, want in _leaf_pairs(after, jstate.params):
        name, leaf = key.split("/")[0], key.split("/")[-1]
        if leaf in ("mean", "var"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
            continue
        g = (grads[name]["bn"][leaf] if leaf in ("gamma", "beta")
             else grads[name][leaf])
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        diff = np.abs(got - want)
        assert diff[clear].max() <= 1e-6, key
        assert diff.max() <= 2 * LR + 1e-6, key


def test_bn_ema_contract():
    """new running mean = m·old + (1-m)·batch mean of conv0's output,
    with the batch mean computed independently (momentum 0.97, after
    the optimizer update, from this step's own statistics); the variance
    EMA takes the biased batch variance."""
    images, targets = _images(), _targets(False)
    params = weights.synthetic_params(SPEC, 1)
    state = train.init_train_state(SPEC, params, lr=LR, device="cpu")
    state, _ = train.make_train_step(SPEC)(
        state, torch.from_numpy(images), *[torch.from_numpy(t)
                                           for t in targets])
    conv0 = SPEC.conv_specs()[0]
    w = torch.from_numpy(params["conv0"]["w"].transpose(3, 2, 0, 1).copy())
    y = torch.nn.functional.conv2d(
        torch.from_numpy(images).permute(0, 3, 1, 2), w,
        stride=conv0.stride, padding=1).numpy().astype(np.float64)
    bm, bv = y.mean(axis=(0, 2, 3)), y.var(axis=(0, 2, 3))
    m = train.BN_MOMENTUM
    assert m == jax_train.BN_MOMENTUM == 0.97
    after = state.net.convs["conv0"]
    np.testing.assert_allclose(after.mean.numpy(),
                               m * params["conv0"]["bn"]["mean"]
                               + (1 - m) * bm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after.var.numpy(),
                               m * params["conv0"]["bn"]["var"]
                               + (1 - m) * bv, rtol=1e-5, atol=1e-6)


def test_decay_mask_matches_jax():
    """Weight decay on the conv kernels only, in the optimizer's first
    group at 5e-4; BN gamma/beta and head biases in the second at 0."""
    net = _net()
    mask = train.decay_mask(net)
    jmask = jax_train._decay_mask(jax_weights.synthetic_params(JSPEC, 5))
    want = {}
    for name, p in jmask.items():
        want[f"convs.{name}.w"] = p["w"]
        if "bn" in p:
            want[f"convs.{name}.gamma"] = p["bn"]["gamma"]
            want[f"convs.{name}.beta"] = p["bn"]["beta"]
        else:
            want[f"convs.{name}.b"] = p["b"]
    assert mask == want
    opt = train.make_optimizer(net, 1e-3)
    named = {id(p): n for n, p in net.named_parameters()}
    (g0, g1) = opt.param_groups
    assert g0["weight_decay"] == 5e-4 and g1["weight_decay"] == 0.0
    assert {named[id(p)] for p in g0["params"]} == {
        n for n, d in mask.items() if d}
    assert {named[id(p)] for p in g1["params"]} == {
        n for n, d in mask.items() if not d}
    for g in (g0, g1):
        assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    assert not any(n.endswith((".mean", ".var"))
                   for n, _ in net.named_parameters())


def test_train_entry_points_raise_without_a_card(monkeypatch):
    from fastdet_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = weights.synthetic_params(SPEC)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainNet.from_params(SPEC, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.init_train_state(SPEC, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["train", "--synthetic", "-a", "tiny"])
