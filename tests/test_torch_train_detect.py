"""The checkpoints' trainer of the port (fastdet_tpu_torch/tools/
train_detect.py) and what it adds to the port, against the JAX package
and tools/train_detect3.py on the CPU.

- The one-image postprocess (decode_head, decode_all, select_candidates,
  soft_nms, postprocess_image), postprocess_batch and to_reference_results
  against fastdet_tpu's on the heads of tests/test_postprocess.py's cases
  (tiny, 8 classes, 4x4 and 8x8 grids): counts, classes and pick order
  exact; scores and boxes rtol 1e-5 (atol 1e-5 of the largest |value|,
  as tests/test_torch_postprocess.py: torch's sigmoid and exp differ from
  XLA's by up to 2 ulp); the reference tuples of one NMSResult equal.
- The lr schedule against optax.warmup_cosine_decay_schedule at every
  step of a 40-step and a 3-step run of the recipe: rtol 1e-6.
- The recipe's chain, clip_by_global_norm(c) then AdamW under the
  schedule with the decay mask, against the JAX make_train_step with
  optax.chain(...) on tests/test_torch_train.py's tiny 64-px spec, at
  c = 10, at a c under the step's gradient norm (the clip fires) and at
  one over it: two steps of the 3-step schedule on one batch (the first
  at lr 0, which leaves the parameters as they were, the second at lr on
  the same gradient, an Adam first step). Loss rtol 1e-5 each step; the
  norm before the clip rtol 1e-5; Adam moments within 1e-4 / 2e-4 of
  their tensor's max each step; parameters after the second step within
  1e-6 wherever |g| is at least 1e-3 of its tensor's max, within
  2·lr + 1e-6 elsewhere; BN running statistics rtol 1e-5 with atol 1e-7
  after the first step's EMA and 2e-7 after the second's (each EMA
  carries one step's error).
- The augmentation against a JAX transcription of the tool's step
  (tools/train_detect3.py:265-282) on the same noise array, sparse and
  dense targets: atol 1e-6 on the images, targets equal.
- main(..., device="cpu") for two steps of --arch tiny on a few scenes,
  dense and sparse (from the dense run's checkpoint, JPEG q90 scenes):
  its float16 .npz loads with the JAX weights.load_npz and its .json
  has the keys of the JAX tool's sidecar (weights/detect80_full.json).
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu.ops import decode as jax_decode
from fastdet_tpu.ops import nms as jax_nms
from fastdet_tpu.ops import postprocess as jax_pp
from fastdet_tpu.parallel import train as jax_train
from fastdet_tpu_torch.models import weights, yolov3
from fastdet_tpu_torch.ops import decode, nms, postprocess
from fastdet_tpu_torch.parallel import train
from fastdet_tpu_torch.tools import train_detect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _heads(seed, b=None):
    """tests/test_postprocess.py's random heads (tiny, 8 classes, grids
    4 and 8); a leading batch of ``b`` when given."""
    rng = np.random.RandomState(seed)
    spec = yolov3.get_spec("tiny", 8)
    shape = (lambda g: (g, g, spec.head_channels)) if b is None else \
        (lambda g: (b, g, g, spec.head_channels))
    return [rng.randn(*shape(g)).astype(np.float32) for g in (4, 8)]


SPEC8 = yolov3.get_spec("tiny", 8)
JSPEC8 = jax_yolov3.get_spec("tiny", 8)


def _assert_nms_equal(res, jres):
    for f in ("klass", "valid", "count"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    _close(res.scores.numpy(), jres.scores)
    _close(res.boxes.numpy(), jres.boxes)


# ---------------------------------------------------------------------------
# The one-image postprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_head_and_decode_all_match_jax(seed):
    heads = _heads(seed)
    for h, anchors in zip(heads, SPEC8.anchors):
        a = np.asarray(anchors, np.float32)
        b, s, k = decode.decode_head(torch.from_numpy(h), torch.from_numpy(a),
                                     8, SPEC8.image_size)
        jb, js, jk = jax_decode.decode_head(jnp.asarray(h), jnp.asarray(a), 8,
                                            JSPEC8.image_size)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        _close(s.numpy(), js)
        _close(b.numpy(), jb)
    b, s, k = decode.decode_all([torch.from_numpy(h) for h in heads], SPEC8)
    jb, js, jk = jax_decode.decode_all([jnp.asarray(h) for h in heads],
                                       JSPEC8)
    assert b.shape == (4 * 4 * 3 + 8 * 8 * 3, 4)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    _close(s.numpy(), js)
    _close(b.numpy(), jb)


@pytest.mark.parametrize("seed,thr,budget", [(0, 0.45, 256), (1, 0.3, 16),
                                             (2, 0.9, 256)])
def test_select_candidates_and_soft_nms_match_jax(seed, thr, budget):
    """The budget's picks and order, then soft_nms over JAX's own
    candidates (one input for both NMS)."""
    heads = _heads(seed)
    jb, js, jk = jax_decode.decode_all([jnp.asarray(h) for h in heads],
                                       JSPEC8)
    b, s, k = decode.select_candidates(
        *(torch.from_numpy(np.array(a)) for a in (jb, js, jk)), thr, budget)
    jsb, jss, jsk = jax_decode.select_candidates(jb, js, jk,
                                                 jnp.float32(thr), budget)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jsk))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jss))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jsb))
    res = nms.soft_nms(*(torch.from_numpy(np.array(a))
                         for a in (jsb, jss, jsk)), thr, 32)
    jres = jax_nms.soft_nms(jsb, jss, jsk, jnp.float32(thr), 32)
    assert res.scores.shape == (32,) and res.count.shape == ()
    _assert_nms_equal(res, jres)


def test_candidate_budget_truncates_lowest():
    """tests/test_postprocess.py's budget case: the 8 highest of 50."""
    rng = np.random.RandomState(3)
    n = 50
    boxes = rng.rand(n, 4).astype(np.float32) * 0.05
    scores = np.linspace(0.2, 0.9, n).astype(np.float32)
    klass = np.ones((n,), np.int32)
    _, s, _ = decode.select_candidates(torch.from_numpy(boxes),
                                       torch.from_numpy(scores),
                                       torch.from_numpy(klass), 0.1, 8)
    _, js, _ = jax_decode.select_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(klass),
        jnp.float32(0.1), 8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", list(range(6)))
def test_postprocess_image_matches_jax(seed):
    """tests/test_postprocess.py's full-postprocess cases (seeds 100+,
    threshold 0.5, budget 256, 64 detections), and the reference tuples
    of each side's result."""
    heads = _heads(100 + seed)
    res = postprocess.postprocess_image([torch.from_numpy(h) for h in heads],
                                        SPEC8, 0.5, 256, 64)
    jres = jax_pp.postprocess_image([jnp.asarray(h) for h in heads], JSPEC8,
                                    jnp.float32(0.5), 256, 64)
    _assert_nms_equal(res, jres)
    got = postprocess.to_reference_results(res, SPEC8.image_size)
    want = jax_pp.to_reference_results(jres, JSPEC8.image_size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.95])
def test_postprocess_batch_matches_jax(thr):
    """One threshold shared by a batch of 3 (the JAX vmap of
    postprocess_image)."""
    heads = _heads(11, b=3)
    res = postprocess.postprocess_batch([torch.from_numpy(h) for h in heads],
                                        SPEC8, thr, 128, 32)
    jres = jax_pp.postprocess_batch([jnp.asarray(h) for h in heads], JSPEC8,
                                    jnp.float32(thr), 128, 32)
    assert res.count.shape == (3,)
    _assert_nms_equal(res, jres)


def test_to_reference_results_equal_jax():
    """One NMSResult (host arrays), both converters: the same tuples,
    float64 pixel coordinates, pick order, the count's length."""
    jres = jax_pp.postprocess_image([jnp.asarray(h) for h in _heads(100)],
                                    JSPEC8, jnp.float32(0.3), 256, 64)
    host = jax_nms.NMSResult(*(np.array(a) for a in jres))
    want = jax_pp.to_reference_results(host, 416)
    got = postprocess.to_reference_results(
        nms.NMSResult(*(torch.from_numpy(a) for a in host)), 416)
    assert got == want and len(got) == int(host.count) > 0
    assert postprocess.to_reference_results(host, 416) == want


# ---------------------------------------------------------------------------
# The recipe: schedule and clipped AdamW
# ---------------------------------------------------------------------------

def _recipe_schedules(steps, lr):
    warmup = min(100, max(1, steps // 10))
    kw = dict(warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
              end_value=lr * 0.05)
    return (train.warmup_cosine_decay_schedule(0.0, lr, **kw),
            optax.warmup_cosine_decay_schedule(0.0, lr, **kw))


@pytest.mark.parametrize("steps", [40, 3])
def test_schedule_matches_optax(steps):
    mine, want = _recipe_schedules(steps, 1e-3)
    for count in range(steps + 3):
        np.testing.assert_allclose(mine(count), float(want(count)),
                                   rtol=1e-6, atol=0, err_msg=str(count))
    assert mine(0) == 0.0


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


def _leaves(tree):
    for name, p in tree.items():
        for k, v in p.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    yield f"{name}/{k}/{kk}", np.asarray(vv)
            else:
                yield f"{name}/{k}", np.asarray(v)


def _jax_norm(params, images, targets):
    """optax.global_norm of the JAX step's gradients."""
    imgs = jnp.asarray(images)
    tg = [jnp.asarray(t) for t in targets]
    grads = jax.grad(lambda p: jax_train.yolo_loss(
        JSPEC, p, imgs, tg, train=True)[0])(params)
    return float(optax.global_norm(grads))


@pytest.mark.parametrize("clip", [10.0, "under", "over"])
def test_clipped_step_matches_jax_chain(clip):
    """At the recipe's norm 10, at a quarter of the step's gradient norm
    (the clip fires) and at four times it (the gradients pass)."""
    images = np.random.RandomState(3).rand(3, 64, 64, 3).astype(np.float32)
    targets = train.build_targets(SPEC, BOXES, LABELS)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, jax_weights.synthetic_params(JSPEC, 5))
    norm = _jax_norm(jparams, images, targets)
    c = {"under": norm / 4, "over": norm * 4}.get(clip, clip)
    sched, jsched = _recipe_schedules(3, LR)
    state = train.init_train_state(SPEC, weights.synthetic_params(SPEC, 5),
                                   lr=sched, clip_norm=c, device="cpu")
    step = train.make_train_step(SPEC)
    opt = optax.chain(optax.clip_by_global_norm(c),
                      optax.adamw(jsched, weight_decay=5e-4,
                                  mask=jax_train._decay_mask))
    jstate = jax_train.init_train_state(JSPEC, jparams, opt)
    jstep = jax.jit(jax_train.make_train_step(JSPEC, opt))
    before = state.net.to_params()
    for i in range(2):
        state, m = step(state, torch.from_numpy(images),
                        *[torch.from_numpy(t) for t in targets])
        jstate, jm = jstep(jstate, jnp.asarray(images),
                           *[jnp.asarray(t) for t in targets])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)
        after = state.net.to_params()
        want = dict(_leaves(jstate.params))
        for key, got in _leaves(after):
            if key.endswith(("mean", "var")):   # one EMA of error a step
                np.testing.assert_allclose(got, want[key], rtol=1e-5,
                                           atol=1e-7 * (i + 1), err_msg=key)
        _assert_moments_close(state, jstate)
        if i == 0:   # lr 0: the parameters stay, the moments move
            for (k, a), (_, b) in zip(_leaves(before), _leaves(after)):
                if not k.endswith(("mean", "var")):
                    np.testing.assert_array_equal(a, b, err_msg=k)
    assert [g["lr"] for g in state.optimizer.param_groups] == [sched(1)] * 2
    grads = {n: p.grad.numpy() for n, p in state.net.named_parameters()}
    for key, got in _leaves(after):
        name, leaf = key.split("/")[0], key.split("/")[-1]
        if leaf in ("mean", "var"):
            continue
        g = grads[f"convs.{name}.{leaf}"]
        g = g.transpose(2, 3, 1, 0) if leaf == "w" else g
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        diff = np.abs(got - want[key])
        assert diff[clear].max() <= 1e-6, key
        assert diff.max() <= 2 * LR + 1e-6, key


def _assert_moments_close(state, jstate):
    """The port's Adam moments against the JAX chain's (its adamw's
    ScaleByAdamState), within 1e-4 / 2e-4 of each tensor's max."""
    adam = jstate.opt_state[1][0]
    jmu, jnu = dict(_leaves(adam.mu)), dict(_leaves(adam.nu))
    named = {id(p): n for n, p in state.net.named_parameters()}
    for p, st in state.optimizer.state.items():
        _, name, leaf = named[id(p)].split(".")
        key = f"{name}/bn/{leaf}" if leaf in ("gamma", "beta") else \
            f"{name}/{leaf}"
        perm = (lambda a: a.transpose(2, 3, 1, 0)) if leaf == "w" else \
            (lambda a: a)
        m, v = perm(st["exp_avg"].numpy()), perm(st["exp_avg_sq"].numpy())
        assert np.abs(m - jmu[key]).max() <= 1e-4 * np.abs(jmu[key]).max()
        assert np.abs(v - jnu[key]).max() <= 2e-4 * np.abs(jnu[key]).max()


def test_default_state_has_no_schedule_or_clip():
    """The default stays the constant-lr AdamW without a clip: no
    "grad_norm" metric, the lr untouched by the step."""
    state = train.init_train_state(SPEC, weights.synthetic_params(SPEC, 5),
                                   lr=LR, device="cpu")
    assert state.schedule is None and state.clip_norm is None
    images = np.random.RandomState(3).rand(3, 64, 64, 3).astype(np.float32)
    state, m = train.make_train_step(SPEC)(
        state, torch.from_numpy(images),
        *[torch.from_numpy(t) for t in train.build_targets(SPEC, BOXES,
                                                            LABELS)])
    assert "grad_norm" not in m
    assert [g["lr"] for g in state.optimizer.param_groups] == [LR, LR]


# ---------------------------------------------------------------------------
# The augmentation
# ---------------------------------------------------------------------------

def _jax_augment(data, tgts, idx, flip, cj_s, cj_o, noise, grids, sparse):
    """tools/train_detect3.py:265-282 with jax.random.normal(key) * 0.02
    replaced by the given noise * 0.02."""
    imgs = jnp.take(data, idx, axis=0).astype(jnp.float32) / 255.0
    fh = (flip & 1).astype(bool)
    fv = ((flip >> 1) & 1).astype(bool)
    imgs = jnp.where(fh[:, None, None, None], imgs[:, :, ::-1, :], imgs)
    imgs = jnp.where(fv[:, None, None, None], imgs[:, ::-1, :, :], imgs)
    imgs = imgs * cj_s[:, None, None, :] + cj_o[:, None, None, :]
    imgs = imgs + noise * 0.02
    imgs = jnp.clip(imgs, 0.0, 1.0)
    if sparse:
        slots = jnp.take(tgts[0], idx, axis=0)
        picked = (jax_train.flip_slots(slots, fh, fv, grids),)
    else:
        fi = flip * data.shape[0] + idx
        picked = tuple(jnp.take(t, fi, axis=0).astype(jnp.float32)
                       for t in tgts)
    return imgs, picked


def _jax_dense_variants(spec, boxes, labels, store):
    """tools/train_detect3.py:196-222: the four flip variants, flattened."""
    variants = []
    for f in range(4):
        boxes_f = []
        for b in boxes:
            b = b.copy()
            if f & 1:
                b[:, 0] = 1.0 - b[:, 0]
            if f & 2:
                b[:, 1] = 1.0 - b[:, 1]
            boxes_f.append(b)
        variants.append(jax_train.build_targets(spec, boxes_f, labels))
    return [np.concatenate([v[s] for v in variants]).astype(store)
            for s in range(spec.num_outputs)]


@pytest.mark.parametrize("sparse,classes,store", [
    (True, 80, np.float32), (False, 3, np.float32), (False, 3, np.float16)],
    ids=["sparse-80", "dense-3", "dense-3-f16"])
def test_augment_matches_jax_transcription(sparse, classes, store):
    rng = np.random.RandomState(0)
    n, b = 5, 8
    data = rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
    boxes = [np.array([[0.2 + 0.1 * i, 0.3, 0.3, 0.2],
                       [0.7, 0.25 + 0.1 * i, 0.2, 0.4]], np.float32)
             for i in range(n)]
    labels = [np.array([i % 3, (i + 1) % 3]) for i in range(n)]
    grids = yolov3.head_grid_sizes(SPEC)
    if sparse:
        tgts = [train.build_sparse_targets(SPEC, boxes, labels)]
    else:
        tgts = train_detect.dense_flip_targets(SPEC, boxes, labels, store)
        for got, want in zip(tgts, _jax_dense_variants(JSPEC, boxes, labels,
                                                       store)):
            np.testing.assert_array_equal(got, want)
    idx, flip, cj_s, cj_o = train_detect.draw_step(
        np.random.RandomState(7), n, b, classes)
    flip[:4] = [0, 1, 2, 3]
    if classes == 80:   # shared across channels
        assert (cj_s[:, 0] == cj_s[:, 2]).all()
    noise = np.random.RandomState(1).randn(b, 64, 64, 3).astype(np.float32)
    imgs, picked = train_detect.augment(
        torch.from_numpy(data), [torch.from_numpy(t) for t in tgts],
        torch.from_numpy(idx).long(), torch.from_numpy(flip).long(),
        torch.from_numpy(cj_s), torch.from_numpy(cj_o),
        torch.from_numpy(noise), grids, sparse)
    jimgs, jpicked = _jax_augment(
        jnp.asarray(data), [jnp.asarray(t) for t in tgts], jnp.asarray(idx),
        jnp.asarray(flip), jnp.asarray(cj_s), jnp.asarray(cj_o),
        jnp.asarray(noise), grids, sparse)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), rtol=0,
                               atol=1e-6)
    assert len(picked) == len(jpicked)
    for p, jp in zip(picked, jpicked):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


# ---------------------------------------------------------------------------
# The tool end to end on the CPU
# ---------------------------------------------------------------------------

def test_main_on_the_cpu_dense_then_sparse(tmp_path, monkeypatch):
    """Two steps of --arch tiny on four scenes, dense targets, then two
    sparse ones from its checkpoint on q90 scenes: each writes a float16
    .npz that the JAX load_npz reads and a sidecar with the JAX tool's
    keys; the report holds the recipe's lr and the norms before the
    clip."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with open(os.path.join(REPO, "weights", "detect80_full.json")) as fp:
        keys = set(json.load(fp))
    common = ["--arch", "tiny", "--classes", "3", "--n-train", "4",
              "--n-val", "2", "--batch", "2", "--steps", "2",
              "--eval-every", "1", "--eval-chunk", "1",
              "--target-strict", "2"]
    dense = str(tmp_path / "dense.npz")
    rep = train_detect.main(["train_detect"] + common + ["--out", dense],
                            device="cpu")
    sparse = str(tmp_path / "sparse.npz")
    rep2 = train_detect.main(
        ["train_detect"] + common + ["--sparse-targets", "--jpeg-q", "90",
                                     "--init-from", dense, "--out", sparse],
        device="cpu")
    for out, r in ((dense, rep), (sparse, rep2)):
        with np.load(out) as z:
            assert all(z[k].dtype == np.float16 for k in z.files
                       if k != "__meta__")
        spec, params = jax_weights.load_npz(out)
        assert (spec.name, spec.num_classes) == ("yolov3-tiny", 3)
        with open(out[:-4] + ".json") as fp:
            meta = json.load(fp)
        assert set(meta) == keys
        assert meta == r["meta"]
        assert meta["steps_run"] == 2 and len(meta["history"]) == 2
        assert meta["train_seeds"] == [1000, 1004]
        assert meta["val_seeds"] == [20000, 20002]
        assert r["lr_first"] == 0.0
        assert r["lr_last"] == pytest.approx(1e-3)
        assert np.isfinite(r["grad_norm_first"]) and r["grad_norm_max"] > 0
    assert rep2["meta"]["jpeg_q"] == 90
    assert len(os.listdir(tmp_path / "fastdet_shapes")) == 4


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_detect.main(["train_detect", "--steps", "1"])
