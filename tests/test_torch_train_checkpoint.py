"""The port's training checkpoints, export and training CLI on the CPU.

save -> restore -> one more step equals the uninterrupted run exactly
(the same arithmetic on the same arrays); the port's export_inference
.npz loads in the JAX package's weights.load_model with the trained
arrays bit for bit and gives the heads of the port's own inference net
on them (within 1e-4 of each head's max: the two packages' convolutions
sum in another order); cli.train draws the JAX CLI's batches and writes
a servable .npz.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet_tpu.models import weights as jax_weights
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu_torch.cli import train as train_cli
from fastdet_tpu_torch.models import weights, yolov3
from fastdet_tpu_torch.parallel import checkpoint, train


def _small_spec(num_classes=4, image_size=64):
    s = yolov3.yolov3_tiny_spec(num_classes)
    return yolov3.ModelSpec(s.name, s.num_classes, s.layers, s.anchors,
                            image_size=image_size)


SPEC = _small_spec()


def _batch(b=2, seed=0):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.rand(b, 64, 64, 3).astype(np.float32))
    boxes = [np.array([[0.5, 0.5, 0.4, 0.4]], np.float32)] * b
    labels = [np.array([0])] * b
    return images, [torch.from_numpy(t)
                    for t in train.build_targets(SPEC, boxes, labels)]


def _state(seed):
    return train.init_train_state(SPEC, weights.synthetic_params(SPEC, seed),
                                  device="cpu")


def _assert_same_state(a, b):
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][k])), (i, k)
    assert a.step == b.step


def test_save_restore_resume_equals_uninterrupted(tmp_path):
    images, targets = _batch()
    step = train.make_train_step(SPEC)
    state, _ = step(_state(3), images, *targets)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, state)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.pt"]   # no temp file left

    restored = checkpoint.restore(path, _state(99))
    assert restored.step == 1
    _assert_same_state(restored, state)

    # resumed training continues exactly as the uninterrupted run
    images2, targets2 = _batch(seed=1)
    resumed, m_resumed = step(restored, images2, *targets2)
    straight, m_straight = step(state, images2, *targets2)
    for k in ("loss", "coord", "obj", "cls"):
        assert float(m_resumed[k]) == float(m_straight[k]), k
    _assert_same_state(resumed, straight)


def test_export_inference_loads_in_jax(tmp_path):
    images, targets = _batch()
    state, _ = train.make_train_step(SPEC)(_state(4), images, *targets)
    out = str(tmp_path / "trained.npz")
    checkpoint.export_inference(out, SPEC, state)

    jspec, jparams = jax_weights.load_model(out)
    assert (jspec.name, jspec.num_classes) == (SPEC.name, SPEC.num_classes)
    trained = state.net.to_params()
    assert jparams.keys() == trained.keys()
    for name, p in trained.items():
        np.testing.assert_array_equal(jparams[name]["w"], p["w"])
        for k, v in p.get("bn", {}).items():
            np.testing.assert_array_equal(jparams[name]["bn"][k], v)
        if "b" in p:
            np.testing.assert_array_equal(jparams[name]["b"], p["b"])

    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jax_yolov3.apply(jspec, p, v))(
        jax_yolov3.fold_params(jspec, jparams), jnp.asarray(x))
    net = yolov3.YoloNet(SPEC, weights.fold_params(SPEC, trained),
                         device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_cli_batches_equal_jax_cli(tmp_path):
    """synthetic_batch and real_batch draw from RandomState(0) in the JAX
    CLI's order: the same seed gives the same arrays."""
    from fastdet_tpu.cli import train as jax_cli
    from fastdet_tpu_torch.runtime import jpeg

    ra, rb = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(2):
        got = train_cli.synthetic_batch(ra, 3, 64, 4)
        want = jax_cli.synthetic_batch(rb, 3, 64, 4)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1] + got[2], want[1] + want[2]):
            np.testing.assert_array_equal(g, w)

    rng = np.random.RandomState(1)
    for i in range(3):
        img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        (tmp_path / f"im{i}.jpg").write_bytes(jpeg.encode_rgb(img))
        if i:
            (tmp_path / f"im{i}.txt").write_text(f"{i} 0.5 0.5 0.25 0.3\n")
    items = train_cli.load_dataset(str(tmp_path), 64)
    jitems = jax_cli.load_dataset(str(tmp_path), 64)
    ra, rb = np.random.RandomState(0), np.random.RandomState(0)
    got = train_cli.real_batch(ra, items, 4, 64)
    want = jax_cli.real_batch(rb, jitems, 4, 64)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(g, w)


def test_cli_train_writes_servable_npz_and_resumes(tmp_path):
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    out, ckpt = str(tmp_path / "out.npz"), str(tmp_path / "ckpt.pt")
    argv = ["train", "--synthetic", "-a", "tiny", "-c", "4",
            "--image-size", "64", "--batch", "2", "-o", out,
            "--ckpt", ckpt, "--ckpt-every", "1", "--log-every", "1"]
    assert train_cli.main(argv + ["--steps", "2"], device="cpu") == 0
    spec, params = weights.load_model(out)
    assert (spec.name, spec.num_classes) == ("yolov3-tiny", 4)
    eng = DetectionEngine(spec, params, mode="f32", buckets=(1,),
                          device="cpu")
    try:
        frame = np.random.RandomState(2).randint(0, 255, (416, 416, 3),
                                                 np.uint8)
        recs = eng.detect_one(frame, 0.1)
        assert all(1 <= r[0] <= 4 for r in recs)
    finally:
        eng.close()
    assert torch.load(ckpt, weights_only=True)["step"] == 2

    # --resume continues from the checkpoint's step to --steps
    assert train_cli.main(argv + ["--steps", "3", "--resume"],
                          device="cpu") == 0
    assert torch.load(ckpt, weights_only=True)["step"] == 3


def test_cli_train_needs_data():
    with pytest.raises(SystemExit):
        train_cli.main(["train", "-a", "tiny"], device="cpu")
