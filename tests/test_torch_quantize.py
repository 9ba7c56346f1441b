"""int8 serving (fastdet_tpu_torch/models/quantize.py) against the JAX
package's models/quantize.py, on the CPU at small sizes.

- ``emits_int8`` and ``quantize_params`` equal the JAX package's exactly;
  ``calibrate``'s scales agree within rtol 1e-5 (a float forward, summed
  in another order than XLA's; found: at most 1.2e-6).
- Teacher-forced: every int8 conv, given the int8 input the JAX package's
  own forward fed it (recorded from its CPU route's four split
  convolutions), gives the same int32 accumulators through both of the
  port's routes, and every int8-through epilogue the same int8 output
  as the JAX package's next conv reads.
- The whole ``Int8Net`` forward: every input of the float head convs
  equals the JAX package's bit for bit, so every int8 layer agrees; the
  heads agree within 1e-5 of their largest magnitude (the float head
  convs sum in another order; found: at most 6.5e-7).
- The int8 engine on a small spec (64x64, a few layers) equals the JAX
  int8 engine given the same activation scales.

The card's route (``torch._int_mm``) is also held against the split
route here (``_int_mm`` runs on the CPU too) and on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fastdet_tpu.models import quantize as jax_quantize
from fastdet_tpu.models import s2d as jax_s2d
from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu_torch.models import layers, quantize, s2d, weights, yolov3
from fastdet_tpu_torch.runtime.engine import DetectionEngine

SIZE = 64


def _small(mod, num_classes=3):
    """A few layers of every kind the int8 walk handles: the Darknet stem
    (s2d rewrites it), a residual block, int8-through chains, a route
    with an upsample, two float heads."""
    head = 3 * (5 + num_classes)
    C = mod.Conv
    s = [C(8), C(16, stride=2), C(8, ksize=1), C(16), mod.Shortcut(1),
         C(32, stride=2), C(32, stride=2), C(64, stride=2), C(64, stride=2),
         C(32, ksize=1), C(64), C(head, ksize=1, bn=False, act=False),
         mod.YoloHead(0),
         mod.Route((9,)), C(16, ksize=1), mod.Upsample(), mod.Route((15, 7)),
         C(32), C(head, ksize=1, bn=False, act=False), mod.YoloHead(1)]
    spec = mod._finalize("small", num_classes, s, mod.ANCHORS_TINY)
    return dataclasses.replace(spec, image_size=SIZE)


def _spec(name, mod):
    if name == "small":
        return _small(mod)
    spec = mod.get_spec(name, 3)
    return dataclasses.replace(spec, image_size=SIZE)


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


def _calib(n=2, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (n, SIZE, SIZE, 3),
                                               np.uint8)


def _forms(name, form, seed=0):
    """(port spec, JAX spec, folded params, JAX scales) of a spec in its
    canonical or s2d form; scales from the canonical graph, as both
    engines calibrate."""
    spec, jspec = _spec(name, yolov3), _spec(name, jax_yolov3)
    folded = _folded(spec, seed)
    scales = jax_quantize.calibrate(jspec, folded, _calib())
    if form == "s2d":
        spec, folded_p = s2d.stem_to_s2d(spec, folded)
        jspec, folded = jax_s2d.stem_to_s2d(jspec, folded)
        assert all(np.array_equal(folded[k][w], folded_p[k][w])
                   for k in folded for w in ("w", "b"))
    return spec, jspec, folded, scales


@pytest.mark.parametrize("name,form", [("small", "canon"), ("small", "s2d"),
                                       ("tiny", "canon"), ("full", "canon"),
                                       ("full", "s2d")])
def test_emits_int8_equals_jax(name, form):
    spec, jspec = _spec(name, yolov3), _spec(name, jax_yolov3)
    if form == "s2d":
        f = _folded(spec)
        spec, jspec = s2d.stem_to_s2d(spec, f)[0], jax_s2d.stem_to_s2d(
            jspec, f)[0]
    assert quantize.emits_int8(spec) == jax_quantize.emits_int8(jspec)


@pytest.mark.parametrize("name", ["small", "tiny"])
def test_calibrate_within_rtol_of_jax(name):
    spec, jspec = _spec(name, yolov3), _spec(name, jax_yolov3)
    folded = _folded(spec, seed=4)
    calib = _calib(3, seed=5)
    got = quantize.calibrate(spec, folded, calib, device="cpu")
    want = jax_quantize.calibrate(jspec, folded, calib)
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].keys() == want[n].keys()
        for k in want[n]:
            assert got[n][k] == pytest.approx(want[n][k], rel=1e-5), (n, k)


@pytest.mark.parametrize("name,form", [("small", "canon"), ("small", "s2d"),
                                       ("full", "s2d")])
def test_quantize_params_equal_jax(name, form):
    spec, jspec, folded, scales = _forms(name, form)
    got = quantize.quantize_params(spec, folded, scales)
    want = jax_quantize.quantize_params(jspec, folded, scales)
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].keys() == want[n].keys(), n
        for k in want[n]:
            g, w = np.asarray(got[n][k]), np.asarray(want[n][k])
            assert g.dtype == w.dtype, (n, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{n}/{k}")
    carried = weights.from_jax_qparams(spec, want)
    for n in want:
        for k in want[n]:
            assert carried[n][k].dtype == np.asarray(want[n][k]).dtype
            np.testing.assert_array_equal(carried[n][k], want[n][k])


def _record_jax_int8(monkeypatch, jspec, qparams, x):
    """Run the JAX package's apply_int8 (its CPU route) and record, per
    int8 conv, its int8 input and int32 accumulators (from the four
    split convolutions), and each float head conv's input."""
    orig = jax.lax.conv_general_dilated
    calls = []

    def rec(lhs, rhs, *args, **kw):
        out = orig(lhs, rhs, *args, **kw)
        calls.append(("float" if "preferred_element_type" in kw else "split",
                      np.asarray(lhs), np.asarray(out)))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", rec)
    heads = [np.asarray(h) for h in jax_quantize.apply_int8(
        jspec, qparams, jnp.asarray(x))]
    monkeypatch.setattr(jax.lax, "conv_general_dilated", orig)
    int8, floats, i = [], [], 0
    while i < len(calls):
        if calls[i][0] == "float":
            floats.append(calls[i][1])
            i += 1
            continue
        c = [np.round(calls[i + k][2]).astype(np.int64) for k in range(4)]
        xq = calls[i][1].astype(np.int64) * 16 + calls[i + 2][1].astype(
            np.int64)
        int8.append((xq, (c[0] << 8) + ((c[1] + c[2]) << 4) + c[3]))
        i += 4
    return heads, int8, floats


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _input_scale(net, spec, li):
    """The scale of conv ``li``'s int8 input: the int8-through
    producer's output scale, else the conv's own x_scale."""
    j = li - 1
    while j >= 0 and isinstance(spec.layers[j], yolov3.MaxPool):
        j -= 1
    prev = spec.layers[j] if j >= 0 else None
    if isinstance(prev, yolov3.Conv) and prev.name in net.y_scale:
        return net.y_scale[prev.name]
    return net.x_scale[spec.layers[li].name]


@pytest.mark.parametrize("name,form", [("small", "canon"), ("small", "s2d"),
                                       ("tiny", "canon"), ("full", "s2d")])
def test_int8_forward_matches_jax(monkeypatch, name, form):
    spec, jspec, folded, scales = _forms(name, form, seed=7)
    jq = jax_quantize.quantize_params(jspec, folded, scales)
    x = np.random.RandomState(8).rand(2, SIZE, SIZE, 3).astype(np.float32)
    heads, int8, floats = _record_jax_int8(monkeypatch, jspec, jq, x)
    net = quantize.Int8Net(spec, weights.from_jax_qparams(spec, jq),
                           device="cpu")
    convs = [(li, l) for li, l in enumerate(spec.layers)
             if isinstance(l, yolov3.Conv) and l.bn]
    assert len(convs) == len(int8) > 0

    # teacher-forced: each int8 conv on the JAX forward's own input
    for k, ((li, l), (xq, acc)) in enumerate(zip(convs, int8)):
        xt = _nchw(xq, torch.int8)
        want = acc.transpose(0, 3, 1, 2)
        split = net.accumulate(xt, l)
        mm = quantize.conv_int8_mm(xt, quantize.mm_weight(net.w_q[l.name]),
                                   l.ksize, l.stride, l.pad, l.filters)
        np.testing.assert_array_equal(split.numpy(), want, err_msg=l.name)
        np.testing.assert_array_equal(mm.numpy(), want, err_msg=l.name)
        nxt = spec.layers[li + 1]
        if l.name in net.y_scale and isinstance(nxt, yolov3.Conv):
            # the requantized output is what the JAX forward's next conv
            # read
            out, cs = net.epilogue(split, l, _input_scale(net, spec, li))
            assert cs is net.y_scale[l.name]
            np.testing.assert_array_equal(
                out.permute(0, 2, 3, 1).numpy().astype(np.int64),
                int8[k + 1][0], err_msg=l.name)

    # the whole forward: float head-conv inputs bit for bit, heads to
    # float tolerance
    seen = []
    conv_block = layers.conv_block

    def rec(x, *args, **kw):
        seen.append(x.permute(0, 2, 3, 1).numpy().copy())
        return conv_block(x, *args, **kw)

    monkeypatch.setattr(layers, "conv_block", rec)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(seen) == len(floats) == spec.num_outputs
    for a, b in zip(seen, floats):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got, heads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _int64_conv(xq, w_q, stride, pad):
    """numpy int64 reference: NHWC int8 x HWIO int8 -> NHWC int64."""
    (t, bo), (le, r) = pad
    x = np.pad(xq.astype(np.int64), ((0, 0), (t, bo), (le, r), (0, 0)))
    k = w_q.shape[0]
    ho = (x.shape[1] - k) // stride + 1
    wo = (x.shape[2] - k) // stride + 1
    out = np.zeros((x.shape[0], ho, wo, w_q.shape[3]), np.int64)
    for di in range(k):
        for dj in range(k):
            patch = x[:, di:di + stride * (ho - 1) + 1:stride,
                      dj:dj + stride * (wo - 1) + 1:stride, :]
            out += patch @ w_q[di, dj].astype(np.int64)
    return out


@pytest.mark.parametrize("b,h,c,o,k,stride,pad", [
    (2, 9, 3, 20, 3, 1, None),        # K = 27 and N = 20 pad to 32 / 24
    (1, 6, 16, 8, 3, 2, None),        # M = 9 rows: padded past 16
    (2, 8, 32, 16, 1, 1, None),
    (1, 8, 128, 64, 2, 1, ((1, 0), (1, 0))),   # the s2d conv1'
    (1, 4, 1024, 8, 3, 1, None),      # K = 9216: int32 sums past 2^24
])
def test_int8_conv_routes_exact(b, h, c, o, k, stride, pad):
    rng = np.random.RandomState(h * c)
    xq = rng.randint(-127, 128, (b, h, h, c)).astype(np.int8)
    w_q = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    if c == 1024:       # all extremes: the largest sums the format allows
        xq[:] = 127
        w_q[:] = 127
    want = _int64_conv(xq, w_q, stride, pad or (((k - 1) // 2,) * 2,) * 2)
    xt = _nchw(xq, torch.int8)
    wt = torch.from_numpy(w_q)
    for got in (quantize.conv_int8_split(xt, wt, stride, pad),
                quantize.conv_int8_mm(xt, quantize.mm_weight(wt), k, stride,
                                      pad, o)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.permute(0, 2, 3, 1).numpy().astype(np.int64), want)


def _jax_engine(jspec, folded, calib):
    from fastdet_tpu.runtime.engine import DetectionEngine as JaxEngine

    return JaxEngine(jspec, folded, mode="int8", buckets=(2,), folded=True,
                     calibration_images=calib, devices=jax.devices()[:1])


def test_int8_engine_matches_jax_engine(monkeypatch):
    """The engine's int8 branch (calibrate, stem rewrite, quantize) given
    the JAX calibration's scales: the calibration forward itself is held
    to rtol 1e-5 (test_int8_engine_calibrates_on_its_frames), and one ulp
    of a scale moves int8 counts."""
    spec, jspec = _small(yolov3), _small(jax_yolov3)
    folded = _folded(spec, seed=11)
    calib = _calib(2, seed=12)
    rng = np.random.RandomState(13)
    frames = [np.kron(rng.randint(0, 255, (8, 8, 3), np.uint8),
                      np.ones((8, 8, 1), np.uint8)) for _ in range(2)]
    jeng = _jax_engine(jspec, folded, calib)
    want = jeng.detect(frames, [0.05, 0.05])
    scales = jax_quantize.calibrate(jspec, folded, calib)
    monkeypatch.setattr(quantize, "calibrate", lambda *a, **k: scales)
    eng = DetectionEngine(spec, folded, mode="int8", buckets=(2,),
                          folded=True, device="cpu", calibration_images=calib)
    try:
        assert isinstance(eng.spec.layers[0], yolov3.SpaceToDepth)
        assert isinstance(eng.net, quantize.Int8Net)
        assert eng.act_scales is scales
        got = eng.detect(frames, [0.05, 0.05])
    finally:
        eng.close()
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for rg, rw in zip(g, w):
            assert rg[0] == rw[0]
            np.testing.assert_allclose(rg[1:], rw[1:], rtol=1e-5, atol=1e-4)


def test_int8_engine_calibrates_on_its_frames():
    """The engine calibrates on the canonical graph (before the s2d
    rewrite) from calibration_images."""
    spec = _small(yolov3)
    folded = _folded(spec, seed=11)
    calib = _calib(2, seed=12)
    eng = DetectionEngine(spec, folded, mode="int8", buckets=(1,),
                          folded=True, device="cpu",
                          calibration_images=calib)
    try:
        want = jax_quantize.calibrate(_small(jax_yolov3), folded, calib)
        assert eng.act_scales.keys() == want.keys()
        for n in want:
            for k in want[n]:
                assert eng.act_scales[n][k] == pytest.approx(want[n][k],
                                                             rel=1e-5)
        assert eng.calibration_s > 0
        assert eng.qparams["conv0"]["w_q"].shape == (3, 3, 32, 32)
    finally:
        eng.close()


def test_calibration_frames_equal_jax(monkeypatch, tmp_path):
    """The engine's calibration inputs: FASTDET_CALIB_DIR frames (only
    decodable size x size JPEGs) and the synthetic default scenes. Both
    packages are pinned to their native decoder here
    (FASTDET_JPEG_BACKEND=native); the default order is checked by
    test_calibration_frames_equal_jax_default_decoder."""
    import pathlib
    import shutil

    from fastdet_tpu.runtime import engine as jax_engine
    from fastdet_tpu.runtime import jpeg as jax_jpeg
    from fastdet_tpu_torch.runtime import engine
    from fastdet_tpu_torch.runtime import jpeg as port_jpeg

    monkeypatch.setattr(jax_jpeg, "_BACKEND", "native")
    monkeypatch.setattr(port_jpeg, "_BACKEND", "native")

    np.testing.assert_array_equal(
        engine._default_calibration_images(SIZE, 3),
        jax_engine._default_calibration_images(SIZE, 3))
    testdata = pathlib.Path(__file__).resolve().parent.parent / "testdata"
    for n in ("scene1.jpg", "scene2.jpg"):
        shutil.copy(testdata / n, tmp_path / n)
    (tmp_path / "notes.txt").write_text("not a frame")
    monkeypatch.setenv("FASTDET_CALIB_DIR", str(tmp_path))
    got = engine._calibration_from_dir(416)
    assert got.shape == (2, 416, 416, 3)
    np.testing.assert_array_equal(got, jax_engine._calibration_from_dir(416))
    assert engine._calibration_from_dir(SIZE) is None   # wrong size
    monkeypatch.delenv("FASTDET_CALIB_DIR")
    assert engine._calibration_from_dir(416) is None


def test_calibration_frames_equal_jax_default_decoder(monkeypatch, tmp_path):
    """FASTDET_CALIB_DIR frames with both packages at their default
    decoder order (FASTDET_JPEG_BACKEND=auto: OpenCV, then PIL): the
    port's calibration frames equal the JAX package's byte for byte."""
    import pathlib
    import shutil

    from fastdet_tpu.runtime import engine as jax_engine
    from fastdet_tpu.runtime import jpeg as jax_jpeg
    from fastdet_tpu_torch.runtime import engine
    from fastdet_tpu_torch.runtime import jpeg as port_jpeg

    monkeypatch.setattr(jax_jpeg, "_BACKEND", "auto")
    monkeypatch.setattr(port_jpeg, "_BACKEND", "auto")
    testdata = pathlib.Path(__file__).resolve().parent.parent / "testdata"
    for n in ("scene1.jpg", "scene2.jpg", "adv_night.jpg"):
        shutil.copy(testdata / n, tmp_path / n)
    monkeypatch.setenv("FASTDET_CALIB_DIR", str(tmp_path))
    got = engine._calibration_from_dir(416)
    assert got.shape == (3, 416, 416, 3)
    assert port_jpeg.LAST_DECODER == "cv2"
    np.testing.assert_array_equal(got, jax_engine._calibration_from_dir(416))
