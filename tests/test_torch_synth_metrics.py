"""The port's copies of the scene generator, the detection metrics and
the JPEG encoder against the JAX package's: scenes bit for bit, scores
and evaluations exactly equal, encoded bytes equal for each backend."""

import io

import numpy as np
import pytest

from fastdet_tpu.data import synth as jax_synth
from fastdet_tpu.ops import metrics as jax_metrics
from fastdet_tpu.runtime import jpeg as jax_jpeg
from fastdet_tpu_torch.data import synth
from fastdet_tpu_torch.ops import metrics
from fastdet_tpu_torch.runtime import jpeg


@pytest.mark.parametrize("seeds, num_classes", [
    (range(30000, 30003), 3),        # detect3_tiny held-out
    (range(40000, 40002), 3),        # its calibration
    (range(140000, 140002), 9),
    (range(230100, 230104), 80),     # detect80_full held-out
    (range(240500, 240502), 80),     # its calibration
])
def test_make_dataset_equals_jax(seeds, num_classes):
    got = synth.make_dataset(seeds, num_classes=num_classes)
    want = jax_synth.make_dataset(seeds, num_classes=num_classes)
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_scene_options_equal_jax():
    for kw in ({"size": 384, "max_objects": 5}, {"num_classes": 9},
               {"size": 512, "num_classes": 80, "max_objects": 1}):
        for a, b in zip(synth.make_scene(7, **kw),
                        jax_synth.make_scene(7, **kw)):
            np.testing.assert_array_equal(a, b)
    for make in (synth.make_scene, jax_synth.make_scene):
        with pytest.raises(ValueError, match="exceeds scene size"):
            make(7, size=128, max_objects=5)
    assert synth.SHAPE_CLASSES_80 == jax_synth.SHAPE_CLASSES_80
    assert synth.SHAPE_CLASSES_9 == jax_synth.SHAPE_CLASSES_9


def _seeded_detections(rng, boxes, labels, num_classes, size=416):
    """Per frame: each ground truth found, shifted or mislabelled at
    random, plus random false positives; 1-indexed, top-left pixels."""
    dets = []
    for (cx, cy, w, h), lab in zip(boxes, labels):
        k = int(lab) + 1
        if rng.rand() < 0.2:
            k = int(rng.randint(num_classes)) + 1
        jit = rng.uniform(-0.3, 0.3, 2) * (w, h)
        dets.append((k, float(rng.rand()), float((cx - w / 2 + jit[0]) * size),
                     float((cy - h / 2 + jit[1]) * size), float(w * size),
                     float(h * size)))
    for _ in range(rng.randint(0, 4)):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(10, 120, 2)
        dets.append((int(rng.randint(num_classes)) + 1, float(rng.rand()),
                     float(x), float(y), float(w), float(h)))
    order = rng.permutation(len(dets))
    return [dets[i] for i in order]


@pytest.mark.parametrize("num_classes, seeds", [
    (3, range(30000, 30012)), (80, range(230100, 230112))])
def test_match_and_evaluate_equal_jax_on_seeded_detections(num_classes,
                                                           seeds):
    _, boxes, labels = synth.make_dataset(seeds, num_classes=num_classes)
    rng = np.random.RandomState(num_classes)
    dets = [_seeded_detections(rng, b, l, num_classes)
            for b, l in zip(boxes, labels)]
    scores = [synth.match_detections(d, b, l) for d, b, l in
              zip(dets, boxes, labels)]
    assert scores == [jax_synth.match_detections(d, b, l) for d, b, l in
                      zip(dets, boxes, labels)]
    assert 0 < sum(s[0] for s in scores) < sum(s[1] for s in scores)
    for kw in ({}, {"iou_thresholds": metrics.COCO_IOU_THRESHOLDS}):
        _assert_eval_equal(
            metrics.evaluate_detections(dets, boxes, labels, num_classes,
                                        **kw),
            jax_metrics.evaluate_detections(dets, boxes, labels,
                                            num_classes, **kw))


def _assert_eval_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["map"] == want["map"]
    assert got["per_class"] == want["per_class"]
    assert got.get("map_coco") == want.get("map_coco")
    assert sorted(got["pr"]) == sorted(want["pr"])
    for k, (p, r) in want["pr"].items():
        np.testing.assert_array_equal(got["pr"][k][0], p)
        np.testing.assert_array_equal(got["pr"][k][1], r)


def _gt(*boxes_labels):
    boxes = np.asarray([b for b, _l in boxes_labels], np.float32).reshape(
        -1, 4)
    labels = np.asarray([l for _b, l in boxes_labels], np.int32)
    return boxes, labels


def _box(k, conf, x, y, w=0.2, h=0.2):
    return (k, conf, x * 416, y * 416, w * 416, h * 416)


_GT1 = _gt(((0.5, 0.5, 0.2, 0.2), 0))
_NONE = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))

# tests/test_metrics.py's hand-checked cases: (dets per image, gts per
# image, num_classes, kwargs, (class, key, expected AP))
METRIC_CASES = {
    "perfect": ([[_box(1, 0.9, 0.4, 0.4)]], [_GT1], 1, {},
                (1, "ap@0.5", 1.0)),
    "wrong_class": ([[_box(2, 0.9, 0.4, 0.4)]], [_GT1], 2, {},
                    (1, "ap@0.5", 0.0)),
    "fp_above_tp": ([[_box(1, 0.9, 0.7, 0.7), _box(1, 0.6, 0.15, 0.15)]],
                    [_gt(((0.25, 0.25, 0.2, 0.2), 0))], 1, {},
                    (1, "ap@0.5", 0.5)),
    "duplicate": ([[_box(1, 0.9, 0.4, 0.4), _box(1, 0.8, 0.41, 0.4)]],
                  [_GT1], 1, {}, (1, "ap@0.5", 1.0)),
    "sloppy_box": ([[_box(1, 0.9, 0.43, 0.4)]], [_GT1], 1,
                   {"iou_thresholds": jax_metrics.COCO_IOU_THRESHOLDS},
                   (1, "ap@0.9", 0.0)),
    "cross_image": ([[_box(1, 0.5, 0.4, 0.4)], [_box(1, 0.9, 0.1, 0.1)]],
                    [_GT1, _NONE], 1, {}, (1, "ap@0.5", 0.5)),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_cases_equal_jax(case):
    dets, gts, nc, kw, (k, key, ap) = METRIC_CASES[case]
    boxes = [g[0] for g in gts]
    labels = [g[1] for g in gts]
    got = metrics.evaluate_detections(dets, boxes, labels, nc, **kw)
    _assert_eval_equal(got, jax_metrics.evaluate_detections(
        dets, boxes, labels, nc, **kw))
    assert got["per_class"][k][key] == ap
    if case == "wrong_class":
        assert got["per_class"][2]["ap@0.5"] is None
    if case == "sloppy_box":
        assert got["per_class"][1]["ap@0.5"] == 1.0
        assert 0.0 < got["map_coco"] < 1.0


@pytest.mark.parametrize("backend", ["cv2", "pil"])
@pytest.mark.parametrize("quality", [90, 60])
def test_encode_rgb_equals_jax(monkeypatch, backend, quality):
    """The same encoder library gives the same bytes, so the same
    pixels under any decoder."""
    if backend == "cv2":
        pytest.importorskip("cv2")
        monkeypatch.setattr(jpeg, "_BACKEND", "auto")
        assert jax_jpeg._cv2 is not None
    else:
        pytest.importorskip("PIL")
        monkeypatch.setattr(jpeg, "_BACKEND", "native")  # no cv2 here
        monkeypatch.setattr(jax_jpeg, "_cv2", None)
    img = synth.make_scene(230100, num_classes=80)[0]
    got = jpeg.encode_rgb(img, quality=quality)
    assert got == jax_jpeg.encode_rgb(img, quality=quality)
    from PIL import Image

    pixels = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
    assert pixels.shape == img.shape
    assert np.abs(pixels.astype(int) - img).mean() < 3


def test_encode_rgb_is_420_at_model_size():
    from fastdet_tpu_torch.runtime import native_jpeg

    if not native_jpeg.available():
        pytest.skip("native jpeg library unavailable")
    img = synth.make_scene(30000)[0]
    ci = native_jpeg.decode_coefficients(jpeg.encode_rgb(img, quality=90))
    assert ci.is_420 and (ci.width, ci.height) == (416, 416)
