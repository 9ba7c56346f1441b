"""The plain reference computes what YOLOv4 adds to YOLOv3 (Mish, max
pools centred as Darknet centres them, grouped routes, ``scale_x_y``),
each checked on a hand-computed case, and refuses what it does not
implement."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.flops import _walk, conv_shapes
from benchmark.reference import darknet
from benchmark.reference.detect import _candidates
from benchmark.seeded import seeded_weights
from benchmark.tests.conftest import BENCH


def _cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fp:
        return json.load(fp)


def _heads(layers, weights, frames):
    cfg = {"classes": 0, "bn_epsilon": 1e-5, "layers": layers}
    return darknet.DarknetF32(cfg, weights, "cpu")(torch.from_numpy(frames))


def _bias_conv(bias, activation):
    """A 1x1 convolution over RGB whose output is its bias alone."""
    bias = np.asarray(bias, np.float32)
    layer = {"type": "convolutional", "filters": len(bias), "size": 1,
             "stride": 1, "pad": 1, "activation": activation}
    return layer, {"w": np.zeros((1, 1, 3, len(bias)), np.float32),
                   "b": bias}


#: activations of (-1, 1, 2): LeakyReLU(0.1); x * tanh(ln(1 + e^x))
ACTIVATED = {
    "linear": [-1.0, 1.0, 2.0],
    "leaky": [-0.1, 1.0, 2.0],
    "mish": [-0.30340146137410895, 0.8650983882673103, 1.9439589595339946],
}


@pytest.mark.parametrize("activation", sorted(ACTIVATED))
def test_a_convolution_applies_its_activation(activation):
    conv, w = _bias_conv([-1.0, 1.0, 2.0], activation)
    (head,) = _heads([conv, {"type": "yolo", "mask": [0]}], {"conv0": w},
                     np.zeros((1, 2, 2, 3), np.uint8))
    assert head.shape == (1, 2, 2, 1, 3)
    np.testing.assert_allclose(head[0, 1, 0, 0].numpy(),
                               ACTIVATED[activation], rtol=1e-6)


#: (size, stride, frame side, lit pixel (row, col), output side, rows and
#: columns of the output whose window holds the pixel). Darknet pads
#: size - 1 in all, (size - 1) // 2 before: a window of size 2 starts at
#: its output's own pixel, one of 5, 9 or 13 is centred on it.
POOLS = [
    (2, 1, 7, (3, 3), 7, (2, 3), (2, 3)),
    (2, 2, 6, (3, 3), 3, (1, 1), (1, 1)),
    (2, 2, 7, (6, 6), 4, (3, 3), (3, 3)),
    (5, 1, 7, (3, 3), 7, (1, 5), (1, 5)),
    (5, 1, 7, (0, 0), 7, (0, 2), (0, 2)),
    (9, 1, 9, (8, 0), 9, (4, 8), (0, 4)),
    (13, 1, 13, (0, 12), 13, (0, 6), (6, 12)),
]


@pytest.mark.parametrize("size,stride,n,pixel,out,rows,cols", POOLS,
                         ids=[f"{p[0]}-{p[1]}-at{p[3][0]},{p[3][1]}-of{p[2]}"
                              for p in POOLS])
def test_a_max_pool_pads_as_darknet_does(size, stride, n, pixel, out, rows,
                                         cols):
    frames = np.zeros((1, n, n, 3), np.uint8)
    frames[0, pixel[0], pixel[1], 0] = 255
    (head,) = _heads([{"type": "maxpool", "size": size, "stride": stride},
                      {"type": "yolo", "mask": [0]}], {}, frames)
    want = np.zeros((out, out), np.float32)
    want[rows[0]:rows[1] + 1, cols[0]:cols[1] + 1] = 1.0
    np.testing.assert_array_equal(head[0, :, :, 0, 0].numpy(), want)
    cfg = {"height": n, "width": n, "channels": 3, "layers": [
        {"type": "maxpool", "size": size, "stride": stride},
        {"type": "convolutional", "filters": 1, "size": 1, "stride": 1}]}
    # the FLOP walk, which sizes the seeded weights, agrees
    assert [src[:2] for l, src, _ in _walk(cfg)
            if l["type"] == "convolutional"] == [(out, out)]


@pytest.mark.parametrize("route,channels", [
    ({"layers": [0]}, [1, 2, 3, 4]),
    ({"layers": [0], "groups": 2, "group_id": 1}, [3, 4]),
    ({"layers": [0, -1], "groups": 2, "group_id": 0}, [1, 2, 1, 2]),
    ({"layers": [-1], "groups": 4, "group_id": 2}, [3]),
], ids=["whole", "second-half", "first-halves", "third-quarter"])
def test_a_route_takes_its_group_of_each_source(route, channels):
    conv, w = _bias_conv([1.0, 2.0, 3.0, 4.0], "linear")
    layers = [conv, {"type": "route", **route}, {"type": "yolo",
                                                 "mask": [0]}]
    (head,) = _heads(layers, {"conv0": w}, np.zeros((1, 1, 1, 3), np.uint8))
    np.testing.assert_array_equal(head[0, 0, 0, 0].numpy(), channels)
    cfg = {"height": 1, "width": 1, "channels": 3, "layers": layers[:2] + [
        {"type": "convolutional", "filters": 1, "size": 1, "stride": 1}]}
    assert conv_shapes(cfg)[1][2] == len(channels)


@pytest.mark.parametrize("scale_x_y,x", [(None, 0.75), (1.2, 0.775),
                                         (1.05, 0.75625)])
def test_the_decode_applies_scale_x_y(scale_x_y, x):
    """A 1x2 grid, anchor 104x208 at 416; the box at column 1 has
    sigmoid(tx) = 0.75, sigmoid(ty) = 0.5, tw = th = 0: its centre is
    (1 + 0.75 * s - (s - 1) / 2) / 2 across, 0.5 down, so its left edge
    is that less 0.125 and its top 0.25 for every s."""
    yolo = {"type": "yolo", "mask": [0]}
    if scale_x_y is not None:
        yolo["scale_x_y"] = scale_x_y
    head = torch.zeros((1, 1, 2, 1, 6))
    head[0, 0, 1, 0, 0] = float(np.log(3.0))
    boxes, _, _ = _candidates([head], {"width": 416, "anchors": [[104, 208]],
                                       "layers": [yolo]})
    np.testing.assert_allclose(boxes[0, 1], [x, 0.25, 0.25, 0.5], rtol=1e-6)


def test_a_yolov4_shaped_layer_list_runs_on_seeded_weights():
    """Mish, a CSP split by grouped routes, SPP's three centred pools and
    two heads with scale_x_y, stride-8 head first: the seeded weights'
    shapes (from the FLOP walk) fit the network, every head has its grid."""
    def conv(filters, size=1, stride=1, act="mish", bn=1):
        l = {"type": "convolutional", "filters": filters, "size": size,
             "stride": stride, "pad": 1, "activation": act}
        return {**l, "batch_normalize": 1} if bn else l

    layers = [
        conv(8, 3), conv(16, 3, 2),                              # 0-1
        {"type": "route", "layers": [-1], "groups": 2, "group_id": 1},
        conv(8, 3), {"type": "shortcut", "from": -2, "activation": "linear"},
        {"type": "route", "layers": [-1, 1]}, conv(16, 3, 2, "leaky"),  # 5-6
        {"type": "maxpool", "size": 5, "stride": 1},
        {"type": "route", "layers": [-2]},
        {"type": "maxpool", "size": 9, "stride": 1},
        {"type": "route", "layers": [-4]},
        {"type": "maxpool", "size": 13, "stride": 1},
        {"type": "route", "layers": [-1, -3, -5, -6]},           # 12
        conv(16, 1, 1, "leaky"), {"type": "upsample", "stride": 2},
        {"type": "route", "layers": [-1, 5]},                    # 15
        conv(3 * 7, 1, 1, "linear", 0),
        {"type": "yolo", "mask": [0, 1, 2], "scale_x_y": 1.2},
        {"type": "route", "layers": [13]},
        conv(3 * 7, 1, 1, "linear", 0),
        {"type": "yolo", "mask": [3, 4, 5], "scale_x_y": 1.05},
    ]
    cfg = {"height": 32, "width": 32, "channels": 3, "classes": 2,
           "bn_epsilon": 1e-5, "layers": layers,
           "anchors": [[2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [12, 13]],
           "weights": {"head_scale": 0.02, "objectness_scale": 1.0,
                       "class_bias_top": 2.0, "class_bias_step": 1.0}}
    weights = seeded_weights(cfg, 2 ** 31 + 99, "cpu")
    assert [k for _, k, _, _ in conv_shapes(cfg)] == [3, 3, 3, 3, 1, 1, 1]
    frames = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    heads = darknet.DarknetF32(cfg, weights, "cpu")(torch.from_numpy(frames))
    assert [tuple(h.shape) for h in heads] == [(2, 16, 16, 3, 7),
                                               (2, 8, 8, 3, 7)]
    assert all(torch.isfinite(h).all() for h in heads)
    boxes, scores, klass = _candidates(heads, cfg)
    assert boxes.shape == (2, 3 * (256 + 64), 4)
    assert np.isfinite(boxes).all() and set(np.unique(klass)) <= {1, 2}


@pytest.mark.parametrize("config", ["yolov3-full-80", "yolov3-tiny-80"])
def test_the_darknet_reference_builds_both_shipped_configurations(config):
    cfg = _cfg(config)
    net = darknet.DarknetF32(cfg, _zero_weights(cfg), "cpu")
    assert len(net.convs) == len(conv_shapes(cfg))


def _zero_weights(cfg):
    out = {}
    for i, (layer, k, cin, cout) in enumerate(conv_shapes(cfg)):
        w = np.zeros((k, k, cin, cout), np.float32)
        z = np.zeros((cout,), np.float32)
        out[f"conv{i}"] = ({"w": w, "bn": {"gamma": z, "beta": z,
                                            "mean": z, "var": z}}
                           if layer.get("batch_normalize") else
                           {"w": w, "b": z})
    return out


def _with(cfg, index, **keys):
    """``cfg`` with layer ``index`` updated by ``keys``."""
    layers = [dict(l) for l in cfg["layers"]]
    layers[index].update(keys)
    return {**cfg, "layers": layers}


def _first(cfg, kind):
    return next(i for i, l in enumerate(cfg["layers"]) if l["type"] == kind)


def _refusals():
    full, tiny = _cfg("yolov3-full-80"), _cfg("yolov3-tiny-80")
    conv, yolo, route, short = (_first(full, t) for t in (
        "convolutional", "yolo", "route", "shortcut"))
    pool = _first(tiny, "maxpool")
    return [
        ("swish", _with(full, conv, activation="swish"), conv, "activation"),
        ("conv-groups", _with(full, conv, groups=2), conv, "groups"),
        ("maxpool-padding", _with(tiny, pool, padding=0), pool, "padding"),
        ("new_coords", _with(full, yolo, new_coords=1), yolo, "new_coords"),
        ("route-stride", _with(full, route, stride=2), route, "stride"),
        ("shortcut-leaky", _with(full, short, activation="leaky"), short,
         "activation"),
        ("no-activation", {**full, "layers": [
            {k: v for k, v in l.items() if k != "activation"}
            if i == conv else l for i, l in enumerate(full["layers"])]},
         conv, "activation"),
        ("type", _with(full, conv, type="local"), conv, "local"),
    ]


@pytest.mark.parametrize("cfg,index,key", [pytest.param(*r[1:], id=r[0])
                                           for r in _refusals()])
def test_the_darknet_reference_refuses_what_it_does_not_implement(cfg, index,
                                                                  key):
    with pytest.raises(ValueError, match=rf"layer {index}\b.*'{key}"):
        darknet.DarknetF32(cfg, {}, "cpu")
