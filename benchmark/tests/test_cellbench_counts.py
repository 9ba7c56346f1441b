"""The yardstick's counts: FLOPs a frame, B1's bytes, percentiles."""

import io
import math
import os

import numpy as np
import pytest

from benchmark import flops, stats
from benchmark.generators import Frame, Window
from benchmark.harness import load_json

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg(name):
    return load_json(os.path.join(BENCH, "configs", name + ".json"))


@pytest.mark.parametrize("name,published", [
    ("yolov3-full-80", 65.86), ("yolov3-tiny-80", 5.56)])
def test_flops_match_the_published_table(name, published):
    # pjreddie.com/darknet/yolo: YOLOv3-416 65.86 Bn, YOLOv3-tiny 5.56 Bn
    assert round(flops.flops_per_frame(cfg(name)) / 1e9, 2) == published


def test_conv_shapes_follow_the_layer_list():
    shapes = flops.conv_shapes(cfg("yolov3-full-80"))
    assert len(shapes) == 75
    assert [(k, cin, cout) for _, k, cin, cout in shapes[:3]] == [
        (3, 3, 32), (3, 32, 64), (1, 64, 32)]
    # 52 backbone convs, 7 of the 13x13 head (the last the 1x1 255-way
    # one), then the route's 512 into conv 59 and the upsampled 256 with
    # layer 61's 512 into conv 60
    assert shapes[58][3] == 255 and shapes[58][2] == 1024
    assert shapes[59][2] == 512 and shapes[60][2] == 768
    tiny = flops.conv_shapes(cfg("yolov3-tiny-80"))
    assert len(tiny) == 13 and tiny[-2][2] == 384


def _jpeg(w, h, subsampling):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
        buf, format="JPEG", quality=90, subsampling=subsampling)
    return buf.getvalue()


def test_b1_bytes_on_hand_counted_frames():
    # 416x416 4:2:0: Y 52*52 = 2704 blocks, Cb and Cr 26*26 = 676 each
    nb = 2704 + 2 * 676
    assert flops.jpeg_blocks(_jpeg(416, 416, 2)) == nb == 4056
    # offsets 4 int32 per block boundary in, DC lane 1 int32 per block
    # in, 64 int32 coefficients per block out
    assert flops.b1_bytes(_jpeg(416, 416, 2)) == (
        16 * 4057 + 4 * 4056 + 256 * 4056) == 1119472
    # 16x16 4:4:4: 4 blocks in each of 3 components
    assert flops.b1_bytes(_jpeg(16, 16, 0)) == 16 * 13 + 4 * 12 + 256 * 12
    # 20x20 4:2:0 pads to 2x2 MCUs of 16x16: Y 16 blocks, chroma 4 each
    assert flops.jpeg_blocks(_jpeg(20, 20, 2)) == 24


def test_percentile_counts_failed_frames_as_infinitely_late():
    assert stats.percentile([3, 1, 2, 4], 50) == 2
    assert stats.percentile([3, 1, 2, 4], 95) == 4
    assert stats.percentile([], 50) is None
    lat = [float(i) for i in range(1, 21)] + [math.inf]
    assert stats.percentile(lat, 95) == 20.0
    assert stats.percentile(lat + [math.inf], 95) == math.inf
    assert stats.percentile([10.0, math.inf], 50) == 10.0


def test_latency_uses_due_times_and_failed_frames():
    w = Window(t0=0.0, t1=10.0, deadline_s=3.0)
    for i in range(19):
        # due at i, sent 5 ms late, answered 20 ms after due
        w.frames.append(Frame(i % 4, float(i), i + 0.005, i + 0.020, 12,
                              b""))
    w.frames.append(Frame(0, 19.0, 19.001, None))           # never came
    assert stats.latency_ms(w, 50) == pytest.approx(20.0)
    assert stats.latency_ms(w, 95) == pytest.approx(20.0)
    w.frames.append(Frame(0, 20.0, 20.0, 23.5, 1, b""))     # 3.5 s: late
    assert stats.latency_ms(w, 95) == stats.NEVER_MS
    assert w.answered_in_window() == 10
