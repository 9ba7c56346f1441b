"""Shared helpers of the benchmark's CPU tests."""

import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark's directory and of BENCHMARK.json, for a
    test to add files to."""
    import json

    d = tmp_path / "benchmark"
    shutil.copytree(BENCH, d, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    return str(d), bench


#: the test cells' limit: tiny's seeded weights, judged as the share of
#: records off by 8 wire units or pixels (bf16 0.005-0.077 over 12 seeds
#: on the card against 0.23-0.37 for the int8 control; PERF.md §7)
LIMITS = {"off8_share": 0.13}


def small_cell(bench_dir, bench, name, traffic="batch", **mix):
    """Add a cell of YOLOv3-tiny (the configuration the benchmark keeps
    for these tests) with buckets (1, 2, 4) and a small pool, from new
    files only: a configuration, a mix and the cell's file."""
    import json

    with open(os.path.join(bench_dir, "configs", "yolov3-tiny-80.json")) as fp:
        cfg = json.load(fp)
    cfg["name"] = "tiny-test"
    cfg["buckets"] = [1, 2, 4]
    with open(os.path.join(bench_dir, "configs", "tiny-test.json"), "w") as fp:
        json.dump(cfg, fp)
    with open(os.path.join(bench_dir, "traffic", traffic + ".json")) as fp:
        m = json.load(fp)
    m.update({"pool": 8, "pool_workers": 2, "warm_frames": 4,
              "outstanding": 4}, **mix)
    with open(os.path.join(bench_dir, "traffic", "test-mix.json"), "w") as fp:
        json.dump(m, fp)
    with open(os.path.join(bench_dir, "cells", name + ".json"), "w") as fp:
        json.dump({"limits": LIMITS, **({"cameras": 2}
                                        if traffic == "stream" else {})}, fp)
    bench["configs"].append({"name": "tiny-test", "source": "test",
                             "file": os.path.join(bench_dir, "configs",
                                                  "tiny-test.json"),
                             "reduced": ["buckets"], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny-test",
                               "traffic": "test-mix", "chips": 1,
                               "why": "test"})
    # the test cell reports what the stream cell does; a closed-loop test
    # cell its own rate, frames_per_s, in place of stream_frames_per_s
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "full80.stream" in m.get("workloads", ()):
            m["workloads"].append(name)
    if traffic == "batch":
        rate = next(m for m in bench["end_to_end"]
                    if m["name"] == "stream_frames_per_s")
        rate["workloads"].remove(name)
        bench["end_to_end"].insert(0, {**rate, "name": "frames_per_s",
                                       "workloads": [name]})
        for m in bench["per_layer"]:
            if m["moves"] == "stream_frames_per_s" and name in m["workloads"]:
                m["moves"] = "frames_per_s"
    return bench
