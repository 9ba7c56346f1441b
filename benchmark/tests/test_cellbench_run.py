"""A run of a cell on the CPU (the harness's look for a card skipped):
the harness finds new files by name alone, the result line has its
shape, and a broken timed path comes out not correct."""

import json
import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, small_cell


def _run(bench_dir, bench, name, seconds=2.0, trace=False, on_engine=None):
    return harness.run_cell(bench, bench_dir, ROOT, name, 2 ** 31 + 99,
                            seconds, trace, device="cpu",
                            on_engine=on_engine)


def test_new_files_are_found_by_name(bench_copy):
    bench_dir, bench = bench_copy
    bench = small_cell(bench_dir, bench, "tinytest.batch")
    with open(os.path.join(bench_dir, "metrics", "answered.count.py"),
              "w") as fp:
        fp.write("def read(run):\n"
                 "    return run.window.answered_in_window()\n")
    bench["per_layer"].append({
        "name": "answered.count", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "batcher", "moves": "frames_per_s",
        "workloads": ["tinytest.batch"]})
    cell = harness.resolve(bench, bench_dir, ROOT, "tinytest.batch")
    assert cell.cfg["name"] == "tiny-test" and cell.mix["pool"] == 8
    names = [m["name"] for m in harness.cell_metrics(bench, "tinytest.batch",
                                                     True)]
    assert "answered.count" in names
    assert "b1_roofline.stream" in names
    assert "latency_p95_ms" not in [m["name"] for m in harness.cell_metrics(
        bench, "tinytest.batch", False)]
    result, numbers = _run(bench_dir, bench, "tinytest.batch", trace=True)
    assert result["metrics"]["answered.count"]["value"] > 0
    assert numbers["pairs"] > 0


def test_result_line_shape_from_a_dry_run(bench_copy):
    bench_dir, bench = bench_copy
    bench = small_cell(bench_dir, bench, "tinytest.batch")
    result, numbers = _run(bench_dir, bench, "tinytest.batch")
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["attempted"] >= line["failed"] >= 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True
    assert numbers["frames"] == line["attempted"] - line["failed"]


def test_stream_dry_run_reports_tails(bench_copy):
    bench_dir, bench = bench_copy
    bench = small_cell(bench_dir, bench, "tinytest.stream",
                       traffic="stream", fps_per_camera=3)
    result, numbers = _run(bench_dir, bench, "tinytest.stream", seconds=3.0)
    assert {"stream_frames_per_s", "setup_s"} == set(result["metrics"])
    assert result["failed"] == 0 and result["correct"] is True
    traced, _ = _run(bench_dir, bench, "tinytest.stream", seconds=3.0,
                     trace=True)
    assert {"latency_p50_ms", "latency_p95_ms", "sessions.outside_ms.p95",
            "service.request_ms.p95", "batcher.mean_batch.stream"} <= set(
        traced["metrics"])
    assert traced["metrics"]["latency_p95_ms"]["value"] >= \
        traced["metrics"]["latency_p50_ms"]["value"]


def _alter_answers(engine):
    """Break the timed path where answers are produced: every record's
    box moves 24 px right."""
    fetch = engine.fetch_wire

    def altered(res, n):
        out = []
        for blob in fetch(res, n):
            a = np.frombuffer(blob, np.uint8).copy().reshape(-1, 10)
            x = a[:, 2].astype(np.int32) * 256 + a[:, 3] + 24
            a[:, 2], a[:, 3] = x // 256, x % 256
            out.append(a.tobytes())
        return out
    engine.fetch_wire = altered


def _drop_best(engine):
    """Answers that leave out their first record, the most confident."""
    fetch = engine.fetch_wire
    engine.fetch_wire = lambda res, n: [b[10:] for b in fetch(res, n)]


@pytest.mark.parametrize("traffic", ["batch", "stream"])
@pytest.mark.parametrize("fault", [_alter_answers, _drop_best],
                         ids=["answer-altered", "best-record-dropped"])
def test_a_broken_timed_path_is_not_correct(bench_copy, fault, traffic):
    bench_dir, bench = bench_copy
    name = "tinytest." + traffic
    extra = {"fps_per_camera": 3} if traffic == "stream" else {}
    bench = small_cell(bench_dir, bench, name, traffic=traffic, **extra)
    result, numbers = _run(bench_dir, bench, name, seconds=3.0,
                           on_engine=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
