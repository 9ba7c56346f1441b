"""One run of one cell, driven by the files that name it.

``BENCHMARK.json`` lists the cells; everything that belongs to one is
found by name under the benchmark's directory:

- ``configs/<config>.json`` (the file ``configs`` names): the model;
- ``traffic/<traffic>.json``: the mix, read by the generator its
  ``kind`` names (``generators/<kind>.py``);
- ``cells/<cell>.json`` (optional): the cell's own parameters of the mix
  (such as ``cameras``) and its ``limits`` for ``correct``;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, of
  one metric (None: nothing to read in this run; the metric is left out).

A run: weights and the frame pool from the seed, the engine built and
warmed on one device, the generator's window, then (the program's state
freed) the reference over every distinct frame answered and the
comparison (:mod:`benchmark.correctness`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from benchmark import correctness, flops, hostload, scenes, stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "fastdet_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def applies(metric: dict, cell: str, e2e_of_cell=None) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none (and, for a per-layer metric, the
    cell reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric["moves"] in e2e_of_cell


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m, cell, names)]


def load_reader(bench_dir: str, name: str) -> Callable:
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_generator(bench_dir: str, kind: str):
    path = os.path.join(bench_dir, "generators", kind + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_generator_" + kind, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: Dict[str, float]


def resolve(bench: dict, bench_dir: str, root: str, name: str) -> Cell:
    """The cell ``name`` with its configuration, mix and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    mix = load_json(os.path.join(bench_dir, "traffic",
                                 w["traffic"] + ".json"))
    own = os.path.join(bench_dir, "cells", name + ".json")
    extra = load_json(own) if os.path.exists(own) else {}
    limits = extra.pop("limits", {})
    return Cell(name, cfg, {**mix, **extra}, limits)


def process_start() -> float:
    """``time.monotonic()`` of this process's start (from /proc)."""
    with open("/proc/self/stat") as fp:
        fields = fp.read().rsplit(")", 1)[1].split()
    age = (time.clock_gettime(time.CLOCK_BOOTTIME)
           - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    return time.monotonic() - age


def card_line() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() \
            else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e!r})"


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


@dataclass
class Context:
    """What a generator and a metric reader see of a run."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    root: str
    bench_dir: str
    jpegs: List[bytes] = field(default_factory=list)
    svc: object = None
    engine: object = None
    t_start: float = 0.0
    setup_s: Optional[float] = None
    window: object = None
    trace_profiler: object = None
    host_at: dict = field(default_factory=dict)   # hostload snapshots

    @property
    def trace_seconds(self) -> float:
        return min(float(self.mix["trace_seconds"]), self.seconds)

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def start_trace(self):
        if not self.trace:
            return None
        from benchmark.tracing import Profiler

        return Profiler(self.cuda)

    def mark_setup_end(self, t0: float) -> None:
        self.setup_s = t0 - self.t_start
        self.host_at["t0"] = hostload.snapshot()

    def mark_window_end(self) -> None:
        self.host_at["t1"] = hostload.snapshot()

    def flops_per_frame(self) -> int:
        return flops.flops_per_frame(self.cfg)


def prepare(ctx: Context, mode: Optional[str] = None):
    """The run's set-up before its traffic: the frame pool, the weights
    and the warmed engine into ``ctx``; returns the weights the
    benchmark made (None for a checkpoint the program reads)."""
    import torch

    from benchmark import program
    from benchmark.seeded import calibrate, decoded, seeded_weights

    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    os.environ["FASTDET_WARM_LAYOUTS"] = str(mix["warm_layouts"])
    pool_wait = scenes.make_pool(ctx.seed, mix, int(cfg["width"]),
                                 workers=int(mix["pool_workers"]))
    if ctx.cuda:
        log("card: " + card_line())
        torch.cuda.reset_peak_memory_stats()
    phases = {"start": time.monotonic() - ctx.t_start}
    weights = (seeded_weights(cfg, ctx.seed, device)
               if cfg["weights"]["kind"] == "seeded" else None)
    # frames are needed before the engine only to set seeded weights or
    # to calibrate int8; otherwise the pool renders while the engine
    # loads and warms
    if weights is not None or mode == "int8":
        ctx.jpegs = pool_wait()
        phases["pool"] = time.monotonic() - ctx.t_start
    if weights is not None:
        n = int(cfg["weights"]["calibration_frames"])
        bias = calibrate(cfg, weights, decoded(ctx.jpegs[:n]),
                         float(mix["threshold"]), device)
        log(f"seeded weights: objectness bias {bias!r}")
    calib = decoded(ctx.jpegs[:8]) if mode == "int8" else None
    ctx.engine = program.build_engine(cfg, weights, device, ctx.root, mode,
                                      calib)
    phases["engine"] = time.monotonic() - ctx.t_start
    if not ctx.jpegs:
        ctx.jpegs = pool_wait()
        phases["pool"] = time.monotonic() - ctx.t_start
    log(f"engine: {cfg['name']} mode {mode or cfg['mode']} buckets "
        f"{cfg['buckets']} on {device}; set-up seconds since the process "
        f"began, at the end of each phase: " + json.dumps(
            {k: round(v, 3) for k, v in phases.items()}))
    return weights


def run_cell(bench: dict, bench_dir: str, root: str, cell_name: str,
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             mode: Optional[str] = None,
             on_engine: Optional[Callable] = None):
    """One run of ``cell_name``; returns the result line's object and
    every number of the comparison (:func:`correctness.compare`).

    ``mode`` overrides the configuration's precision (the control);
    ``on_engine(engine)`` sees the engine before the window (tests use it
    to break the timed path)."""
    import torch

    from benchmark import program

    cell = resolve(bench, bench_dir, root, cell_name)
    cfg, mix = cell.cfg, cell.mix
    ctx = Context(cell_name, cfg, mix, seed, float(seconds), trace, device,
                  root, bench_dir, t_start=process_start())
    hostload.watch_gc()
    weights = prepare(ctx, mode)
    if on_engine is not None:
        on_engine(ctx.engine)
    ctx.svc = program.service(ctx.engine)
    gen = load_generator(bench_dir, mix["kind"])
    win = gen.run(ctx)
    ctx.window = win

    # the window has closed: counts, then the program's state goes
    memory_peak = (torch.cuda.max_memory_allocated(torch.device(device))
                   if ctx.cuda else 0)
    ok = [f for f in win.frames if win.ok(f)]
    failed = len(win.frames) - len(ok)
    log(f"window: {win.seconds:.3f} s, {len(win.frames)} frames attempted, "
        f"{len(ok)} answered in time ({win.answered_in_window()} inside the "
        f"window), {failed} failed; setup {ctx.setup_s:.3f} s")
    log(hostload.report(ctx.host_at.get("t0", {}),
                        ctx.host_at.get("t1", {})))
    log("answered in each second of the window: " + json.dumps(
        hostload.per_second(win.t0, win.t1, [f.answered for f in ok])))
    late = [(f.sent - f.due) * 1e3 for f in win.frames]
    if mix["kind"] == "open_loop_udp":
        log(f"generator lateness (sent - due): p50 "
            f"{stats.percentile(late, 50):.3f} ms, p95 "
            f"{stats.percentile(late, 95):.3f} ms, max {max(late):.3f} ms "
            f"over {len(late)} frames; latency samples {len(win.frames)}")
    dh = {k: win.after["batch_hist"].get(k, 0) - win.before["batch_hist"]
          .get(k, 0) for k in win.after["batch_hist"]}
    log("program: batches by size " + json.dumps(
        {k: v for k, v in sorted(dh.items()) if v}) + ", ingest "
        + json.dumps({k: v - win.before["ingest"].get(k, 0)
                      for k, v in win.after["ingest"].items()})
        + f", B1 launches {win.after['b1_launches'] - win.before['b1_launches']}"
        + f", B2 launches {win.after['b2_launches'] - win.before['b2_launches']}")
    if ctx.cuda:
        log("card after the window: " + card_line())

    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = load_reader(bench_dir, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if ctx.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(torch.device(device))
                            if ctx.cuda else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace and win.trace is not None:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
        breakdown = {"device_ops": win.trace.device_ops(),
                     "idle_gaps": win.trace.idle_gaps()}

    ctx.engine.close()
    ctx.svc = ctx.engine = None
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    if cfg["weights"]["kind"] == "checkpoint":
        from benchmark.reference.darknet import load_npz

        weights = load_npz(os.path.join(root, cfg["weights"]["file"]))
    t_ref = time.monotonic()
    refs = correctness.reference_for(cfg, weights, ctx.jpegs,
                                     [f.slot for f in ok],
                                     float(mix["threshold"]), device)
    numbers = correctness.compare([(f.slot, f.blob) for f in ok], refs,
                                  float(mix["threshold"]))
    correct, checks = correctness.verdict(numbers, cell.limits)
    correct = (correct and bool(cell.limits)
               and numbers["pairs"] + numbers["unpaired"] > 0)
    log(f"reference: {len(refs)} distinct frames in "
        f"{time.monotonic() - t_ref:.3f} s; compared: "
        + json.dumps(numbers))

    result = {"correct": correct, "attempted": len(win.frames),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks if checks else {
        k: {"value": numbers[k], "limit": None}
        for k in numbers if k.startswith("off")}
    return result, numbers
