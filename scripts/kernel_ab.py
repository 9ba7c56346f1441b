#!/usr/bin/env python3
"""Kernels B1 and D2 of two checkouts, timed on one card in turns.

    python3 scripts/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT

Each checkout runs in a child process of its own that imports that
checkout's ``fastdet_tpu_torch``, so its kernels are built from its own
sources into its own build directory; the children run in the order
old, new, new, old. A child takes the inputs and the timing of
``chip_smoke.py`` (this checkout's helpers): kernel B1 on the std tier's
rows of testdata/scene1-3.jpg with the DC column ([2]) and kernel D2 on
the debug tool's escape-free NB = 4096 rows ([6]), each at B = 1, 8 and
16, device ms from torch.profiler over 20 launches. The script prints
the card's ``nvidia-smi`` name and power limit, one JSON line per run
and, per kernel and batch, each checkout's mean and new / old. It exits
nonzero without a CUDA card or when a child fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 8, 16)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(checkout: str) -> dict:
    """Time B1 and D2 of ``checkout`` (first on sys.path)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    from fastdet_tpu_torch.ops import ingest_stages as st
    from fastdet_tpu_torch.ops import sparse_ingest as si
    from fastdet_tpu_torch.runtime import engine as eng_mod

    if not st.__file__.startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {st.__file__}, not {checkout}'s")
    cs = _smoke()
    dev = torch.device("cuda", 0)
    budgets = eng_mod.sparse_budgets()
    caps = eng_mod.sparse_caps(416, (2, 2), budgets["fmt"]["std"],
                               budgets["std"])
    fixtures = cs._fixture_bytes()
    frames = [cs._stage_row(fixtures[f"scene{i}.jpg"], caps)[0]
              for i in (1, 2, 3)]
    nb = 4096
    rows = st.build_case(np.random.RandomState(13), 16, nb, 0.0, 0.0,
                         MCAP=8 * nb, NCAPB=10 * nb)
    res = {"checkout": checkout, "B1": {}, "D2": {}}
    for b in BATCHES:
        args, dc = cs._b1_inputs(torch, [frames[i % 3] for i in range(b)],
                                 caps, dev)
        res["B1"][b] = cs._device_ms(
            torch, lambda: si.reconstruct(*args, dc=dc),
            "sparse_tile_kernel")
        plen, ms, _, nib = (torch.from_numpy(a[:b]).to(dev)
                            for a in rows[:4])
        s = st.prepare_streams(plen, ms, nib, nb)
        d2 = (s.ms32, s.vals32, s.moffx, s.probe, s.eoff1, s.bt)
        res["D2"][b] = cs._device_ms(torch, lambda: st.nat_gated(*d2),
                                     "nat_gated_kernel")
    return res


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    old, new = argv[1], argv[2]
    runs = []
    for checkout in (old, new, new, old):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", checkout], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for kernel in ("B1", "D2"):
        for b in map(str, BATCHES):
            t = {c: [r[kernel][b] for r in runs if r["checkout"] == c]
                 for c in (old, new)}
            if any(v is None for vals in t.values() for v in vals):
                print(f"{kernel} B={b}: not measured (no device time)")
                continue
            m_old, m_new = (sum(t[c]) / len(t[c]) for c in (old, new))
            print(f"{kernel} B={b}: old {t[old]} mean {m_old:.7f} ms, new "
                  f"{t[new]} mean {m_new:.7f} ms, new/old "
                  f"{m_new / m_old:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
