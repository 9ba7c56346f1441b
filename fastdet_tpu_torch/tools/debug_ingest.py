"""Kernel B1's stages one by one on the card: kernels D1 and D2.

    python -m fastdet_tpu_torch.tools.debug_ingest

The port's counterpart of the JAX package's tools/debug_kernel_tpu.py.
For each case below it runs kernel D1 (every stage of B1 written out)
and kernel D2 (``nat`` through the tile structure, escape-gated) and
holds each output against its plain PyTorch version
(ops/ingest_stages.py), printing one line per stage::

    mwin: OK
    ...
    nat2[full]: FAIL 3 mismatches, first (0, 5, 17): got 2 want -1

On escape-free cases it also holds D1's ``nat`` against kernel B1's AC
coefficients of the same rows (``nat==B1``), and it checks that each case
reaches the route it is there for. It runs on the card (it raises
without one) and exits 1 on any FAIL.

Cases (B=2 frames of NB=64 blocks, ``RandomState(13)``):

- ``tool``: the JAX tool's own case (no escapes);
- ``escapes``: level-1 and level-2 escapes, so D2's escape gate fires;
- ``dense span``: 40-63 values per block, so every tile's value span
  exceeds bt*32 and D2 reads per-block windows instead of its segment.

:func:`mixed_rows` builds frames whose tool tiles take in turn the
routes and gates of these cases (:data:`MIXED`), for D2's tests.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from fastdet_tpu_torch import device as device_mod
from fastdet_tpu_torch.ops import ingest_stages as st
from fastdet_tpu_torch.ops import sparse_ingest as si

CASES = {
    "tool": dict(esc1_p=0.0, esc2_p=0.0),
    "escapes": dict(esc1_p=0.25, esc2_p=0.05),
    "dense span": dict(esc1_p=0.0, esc2_p=0.0, min_nnz=40, max_nnz=63,
                       NCAPB=2048),
}

#: the tool tiles of mixed_rows' frames, in turn: fast route without and
#: with escapes, dense route without and with escapes
MIXED = (
    dict(esc1_p=0.0, esc2_p=0.0),
    dict(esc1_p=0.25, esc2_p=0.05),
    dict(esc1_p=0.0, esc2_p=0.0, min_nnz=40, max_nnz=63),
    dict(esc1_p=0.25, esc2_p=0.05, min_nnz=40, max_nnz=63),
)


def mixed_rows(rng, B: int, NB: int):
    """(plen, maskstream, nib) v5 rows of B frames of NB blocks whose tool
    tiles (st.pick_bt(NB) blocks) are st.build_case tiles of the kinds of
    :data:`MIXED`, tile t of frame b of kind (b + t) % 4: in one frame
    and one batch, tiles of both of D2's routes, with and without
    escapes. Capacities: 8 mask bytes and 64 values per block."""
    bt = st.pick_bt(NB)
    if NB % bt or bt % 2:
        raise ValueError(f"mixed_rows: NB={NB} is not a multiple of an "
                         f"even tile")
    plen = np.zeros((B, NB // 2), np.uint8)
    ms = np.zeros((B, 8 * NB), np.uint8)
    nib = np.zeros((B, 32 * NB), np.uint8)
    for b in range(B):
        masks, vals = [], []
        for t in range(NB // bt):
            kw = MIXED[(b + t) % len(MIXED)]
            p, m, _, n, *_ = st.build_case(rng, 1, bt, MCAP=8 * bt,
                                           NCAPB=32 * bt, **kw)
            lens = np.stack([p[0] & 15, p[0] >> 4], -1).reshape(-1)
            mask = m[0, :int(lens.sum())]
            nvals = int(np.unpackbits(mask).sum())
            v = np.stack([n[0] & 15, n[0] >> 4], -1).reshape(-1)[:nvals]
            plen[b, t * bt // 2:(t + 1) * bt // 2] = p[0]
            masks.append(mask)
            vals.append(v)
        mask, v = np.concatenate(masks), np.concatenate(vals)
        ms[b, :len(mask)] = mask
        v = np.concatenate([v, np.zeros(len(v) % 2, np.uint8)])
        nib[b, :len(v) // 2] = v[0::2] | (v[1::2] << 4)
    return plen, ms, nib


def compare(name: str, got: torch.Tensor, want: torch.Tensor):
    """(line, max |got - want|) for one stage."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        return f"{name}: FAIL shape {g.shape} vs {w.shape}", -1
    bad = np.argwhere(g != w)
    if not len(bad):
        return f"{name}: OK", 0
    i = tuple(int(v) for v in bad[0])
    worst = int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())
    return (f"{name}: FAIL {len(bad)} mismatches, first {i}: got {g[i]} "
            f"want {w[i]}"), worst


def run_case(label: str, dev: torch.device, B: int = 2, NB: int = 64,
             seed: int = 13, prefix: str = "") -> Dict[str, object]:
    """Run one case of :data:`CASES` on ``dev``; prints its lines and
    returns {"ok", "max_abs_err"} (-1: a stage had the wrong shape or the
    case missed its route)."""
    kw = CASES[label]
    rows = st.build_case(np.random.RandomState(seed), B, NB, **kw)
    plen, ms, dc8, nib, esc8, esc16, dcesc = (torch.from_numpy(a).to(dev)
                                              for a in rows)
    s = st.prepare_streams(plen, ms, nib, NB)
    args = (s.ms32, s.vals32, s.moffx, s.probe)
    got = st.stages(*args, s.bt)
    want = st.stages_plain(*args, s.bt)
    checks = [compare(name, g, w)
              for name, g, w in zip(st.Stages._fields, got, want)]
    checks.append(compare("nat2[full]",
                          st.nat_gated(*args, s.eoff1, s.bt),
                          st.nat_gated_plain(*args, s.eoff1, s.bt)))
    # which routes the case reaches: D2's dense route, its escape gate
    bt, t2 = s.bt, s.bt * 32
    p = s.probe.to(torch.int64)
    e = s.eoff1.to(torch.int64)
    dense = int(((p[:, bt::bt] - p[:, 0:NB:bt]) > t2).sum())
    gated = int(((e[:, bt::bt] - e[:, 0:NB:bt]) > 0).sum())
    tiles = B * (NB // bt)
    if kw["esc1_p"] == 0.0 and kw["esc2_p"] == 0.0:
        offs = si.stream_offsets(plen, ms, s.vals, esc8, NB, -8)
        b1 = si.reconstruct(offs, ms, s.vals, esc8, esc16, -8)
        checks.append(compare("nat==B1", got.nat, b1))
    if label == "escapes" and not gated:
        checks.append(("escape gate: FAIL no tile has escapes", -1))
    if label == "dense span" and not dense:
        checks.append(("dense route: FAIL no tile spans more than bt*32",
                       -1))
    print(f"{prefix}case {label!r}: B={B} NB={NB} bt={bt}, {dense} of "
          f"{tiles} tiles on D2's dense route, {gated} escape-gated",
          flush=True)
    for line, _ in checks:
        print(f"{prefix}  {line}", flush=True)
    worst = [d for _, d in checks]
    return {"ok": all(d == 0 for d in worst),
            "max_abs_err": max(worst) if min(worst) >= 0 else -1}


def run(dev: torch.device, prefix: str = "") -> List[Dict[str, object]]:
    """Every case of :data:`CASES` on ``dev``."""
    return [dict(case=label, **run_case(label, dev, prefix=prefix))
            for label in CASES]


def main(argv) -> int:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    dev = device_mod.resolve("cuda")
    with torch.inference_mode():
        results = run(dev)
    ok = all(r["ok"] for r in results)
    print("all stages OK" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
