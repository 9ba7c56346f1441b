"""Bisect a divergence of kernel B1 from its reference by case class.

    python -m fastdet_tpu_torch.tools.bisect_kernel

The port of the JAX package's ``tools/bisect_kernel_tpu.py``. Five
classes of random v5 rows (:data:`CASES`, built by :func:`build_case`
from seed 13 at the same shapes): no escapes with few or up to 19
nonzeros a block, level-1 escapes only, both escape levels, and dense
blocks of up to 40 nonzeros. Each class runs through B1
(``ops/sparse_ingest.sparse5_to_coeffs_batch`` on the card) and through
the plain torch reconstruction ``ops/jpeg_device.sparse5_to_coeffs`` on
the CPU; the tool prints ``<class>: OK`` or where they differ. Returns 0
when every class agrees, else 1. ``main(argv, device="cuda")``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

B, NB, YB, CB = 2, 64, 32, 16
SEED = 13

CASES = (
    ("no-esc small-nnz", dict(esc1_p=0.0, esc2_p=0.0, max_nnz=8)),
    ("no-esc", dict(esc1_p=0.0, esc2_p=0.0)),
    ("esc8-only", dict(esc1_p=0.25, esc2_p=0.0)),
    ("esc16-small", dict(esc1_p=0.25, esc2_p=0.08)),
    ("dense nnz", dict(esc1_p=0.25, esc2_p=0.08, max_nnz=40,
                       NCAPB=2048)),
)


def build_case(rng, B, NB, esc1_p, esc2_p, max_nnz=19,
               MCAP=512, NCAPB=640, E8CAP=512, E16CAP=256, DCECAP=256):
    """Random v5 streams of one case class: per block a random int8 DC
    delta and up to ``max_nnz`` zigzag nonzeros, each a level-2 escape
    (int16, |v| 300-31999) with probability ``esc2_p``, else a level-1
    escape (int8) up to ``esc1_p``, else a nibble. The JAX tool's
    function: the same draws from ``rng`` give the same arrays."""
    plen = np.zeros((B, (NB + 1) // 2), np.uint8)
    ms = np.zeros((B, MCAP), np.uint8)
    nib = np.zeros((B, NCAPB), np.uint8)
    esc8 = np.zeros((B, E8CAP), np.int8)
    esc16 = np.zeros((B, E16CAP), np.int16)
    dc8 = np.zeros((B, NB), np.int8)
    dcesc = np.zeros((B, DCECAP), np.int16)
    for b in range(B):
        nac = ne8 = ne16 = nmask = 0
        for n in range(NB):
            dc8[b, n] = rng.randint(-127, 128)
            nnz = rng.randint(0, max_nnz + 1)
            zzmask = 0
            zzs = np.sort(rng.choice(63, nnz, replace=False) + 1)
            for j in zzs:
                zzmask |= 1 << int(j)
                r = rng.rand()
                if r < esc2_p and ne16 < E16CAP and ne8 < E8CAP:
                    v = -8
                    esc8[b, ne8] = -128
                    ne8 += 1
                    esc16[b, ne16] = (rng.randint(300, 32000)
                                      * rng.choice([-1, 1]))
                    ne16 += 1
                elif r < esc1_p and ne8 < E8CAP:
                    v = -8
                    esc8[b, ne8] = rng.randint(8, 128) * rng.choice([-1, 1])
                    ne8 += 1
                else:
                    v = rng.randint(-7, 8)
                n4 = v & 0xF
                if nac & 1:
                    nib[b, nac >> 1] |= n4 << 4
                else:
                    nib[b, nac >> 1] = n4
                nac += 1
            pl = (int(zzmask).bit_length() + 7) // 8
            if n & 1:
                plen[b, n >> 1] |= pl << 4
            else:
                plen[b, n >> 1] = pl
            mb = int(zzmask).to_bytes(8, "little")[:pl]
            ms[b, nmask:nmask + pl] = np.frombuffer(mb, np.uint8)
            nmask += pl
    return plen, ms, dc8, nib, esc8, esc16, dcesc


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    argparse.ArgumentParser(
        prog=argv[0] if argv else "bisect_kernel",
        description=__doc__.splitlines()[0]).parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.tools.verify_kernel import kernel, reference

    dev = device_mod.resolve(device)
    device_mod.strict_fp32()
    print(bench.card_line(dev))
    print("devices:", [str(dev)])

    failed = 0
    for name, kw in CASES:
        kw = dict(kw)
        rng = np.random.RandomState(SEED)
        ncapb = kw.pop("NCAPB", 640)
        arrs = build_case(rng, B, NB, NCAPB=ncapb, **kw)
        ref = reference(arrs, YB, CB)
        got = kernel(arrs, YB, CB, dev)
        if np.array_equal(got, ref):
            print(f"{name}: OK")
            continue
        failed += 1
        bad = np.argwhere(got != ref)
        i, b, p = bad[0]
        blocks = sorted(set(map(tuple, bad[:, :2].tolist())))
        print(f"{name}: FAIL {len(bad)} mismatches over "
              f"{len(blocks)} blocks; first at {i},{b},{p}: "
              f"got {got[i, b, p]} want {ref[i, b, p]}; "
              f"sample blocks {blocks[:6]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
