"""Sparse-coefficient statistics that size the wire format (host only).

    python -m fastdet_tpu_torch.tools.measure_sparse_stats

The port of the JAX package's ``tools/measure_sparse_stats.py``. Every
wire byte is host-to-card link time, so this tool decodes the bench
frames (``bench.make_jpegs(6)``) and the reference photos (``dog.jpg``,
``rsu1.jpg``, ``rsu2.jpg`` from the directory ``FASTDET_REFERENCE_TESTDATA``
names, where set) to coefficients and reports, per frame, the
distributions that decide a tighter format:

  - value magnitude histogram (|v|<=7 -> nibble-packable; |v|<=127 -> int8)
  - DC vs AC split: DC raw + DC raster-delta magnitudes per component
  - zigzag-position mass: do nonzeros concentrate in the low half?
  - projected bytes/frame for candidate formats vs the current one

Integer work on the host through the port's native decoder
(``runtime/native_jpeg``); no tensor touches the card. After the card
line its output equals the JAX tool's on the same frames, byte for byte.
``main(argv, device="cuda")`` resolves the device as every tool does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from fastdet_tpu_torch.runtime import native_jpeg

REFERENCE_PHOTOS = ("dog.jpg", "rsu1.jpg", "rsu2.jpg")
BENCH_FRAMES = 6

# zigzag order: ZZ[i] = natural-order position of the i-th zigzag coeff
ZZ = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
NAT2ZZ = np.argsort(ZZ)  # natural pos -> zigzag index


def frame_stats(data: bytes):
    w, h, hs, vs = native_jpeg.scan_layout(data)
    yb, cb = native_jpeg.sparse_geometry(w, h, hs, vs)
    nb = yb + 2 * cb
    ci = native_jpeg.decode_coefficients(data)  # format-independent
    dense = np.concatenate(
        [ci.ycoef, ci.cbcoef, ci.crcoef]).astype(np.int32)
    assert dense.shape == (nb, 64)
    nnz = int((dense != 0).sum())
    nesc = int((np.abs(dense) > 127).sum())

    dc = dense[:, 0]
    ac = dense.copy()
    ac[:, 0] = 0
    ac_nz = ac[ac != 0]
    dc_delta = np.concatenate([
        np.diff(dc[:yb], prepend=0),
        np.diff(dc[yb:yb + cb], prepend=0),
        np.diff(dc[yb + cb:], prepend=0),
    ])

    zz_idx = NAT2ZZ[None, :].repeat(nb, 0)  # zigzag index of each natural pos
    nz_zz = zz_idx[dense != 0]

    # mask-encoding candidates (masks stored in ZIGZAG bit order)
    zzmask = np.zeros((nb, 64), bool)
    rows, cols = np.nonzero(dense != 0)
    zzmask[rows, NAT2ZZ[cols]] = True
    # M1: 16-bit group-of-4 mask + one 4-bit submask per active group
    grp_active = zzmask.reshape(nb, 16, 4).any(axis=2)
    g_per_block = grp_active.sum(axis=1)  # active groups
    # M2: 1 prefix byte + ceil((last_zz+1)/8) zigzag mask bytes
    last_zz = np.where(zzmask.any(axis=1),
                       63 - np.argmax(zzmask[:, ::-1], axis=1), -1)
    maskbytes = np.ceil((last_zz + 1) / 8.0).astype(np.int64)

    stats = {
        "nb": nb, "nnz": int(nnz), "nesc": int(nesc),
        "nnz_per_block": nnz / nb,
        "ac_nnz_per_block": int((ac != 0).sum()) / nb,
        # value magnitude coverage
        "ac_le3": float((np.abs(ac_nz) <= 3).mean()) if ac_nz.size else 1.0,
        "ac_le7": float((np.abs(ac_nz) <= 7).mean()) if ac_nz.size else 1.0,
        "ac_le15": float((np.abs(ac_nz) <= 15).mean()) if ac_nz.size else 1.0,
        "ac_le31": float((np.abs(ac_nz) <= 31).mean()) if ac_nz.size else 1.0,
        "ac_le127": float((np.abs(ac_nz) <= 127).mean()) if ac_nz.size else 1.0,
        "dc_le7": float((np.abs(dc) <= 7).mean()),
        "dc_le127": float((np.abs(dc) <= 127).mean()),
        "dcd_le7": float((np.abs(dc_delta) <= 7).mean()),
        "dcd_le15": float((np.abs(dc_delta) <= 15).mean()),
        "dcd_le127": float((np.abs(dc_delta) <= 127).mean()),
        # zigzag concentration of nonzeros (incl. DC)
        "zz_ge16": float((nz_zz >= 16).mean()),
        "zz_ge32": float((nz_zz >= 32).mean()),
        "blocks_with_zz_ge32": float(((zz_idx >= 32) & (dense != 0))
                                     .any(axis=1).mean()),
        "blocks_with_zz_ge16": float(((zz_idx >= 16) & (dense != 0))
                                     .any(axis=1).mean()),
        # per-block escapes if AC values were nibbles (|v|>7 escapes)
        "ac_gt7_per_block": int((np.abs(ac) > 7).sum()) / nb,
        "esc_per_block_now": nesc / nb,
        # fine-grained magnitude coverage for sub-nibble value codes
        "ac_le1": float((np.abs(ac_nz) <= 1).mean()) if ac_nz.size else 1.0,
        "ac_le2": float((np.abs(ac_nz) <= 2).mean()) if ac_nz.size else 1.0,
        # high-zigzag band: are values there almost all +-1? (sign-bit code)
        "hi_frac_vals": float((nz_zz >= 16).mean()) if nz_zz.size else 0.0,
        "hi_gt1": float((np.abs(dense[(zz_idx >= 16) & (dense != 0)]) > 1)
                        .mean()) if ((zz_idx >= 16) & (dense != 0)).any()
        else 0.0,
        # dc nibble-delta escape rate (|delta|>7 -> int8 escape)
        "dcd_gt7": float((np.abs(dc_delta) > 7).mean()),
        "dcd_gt127": float((np.abs(dc_delta) > 127).mean()),
        # 3-bit AC escapes (|v|>3 -> int8 escape; |v|>127 -> int16)
        "ac_gt3_per_block": int((np.abs(ac) > 3).sum()) / nb,
        "ac_gt127_per_block": int((np.abs(ac) > 127).sum()) / nb,
        # mask-encoding candidates
        "m1_groups_mean": float(g_per_block.mean()),
        "m1_groups_p99": float(np.percentile(g_per_block, 99)),
        "m1_groups_max": int(g_per_block.max()),
        "m2_maskbytes_mean": float(maskbytes.mean()),
        "m2_maskbytes_p99": float(np.percentile(maskbytes, 99)),
        "m2_maskbytes_max": int(maskbytes.max()),
    }
    return stats


def fmt_bytes(stats):
    """Projected bytes/frame for candidate formats."""
    nb = stats["nb"]
    nnz_pb = stats["nnz_per_block"]

    def cap(x, align=128):
        return int(np.ceil(x / align) * align)

    # current: masks 8B/blk + int8 vals (budget 14.5) + int16 esc (0.3/blk) + q
    cur = nb * 8 + cap(nb * 14.5) + 2 * cap(max(1024, nb * 0.3), 64) + 384
    # A: nibble AC vals + int8 esc + separate int16 DC stream
    acpb = stats["ac_nnz_per_block"]
    esc_pb = stats["ac_gt7_per_block"]
    a = (nb * 8                              # masks unchanged
         + cap(nb * (acpb + 0.5)) // 2       # nibble stream (2/b)
         + cap(max(1024, nb * (esc_pb + 0.1)), 128)   # int8 escapes
         + nb * 2                            # DC int16 dense
         + 384)
    # B: half masks (low-32 zigzag) + exception masks for high blocks
    hi_frac = stats["blocks_with_zz_ge32"]
    b = (nb * 4 + nb // 8 + cap(nb * hi_frac) * 4
         + cap(nb * 14.5) + 2 * cap(max(1024, nb * 0.3), 64) + 384)
    # A+B combined
    ab = (nb * 4 + nb // 8 + cap(nb * hi_frac) * 4
          + cap(nb * (acpb + 0.5)) // 2
          + cap(max(1024, nb * (esc_pb + 0.1)), 128)
          + nb * 2 + 384)
    # M1: 2B group mask/blk + budgeted 4-bit submask stream (zigzag groups),
    # on top of the v4 value/escape/DC streams (sized as today's std tier)
    v4_streams = (cap(nb * 14) // 2          # nibble AC stream
                  + cap(max(512, nb * 0.4), 128)       # esc8
                  + 2 * cap(max(256, nb * 0.03), 128)  # esc16
                  + nb                                  # dc8
                  + cap(max(256, nb * 0.04), 128) * 2   # dc esc16
                  + 384)
    m1 = nb * 2 + cap(nb * (stats["m1_groups_mean"] + 0.5)) // 2 + v4_streams
    # M2: 1 prefix byte/blk + budgeted zigzag mask-byte stream
    m2 = nb + cap(nb * (stats["m2_maskbytes_mean"] + 0.3)) + v4_streams
    # v5 as actually shipped: 4-bit plen/blk + budgeted zigzag maskstream
    # (std-tier budgets: mask 5.0, AC 14 nibbles, esc8 0.4, esc16 0.03,
    # dcesc 0.04) + dc8 + 384B of q/header slack
    def v5_row(mask_b=5.0, ac_b=14.0, e8_b=0.4):
        return (cap(nb / 2, 64)                   # plen nibbles
                + cap(nb * mask_b)                # zigzag mask stream
                + cap(nb * ac_b / 2)              # AC nibble stream
                + cap(max(128, nb * e8_b))        # esc8
                + 2 * cap(max(64, nb * 0.03), 64)  # esc16
                + nb                              # dc8
                + 2 * cap(max(64, nb * 0.04), 64)  # dcesc16
                + 384)
    # v6a: AC values as 3-bit symbols (+-1..3, esc -> esc8 int8 ->
    # esc16); DC as 4-bit raster deltas (esc -> int8 -> int16); mask/plen
    # unchanged. Budgets set just above this frame's measured content.
    ac3_esc = stats["ac_gt3_per_block"]
    dcd_esc = stats["dcd_gt7"]
    v6a = (cap(nb / 2, 64)
           + cap(nb * (stats["m2_maskbytes_mean"] + 0.5))
           + cap(nb * (stats["ac_nnz_per_block"] + 0.6) * 3 / 8, 192)
           + cap(max(128, nb * (ac3_esc + 0.15)))
           + 2 * cap(max(64, nb * (stats["ac_gt127_per_block"] + 0.02), 64))
           + cap(nb / 2, 64)                      # dc4 nibbles
           + cap(max(128, nb * (dcd_esc + 0.05)))  # dc esc8
           + 2 * cap(max(64, nb * (stats["dcd_gt127"] + 0.02)), 64)
           + 384)
    # v6b: v6a + the zz>=16 value band carried as sign BITS (1/value,
    # |v|>1 there escapes to esc8); low band stays 3-bit
    hi_v = stats["hi_frac_vals"]
    lo_v = 1.0 - hi_v
    acpb_all = stats["ac_nnz_per_block"]
    v6b = (cap(nb / 2, 64)
           + cap(nb * (stats["m2_maskbytes_mean"] + 0.5))
           + cap(nb * (acpb_all * lo_v + 0.5) * 3 / 8, 192)
           + cap(nb * (acpb_all * hi_v + 0.4) / 8, 128)
           + cap(max(128, nb * (ac3_esc + acpb_all * hi_v
                                * stats["hi_gt1"] + 0.2)))
           + 2 * cap(max(64, nb * (stats["ac_gt127_per_block"] + 0.02), 64))
           + cap(nb / 2, 64)
           + cap(max(128, nb * (dcd_esc + 0.05)))
           + 2 * cap(max(64, nb * (stats["dcd_gt127"] + 0.02)), 64)
           + 384)
    return {"current": cur, "A_nibble+dc16": a, "B_halfmask": b, "A+B": ab,
            "v4_now": nb * 8 + v4_streams, "M1_groupmask": m1,
            "M2_prefixmask": m2, "v5_now": v5_row(), "v6a_3bit+dc4": v6a,
            "v6b_3bit+signband": v6b}


def frames():
    """(name, bytes) of the frames the tool measures: the bench frames,
    then the reference photos found under FASTDET_REFERENCE_TESTDATA."""
    from fastdet_tpu_torch.bench import make_jpegs

    out = [("bench%d" % i, d) for i, d in enumerate(make_jpegs(BENCH_FRAMES))]
    ref_dir = os.environ.get("FASTDET_REFERENCE_TESTDATA")
    for name in REFERENCE_PHOTOS:
        p = os.path.join(ref_dir, name) if ref_dir else None
        if p and os.path.exists(p):
            with open(p, "rb") as fp:
                out.append((name, fp.read()))
    return out


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    argparse.ArgumentParser(
        prog=argv[0] if argv else "measure_sparse_stats",
        description=__doc__.splitlines()[0]).parse_args(argv[1:])

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod

    print(bench.card_line(device_mod.resolve(device)))
    for name, data in frames():
        try:
            s = frame_stats(data)
        except Exception as e:  # noqa: BLE001  (the frame's row says why)
            print(f"{name}: skipped ({e})")
            continue
        b = fmt_bytes(s)
        print(f"== {name}: nb={s['nb']} nnz/b={s['nnz_per_block']:.2f} "
              f"ac/b={s['ac_nnz_per_block']:.2f} esc/b={s['esc_per_block_now']:.3f}")
        print(f"   AC |v|<=3/7/15/31/127: {s['ac_le3']:.3f}/{s['ac_le7']:.3f}/"
              f"{s['ac_le15']:.3f}/{s['ac_le31']:.3f}/{s['ac_le127']:.4f}")
        print(f"   DC |v|<=7: {s['dc_le7']:.3f} <=127: {s['dc_le127']:.3f}; "
              f"DC-delta <=7/15/127: {s['dcd_le7']:.3f}/{s['dcd_le15']:.3f}/"
              f"{s['dcd_le127']:.3f}")
        print(f"   zz>=16 mass {s['zz_ge16']:.3f} zz>=32 mass {s['zz_ge32']:.4f}; "
              f"blocks w/ zz>=32: {s['blocks_with_zz_ge32']:.3f} "
              f"zz>=16: {s['blocks_with_zz_ge16']:.3f}; "
              f"AC|v|>7 per blk {s['ac_gt7_per_block']:.2f}")
        print(f"   mask cands: M1 groups mean/p99/max "
              f"{s['m1_groups_mean']:.2f}/{s['m1_groups_p99']:.0f}/"
              f"{s['m1_groups_max']}; M2 maskbytes mean/p99/max "
              f"{s['m2_maskbytes_mean']:.2f}/{s['m2_maskbytes_p99']:.0f}/"
              f"{s['m2_maskbytes_max']}")
        print(f"   AC |v|<=1/2: {s['ac_le1']:.3f}/{s['ac_le2']:.3f}; "
              f"zz>=16 val frac {s['hi_frac_vals']:.3f} (|v|>1 there: "
              f"{s['hi_gt1']:.3f}); AC|v|>3 per blk "
              f"{s['ac_gt3_per_block']:.2f}; DC-delta>7 {s['dcd_gt7']:.3f}")
        print("   bytes/frame: " + "  ".join(
            f"{k}={v / 1024:.1f}K" for k, v in b.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
