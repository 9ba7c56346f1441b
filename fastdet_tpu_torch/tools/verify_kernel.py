"""Card parity check for kernel B1 (the sparse-ingest reconstruction).

    python -m fastdet_tpu_torch.tools.verify_kernel

The port of the JAX package's ``tools/verify_kernel_tpu.py``. The CPU
tests run B1's plain version; only a run on the card builds and launches
the CUDA kernel (``ops/sparse_ingest.sparse5_to_coeffs_batch`` on CUDA
tensors). This tool holds it, bit for bit, against the plain torch
reconstruction ``ops/jpeg_device.sparse5_to_coeffs`` on the CPU, on:

1. a random v5 case (:func:`random_v5_case`, seed 7) whose int16 escapes
   are pushed to |v| of 31000-31999: a product in reduced precision
   (TF32 on this card, bf16 on the TPU) rounds integers above 256
   (31303 -> 31296), so any such product on the path shows here. The
   tool turns TF32 off first (``device.strict_fp32``), as every engine
   does, and prints how many coefficients have |v| > 256;
2. a camera scene (testdata/scene1.jpg re-encoded at quality 95) through
   the batched entry point.

Exit codes: 0 = parity, 1 = mismatch, 2 = no CUDA card (the JAX tool's
"no TPU"). ``main(argv, device="cuda")``; the CPU tests pass
``device="cpu"``, where the wrapper takes its plain version.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SEED = 7
B, NB = 2, 64
YB, CB = 32, 16


def random_v5_case(rng, B, NB, MCAP, NCAPB, E8CAP, E16CAP, DCECAP):
    """Randomized v5 streams with both escape levels, DC escapes, empty
    blocks, variable mask prefixes and stream-end windows (NB must split
    Y/Cb/Cr: NB = 4k). Mask bits and value order are zigzag (the v5 wire
    order). A copy of the JAX package's test helper
    (tests/test_sparse_path.py ``_random_v5_case``): the same draws from
    ``rng`` give the same arrays."""
    plen = np.zeros((B, (NB + 1) // 2), np.uint8)
    ms = np.zeros((B, MCAP), np.uint8)
    nib = np.zeros((B, NCAPB), np.uint8)
    esc8 = np.zeros((B, E8CAP), np.int8)
    esc16 = np.zeros((B, E16CAP), np.int16)
    dc8 = np.zeros((B, NB), np.int8)
    dcesc = np.zeros((B, DCECAP), np.int16)
    for b in range(B):
        nac = ne8 = ne16 = ndce = nmask = 0
        for n in range(NB):
            # DC delta, escaping ~10% of the time
            if rng.rand() < 0.1 and ndce < DCECAP:
                dc8[b, n] = -128
                dcesc[b, ndce] = rng.randint(128, 2000) * rng.choice([-1, 1])
                ndce += 1
            else:
                dc8[b, n] = rng.randint(-127, 128)
            nnz = rng.randint(0, 20)
            # zigzag indices 1..63 (DC bit always clear on the wire)
            zzmask = 0
            zzs = np.sort(rng.choice(63, nnz, replace=False) + 1)
            for j in zzs:
                zzmask |= 1 << int(j)
                r = rng.rand()
                if r < 0.08 and ne16 < E16CAP and ne8 < E8CAP:
                    v = -8  # level-2 escape
                    esc8[b, ne8] = -128
                    ne8 += 1
                    esc16[b, ne16] = (rng.randint(128, 1000)
                                      * rng.choice([-1, 1]))
                    ne16 += 1
                elif r < 0.25 and ne8 < E8CAP:
                    v = -8  # level-1 escape
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


def scene(idx: int, quality: int = 90, subsampling: int = 2) -> bytes:
    """A camera-clean frame: testdata/scene{1 + idx % 3}.jpg re-encoded
    at ``quality`` (the JAX test helper ``_scene``, with PIL). Without
    PIL the frame is decoded and encoded by ``runtime/jpeg`` (OpenCV,
    4:2:0) instead."""
    path = os.path.join(REPO, "testdata", f"scene{1 + idx % 3}.jpg")
    with open(path, "rb") as fp:
        data = fp.read()
    try:
        from PIL import Image
    except ImportError:
        from fastdet_tpu_torch.runtime import jpeg

        return jpeg.encode_rgb(jpeg.decode_rgb(data), quality)
    img = Image.open(io.BytesIO(data)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


class SparseFrame:
    """One frame decoded to v5 streams with roomy scratch capacities (the
    JAX test helper of that name, without its device methods)."""

    def __init__(self, native, data):
        self.w, self.h, self.hs, self.vs = native.scan_layout(data)
        self.yb, self.cb = native.sparse_geometry(
            self.w, self.h, self.hs, self.vs)
        nb = self.nb = self.yb + 2 * self.cb
        self.plen = np.zeros((nb + 1) // 2, np.uint8)
        self.maskstream = np.zeros(nb * 8, np.uint8)
        self.dc8 = np.zeros(nb, np.int8)
        self.nib = np.zeros(nb * 40, np.uint8)
        self.esc8 = np.zeros(nb * 33, np.int8)
        self.esc16 = np.zeros(nb * 17, np.int16)
        self.dcesc = np.zeros(nb * 2, np.int16)
        self.counts, self.qy, self.qcb, self.qcr = native.decode_sparse5_into(
            data, self.plen, self.maskstream, self.dc8, self.nib,
            self.esc8, self.esc16, self.dcesc)

    def streams(self):
        return (self.plen, self.maskstream, self.dc8, self.nib, self.esc8,
                self.esc16, self.dcesc)


def extreme_case():
    """The randomized v5 case of the check: seed :data:`SEED`, (B, NB) =
    (2, 64), its nonzero int16 escapes moved to sign(v) * (|v| % 1000 +
    31000)."""
    rng = np.random.RandomState(SEED)
    plen, ms, dc8, nib, esc8, esc16, dcesc = random_v5_case(
        rng, B, NB, MCAP=512, NCAPB=640, E8CAP=512, E16CAP=256, DCECAP=256)
    nz = esc16 != 0
    esc16 = np.where(nz, (np.sign(esc16) * (np.abs(esc16) % 1000 + 31000))
                     .astype(np.int16), esc16).astype(np.int16)
    return plen, ms, dc8, nib, esc8, esc16, dcesc


def reference(streams, yb: int, cb: int) -> np.ndarray:
    """``jpeg_device.sparse5_to_coeffs`` of batched v5 streams on the
    CPU: (B, NB, 64) int32."""
    import torch

    from fastdet_tpu_torch.ops import jpeg_device

    plen, ms, dc8, nib, esc8, esc16, dcesc = [torch.from_numpy(a)
                                              for a in streams]
    return jpeg_device.sparse5_to_coeffs(
        plen, ms, dc8, jpeg_device.unpack_nibbles(nib), esc8, esc16, dcesc,
        yb, cb).numpy()


def kernel(streams, yb: int, cb: int, dev) -> np.ndarray:
    """``sparse_ingest.sparse5_to_coeffs_batch`` of the streams moved to
    ``dev`` (B1 on a CUDA device, its plain version on the CPU)."""
    import torch

    from fastdet_tpu_torch.ops import sparse_ingest

    with torch.inference_mode():
        out = sparse_ingest.sparse5_to_coeffs_batch(
            *[torch.from_numpy(a).to(dev) for a in streams], yb, cb)
        return out.cpu().numpy()


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    argparse.ArgumentParser(
        prog=argv[0] if argv else "verify_kernel",
        description=__doc__.splitlines()[0]).parse_args(argv[1:])

    import torch

    from fastdet_tpu_torch import bench
    from fastdet_tpu_torch import device as device_mod

    try:
        dev = device_mod.resolve(device)
    except RuntimeError as e:
        print(f"SKIP: no CUDA card ({e})")
        return 2
    device_mod.strict_fp32()
    print(bench.card_line(dev))
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    case = extreme_case()
    ref = reference(case, YB, CB)
    got = kernel(case, YB, CB, dev)
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)
        i, b, p = bad[0]
        print(f"FAIL: randomized case, {len(bad)} mismatched coeffs; "
              f"first at frame {i} block {b} pos {p}: "
              f"got {got[i, b, p]} want {ref[i, b, p]}")
        return 1
    n16 = int(np.count_nonzero(np.abs(ref) > 256))
    print(f"OK: randomized case bit-exact on {kind} "
          f"({ref.size} coeffs, {n16} with |v| > 256)")

    # Real camera content through the batched entry point.
    from fastdet_tpu_torch.runtime import native_jpeg

    if not native_jpeg.available():
        print("note: native jpeg unavailable; scene leg skipped")
        return 0
    fr = SparseFrame(native_jpeg, scene(0, quality=95))
    one = [a[None] for a in fr.streams()]
    ref1 = reference(one, fr.yb, fr.cb)[0]
    got1 = kernel(one, fr.yb, fr.cb, dev)[0]
    if not np.array_equal(got1, ref1):
        print(f"FAIL: scene case, "
              f"{int(np.count_nonzero(got1 != ref1))} mismatched coeffs")
        return 1
    print(f"OK: scene case bit-exact ({fr.nb} blocks)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
