// Kernels D1 and D2: kernel B1's stages one by one, for Hopper (sm_90a).
//
// Replace the TPU kernels of the kernel-debug tool tools/debug_kernel_tpu.py:
// D1 ``dbg_kernel`` (launched by ``run``, :133) and D2 ``dbg_kernel2`` (the
// inline pl.pallas_call, :298). Python side: fastdet_tpu_torch/ops/
// ingest_stages.py, whose stages_plain() / nat_gated_plain() are these
// kernels' plain PyTorch versions and whose docstring states the stages.
//
// Inputs are flat int32 streams per frame: the mask bytes (one entry per
// byte), the signed nibble values, and the (NB+1) exclusive block offsets
// into each (``moffx`` into the mask stream, ``probe`` into the values,
// ``eoff1`` into the level-1 escapes for D2's gate). Reads past a stream
// are 0.
//
// D1 (fd_ingest_stages), one warp per JPEG block as B1 runs, writes what
// each of B1's steps (ingest_common.cuh) gives: the block's mask window
// (8), its value window (64), its share of the tile's value segment (the
// tile's bt*32 values from the tile's first value offset), the zigzag
// bits, their exclusive ranks, the signed nibble at each set bit's rank
// (acc) and acc in natural order (nat).
//
// D2 (fd_ingest_nat_gated), one CTA per tile of bt blocks: nat again with
// the structure of the TPU kernel's tile loop. When the tile's value span
// fits bt*32 entries the CTA stages that segment in shared memory and
// reads every value from there; otherwise each block reads its window
// from global memory. Both routes read the same window entries, so they
// give the same nat on any row. A tile whose level-1 escape offsets show
// escapes gets 100000 added to every output (the tool's escape gate).
//
// What bounds them on this card: bytes. D1 writes 360 int32 per block
// (8 + 64 + 32 + 4 x 64) against a few dozen integer operations per
// value; D2 reads the streams once and writes 64 int32 per block. The
// design keeps B1's: one warp per block, two zigzag positions per lane,
// ranks from popcounts, the 256-byte output row of a block written by
// one warp.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest_common.cuh"

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxBt = 128;  // D2's shared segment: kMaxBt * 32 int32

// Sign-extend a nibble (the tool's (v & 15) - ((v & 15) >> 3 << 4)).
__device__ __forceinline__ int sext4(int v) {
  const int n = v & 15;
  return n - ((n >> 3) << 4);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
ingest_stages_kernel(const int32_t* __restrict__ ms,     // (B, ML)
                     const int32_t* __restrict__ vals,   // (B, VL)
                     const int32_t* __restrict__ moffx,  // (B, NB+1)
                     const int32_t* __restrict__ probe,  // (B, NB+1)
                     int32_t* __restrict__ mwin,         // (B, NB, 8)
                     int32_t* __restrict__ win,          // (B, NB, 64)
                     int32_t* __restrict__ seg,          // (B, NB/bt, bt*32)
                     int32_t* __restrict__ bits,         // (B, NB, 64)
                     int32_t* __restrict__ rank,         // (B, NB, 64)
                     int32_t* __restrict__ acc,          // (B, NB, 64)
                     int32_t* __restrict__ nat,          // (B, NB, 64)
                     int nframes, int nb, int bt, int mlen, int vlen) {
  const int lane = threadIdx.x & 31;
  const long g = (long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (g >= (long)nframes * nb) return;  // whole warp exits together
  const int b = (int)(g / nb);
  const int j = (int)(g - (long)b * nb);
  const int32_t* mo = moffx + (long)b * (nb + 1);
  const int32_t* po = probe + (long)b * (nb + 1);
  const int32_t* mrow = ms + (long)b * mlen;
  const int32_t* vrow = vals + (long)b * vlen;

  // mask window: lanes 0..7 hold the block's (at most 8) mask entries
  const int moff = mo[j];
  const int mb = fd::window_at(mrow, mlen, moff, min(mo[j + 1] - moff, 8),
                               lane);
  if (lane < 8) mwin[g * 8 + lane] = mb;
  unsigned lo, hi;
  fd::mask_words((unsigned)mb, lo, hi);
  const fd::LaneBits zb = fd::lane_bits(lo, hi, lane);

  // value window (64) and this block's 32 entries of the tile's segment
  const int off = po[j], nnz = po[j + 1] - off;
  const int wcount = min(nnz, 64);
  int32_t* w = win + g * 64;
  w[lane] = fd::window_at(vrow, vlen, off, wcount, lane);
  w[lane + 32] = fd::window_at(vrow, vlen, off, wcount, lane + 32);
  const int t = j / bt;
  seg[g * 32 + lane] =
      fd::window_at(vrow, vlen, po[t * bt], bt * 32, (j - t * bt) * 32 + lane);

  // bits and ranks (zigzag order), the value at each set bit's rank, and
  // the natural-order placement
  int32_t* bo = bits + g * 64;
  int32_t* ro = rank + g * 64;
  bo[lane] = zb.bit0;
  bo[lane + 32] = zb.bit1;
  ro[lane] = zb.rank0;
  ro[lane + 32] = zb.rank1;
  const int a0 = zb.bit0 ? sext4(fd::window_at(vrow, vlen, off, nnz, zb.rank0))
                         : 0;
  const int a1 = zb.bit1 ? sext4(fd::window_at(vrow, vlen, off, nnz, zb.rank1))
                         : 0;
  acc[g * 64 + lane] = a0;
  acc[g * 64 + lane + 32] = a1;
  fd::store_natural(nat + g * 64, fd::placement(lane), a0, a1);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
nat_gated_kernel(const int32_t* __restrict__ ms,     // (B, ML)
                 const int32_t* __restrict__ vals,   // (B, VL)
                 const int32_t* __restrict__ moffx,  // (B, NB+1)
                 const int32_t* __restrict__ probe,  // (B, NB+1)
                 const int32_t* __restrict__ eoff1,  // (B, NB+1)
                 int32_t* __restrict__ out,          // (B, NB, 64)
                 int nb, int bt, int mlen, int vlen) {
  __shared__ int32_t seg[kMaxBt * 32];
  const int t = blockIdx.x, b = blockIdx.y;
  const int base = t * bt;
  const int t2 = bt * 32;
  const int32_t* mo = moffx + (long)b * (nb + 1);
  const int32_t* po = probe + (long)b * (nb + 1);
  const int32_t* eo = eoff1 + (long)b * (nb + 1);
  const int32_t* mrow = ms + (long)b * mlen;
  const int32_t* vrow = vals + (long)b * vlen;

  const int s0 = po[base];
  const bool fast = po[base + bt] - s0 <= t2;  // uniform over the CTA
  if (fast) {
    for (int i = threadIdx.x; i < t2; i += blockDim.x)
      seg[i] = fd::window_at(vrow, vlen, s0, t2, i);
  }
  __syncthreads();
  const int gate = eo[base + bt] - eo[base] > 0 ? 100000 : 0;

  const int lane = threadIdx.x & 31;
  for (int jt = threadIdx.x >> 5; jt < bt; jt += kWarpsPerCta) {
    const int j = base + jt;
    const int moff = mo[j];
    unsigned lo, hi;
    fd::mask_words((unsigned)fd::window_at(mrow, mlen, moff,
                                           min(mo[j + 1] - moff, 8), lane),
                   lo, hi);
    const fd::LaneBits zb = fd::lane_bits(lo, hi, lane);
    const int off = po[j], nnz = po[j + 1] - off;
    int v0 = 0, v1 = 0;
    if (fast && fd::window_staged(t2, s0, off, nnz)) {
      if (zb.bit0) v0 = fd::inside_at(seg, off - s0, nnz, zb.rank0);
      if (zb.bit1) v1 = fd::inside_at(seg, off - s0, nnz, zb.rank1);
    } else if (fast) {
      if (zb.bit0)
        v0 = fd::staged_at(seg, t2, vrow, vlen, s0, off, nnz, zb.rank0);
      if (zb.bit1)
        v1 = fd::staged_at(seg, t2, vrow, vlen, s0, off, nnz, zb.rank1);
    } else {
      if (zb.bit0) v0 = fd::window_at(vrow, vlen, off, nnz, zb.rank0);
      if (zb.bit1) v1 = fd::window_at(vrow, vlen, off, nnz, zb.rank1);
    }
    fd::store_natural(out + ((long)b * nb + j) * 64, fd::placement(lane),
                      (zb.bit0 ? sext4(v0) : 0) + gate,
                      (zb.bit1 ? sext4(v1) : 0) + gate);
  }
}

}  // namespace

extern "C" int fd_ingest_stages(const void* ms, const void* vals,
                                const void* moffx, const void* probe,
                                void* mwin, void* win, void* seg, void* bits,
                                void* rank, void* acc, void* nat, int nframes,
                                int nb, int bt, int mlen, int vlen,
                                void* stream) {
  const long warps = (long)nframes * nb;
  if (warps <= 0) return (int)cudaSuccess;
  if (bt <= 0 || nb % bt) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta);
  ingest_stages_kernel<<<grid, kWarpsPerCta * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ms), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(moffx), static_cast<const int32_t*>(probe),
      static_cast<int32_t*>(mwin), static_cast<int32_t*>(win),
      static_cast<int32_t*>(seg), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(acc),
      static_cast<int32_t*>(nat), nframes, nb, bt, mlen, vlen);
  return (int)cudaGetLastError();
}

extern "C" int fd_ingest_nat_gated(const void* ms, const void* vals,
                                   const void* moffx, const void* probe,
                                   const void* eoff1, void* out, int nframes,
                                   int nb, int bt, int mlen, int vlen,
                                   void* stream) {
  if (nframes <= 0 || nb <= 0) return (int)cudaSuccess;
  if (bt <= 0 || bt > kMaxBt || nb % bt || nframes > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(nb / bt), (unsigned)nframes);
  nat_gated_kernel<<<grid, kWarpsPerCta * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ms), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(moffx), static_cast<const int32_t*>(probe),
      static_cast<const int32_t*>(eoff1), static_cast<int32_t*>(out), nb, bt,
      mlen, vlen);
  return (int)cudaGetLastError();
}
