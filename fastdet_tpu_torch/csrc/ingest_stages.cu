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
// D2 (fd_ingest_nat_gated): nat again, escape-gated, through the tile
// structure of the TPU kernel and of B1. The tool's tile of bt blocks
// (pick_bt) decides two things, read from its boundary offsets: the
// route (fast when its value span probe[end] - probe[start] fits bt*32
// entries, else dense) and the gate (GATE = 100000 added to every output
// of a tile whose level-1 escape offsets eoff1 show escapes). The two
// routes read the same window entries, so they give the same nat on any
// row.
//
// What bounds them on this card: bytes. D1 writes 360 int32 per block
// (8 + 64 + 32 + 4 x 64) against a few dozen integer operations per
// value; D2 reads the streams once and writes 64 int32 per block. D1
// keeps the first design: one warp per block, two zigzag positions per
// lane, ranks from popcounts, the 256-byte output row of a block written
// by one warp.
//
// D2 runs B1's tile design (sparse_ingest.cu), on a sub-tile of ST blocks
// of a tool tile per CTA (ST divides bt; the wrapper picks it from the
// batch and the card's SM count, ingest_stages.sub_tile), on a
// (nb / ST, frames) grid:
//   1. cp.async stages the sub-tile's ST+1 moffx and probe entries and the
//      tool tile's probe and eoff1 at its two boundaries;
//   2. the sub-tile's mask entries and its share of the tool tile's value
//      segment land in shared memory, all in flight at once, zero past
//      each stream's capacity (fd::stage_words). A dense-route tile
//      stages no values: it reads them from global memory by window_at;
//   3. one thread per block assembles the block's mask from the staged
//      entries (fd::staged_mask);
//   4. one warp per block ranks, reads and places its values, plus the
//      gate, into the sub-tile's natural-order rows in shared memory
//      (fd::lane_bits, fd::lane_values, fd::store_natural);
//   5. the sub-tile's rows leave as one contiguous span of 16-byte stores
//      (fd::store_rows).
// Phases 2-5 are B1's own device functions (ingest_common.cuh). D2's
// first design (one CTA per tool tile, each warp a chain of dependent
// global loads per block, 4-byte stores) ran at 21 % of its bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest_common.cuh"

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kGate = 100000;     // ingest_stages.GATE
constexpr int kValsPerBlock = 32;  // D2's staged value share per block

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

template <int ST>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
nat_gated_kernel(const int32_t* __restrict__ ms,     // (B, ML)
                 const int32_t* __restrict__ vals,   // (B, VL)
                 const int32_t* __restrict__ moffx,  // (B, NB+1)
                 const int32_t* __restrict__ probe,  // (B, NB+1)
                 const int32_t* __restrict__ eoff1,  // (B, NB+1)
                 int32_t* __restrict__ out,          // (B, NB, 64)
                 int nb, int bt, int mlen, int vlen) {
  constexpr int kThreads = kWarpsPerCta * 32;
  __shared__ __align__(16) int32_t s_out[ST * 64];
  __shared__ int32_t s_val[kValsPerBlock * ST];
  __shared__ int32_t s_mask[8 * ST];
  __shared__ int32_t s_mo[ST + 1], s_po[ST + 1];
  __shared__ int32_t s_tile[4];  // probe, then eoff1, at the tool tile's ends
  __shared__ uint2 s_words[ST];  // each block's zigzag mask (lo, hi)

  const int tid = threadIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.x * ST;
  const int base = j0 / bt * bt;  // the tool tile's first block
  const long row = (long)b * (nb + 1);

  // 1. the sub-tile's block offsets, the tool tile's boundaries
  if (tid <= ST) {
    fd::cp_async4(&s_mo[tid], moffx + row + j0 + tid, 4);
    fd::cp_async4(&s_po[tid], probe + row + j0 + tid, 4);
  } else if (tid <= ST + 4) {
    const int k = tid - ST - 1;
    fd::cp_async4(&s_tile[k],
                  (k < 2 ? probe : eoff1) + row + base + (k & 1) * bt, 4);
  }
  fd::cp_async_wait_all();
  __syncthreads();

  // 2. the sub-tile's mask entries and (fast route) values, at most their
  // share per block; the rest is read by staged_at's rule
  const bool fast = (long)s_tile[1] - s_tile[0] <= (long)bt * 32;
  const int gate = s_tile[3] > s_tile[2] ? kGate : 0;
  const int ms0 = s_mo[0], vs0 = s_po[0];
  const int t2m = max(0, min(s_mo[ST] - ms0, 8 * ST));
  const int t2v = fast ? max(0, min(s_po[ST] - vs0, kValsPerBlock * ST)) : 0;
  const int32_t* mrow = ms + (long)b * mlen;
  const int32_t* vrow = vals + (long)b * vlen;
  fd::stage_words(s_mask, mrow, mlen, ms0, t2m, tid, kThreads);
  fd::stage_words(s_val, vrow, vlen, vs0, t2v, tid, kThreads);
  fd::cp_async_wait_all();
  __syncthreads();

  // 3. one thread per block assembles its mask from the staged entries
  if (tid < ST) {
    s_words[tid] = fd::staged_mask(s_mask, t2m, mrow, mlen, ms0, s_mo[tid],
                                   s_mo[tid + 1]);
  }
  __syncthreads();

  // 4. one warp per block: ranks, values, gate, placement
  const int lane = tid & 31;
  const fd::Placement pl = fd::placement(lane);
#pragma unroll
  for (int q = 0; q < ST / kWarpsPerCta; ++q) {
    const int jt = q * kWarpsPerCta + (tid >> 5);
    const uint2 mw = s_words[jt];
    const fd::LaneBits zb = fd::lane_bits(mw.x, mw.y, lane);
    const int off = s_po[jt];
    const int2 v = fd::lane_values(s_val, t2v, vrow, vlen, vs0, off,
                                   s_po[jt + 1] - off, zb);
    fd::store_natural(s_out + jt * 64, pl, sext4(v.x) + gate,
                      sext4(v.y) + gate);
  }
  __syncthreads();

  // 5. the sub-tile's rows: one contiguous span, 16-byte stores
  fd::store_rows(out + ((long)b * nb + j0) * 64, s_out, ST, tid, kThreads);
}

template <int ST>
cudaError_t launch_nat_gated(const void* ms, const void* vals,
                             const void* moffx, const void* probe,
                             const void* eoff1, void* out, int nframes,
                             int nb, int bt, int mlen, int vlen,
                             cudaStream_t stream) {
  const dim3 grid((unsigned)(nb / ST), (unsigned)nframes);
  nat_gated_kernel<ST><<<grid, kWarpsPerCta * 32, 0, stream>>>(
      static_cast<const int32_t*>(ms), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(moffx), static_cast<const int32_t*>(probe),
      static_cast<const int32_t*>(eoff1), static_cast<int32_t*>(out), nb, bt,
      mlen, vlen);
  return cudaGetLastError();
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
                                   int nb, int bt, int sub, int mlen,
                                   int vlen, void* stream) {
  if (nframes <= 0 || nb <= 0) return (int)cudaSuccess;
  if (bt <= 0 || nb % bt || sub <= 0 || bt % sub || nframes > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub) {
    case 8:
      return (int)launch_nat_gated<8>(ms, vals, moffx, probe, eoff1, out,
                                      nframes, nb, bt, mlen, vlen, s);
    case 16:
      return (int)launch_nat_gated<16>(ms, vals, moffx, probe, eoff1, out,
                                       nframes, nb, bt, mlen, vlen, s);
    case 32:
      return (int)launch_nat_gated<32>(ms, vals, moffx, probe, eoff1, out,
                                       nframes, nb, bt, mlen, vlen, s);
    case 64:
      return (int)launch_nat_gated<64>(ms, vals, moffx, probe, eoff1, out,
                                       nframes, nb, bt, mlen, vlen, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
