// Kernel B1: sparse JPEG coefficient reconstruction for Hopper (sm_90a).
//
// Replaces the TPU kernel fastdet_tpu/ops/pallas/sparse_ingest.py::_kernel
// (launched by _reconstruct). Python side: fastdet_tpu_torch/ops/
// sparse_ingest.py, whose reconstruct_plain() is this kernel's plain
// PyTorch version and whose docstring states the semantics both follow.
//
// What it computes, per frame and per JPEG block j:
//   mask  = the block's zigzag mask prefix bytes maskstream[moff[j] + k],
//           k < min(moff[j+1] - moff[j], 8), expanded to 64 bits;
//   value = vals[voff[j] + rank] at each set bit, rank = in-block
//           exclusive popcount, for rank < voff[j+1] - voff[j];
//   level-1 escapes (value == sentinel, -4 for v6 / -8 for v5) take
//           esc8[e1off[j] + r], r = exclusive count of earlier escapes,
//           r < min(block count, 32); level-2 escapes (esc8 == -128)
//           take esc16[e2off[j] + r], r < min(block count, 16);
//   output in natural order through the zigzag table; natural position 0
//           takes dc[j] when a DC column is given (else what the mask
//           and values give there: 0 on every row the emitter writes).
// Every read past a stream's capacity reads 0 (the TPU kernel's zero pad
// rows): zeroed rows and truncated overflow rows stay in bounds.
//
// What bounds it on this card: bytes (a few dozen integer operations per
// coefficient). Per 416x416 4:2:0 frame it writes 4056 x 64 int32 =
// 1.04 MB and reads the block offsets, ~20 KB of mask bytes and values
// and the DC column. The first design (one warp per block) ran at 12 % of
// that bound: each warp waited on a chain of four dependent global loads
// (offsets, mask bytes, values, escapes) with a handful of instructions
// between them, then scattered 4-byte stores.
//
// Design: one CTA per tile of BT consecutive blocks of one frame, on a
// (tiles, frames) grid; the last tile of a frame is ragged and masked.
//   1. cp.async stages the tile's 4 x (BT+1) block offsets and its DC
//      values in shared memory (one coalesced round trip);
//   2. from those, the tile's segments of the four streams land in shared
//      memory, all in flight at once (a second round trip): mask bytes
//      [moff[j0], moff[j0+BT]), values [voff[j0], voff[j0+BT])
//      (fd::stage_words: cp.async, zero fill past the capacity) and both
//      escape streams, each up to a fixed share per block. An entry
//      outside a staged segment (a dense block, an inconsistent row) is
//      read from global memory by fd::staged_at's rule, so the two routes
//      differ in where they read, never in what;
//   3. one thread per block assembles the block's 64-bit mask from the
//      staged bytes (fd::staged_mask);
//   4. each warp then ranks, reads and places its blocks' values from
//      shared memory (fd::lane_bits, fd::lane_values, fd::store_natural)
//      into the tile's natural-order rows in shared memory. A block whose
//      value window lies wholly in the staged segment (most blocks) skips
//      the per-entry segment checks, and one without escape entries (most
//      blocks) the ballots;
//   5. the tile's BT x 256 B of output, one contiguous 256-B aligned span
//      of out, leaves as 16-byte stores (fd::store_rows).
// Phases 2-5 call ingest_common.cuh's tile functions, which kernel D2
// runs too, and every per-block step in them is one that D1 writes out.
// The wrapper picks BT from the batch and the card's SM count
// (sparse_ingest.tile) and passes it in.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest_common.cuh"

namespace {

constexpr int kEW1 = 32;  // level-1 escapes per block (kMaxEsc8PerBlock)
constexpr int kEW2 = 16;  // level-2 escapes per block (kMaxEsc16PerBlock)
// entries per block of each stream's staged share (the tile's segment
// beyond that is read from global memory): the std tier averages 13.6
// values, 0.66 level-1 and 0.01 level-2 escapes per block, the dense
// tier 15, 4.2 and 0.3 (runtime/engine.py sparse_budgets)
constexpr int kValsPerBlock = 32;
constexpr int kEsc8PerBlock = 8;
constexpr int kEsc16PerBlock = 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
using fd::cp_async4;
using fd::cp_async_wait_all;
using fd::kFull;

template <int BT>
__global__ void __launch_bounds__(kThreads)
sparse_tile_kernel(const int32_t* __restrict__ offs,   // (B, 4, NB+1)
                   const uint8_t* __restrict__ ms,     // (B, MCAP)
                   const int32_t* __restrict__ vals,   // (B, NV)
                   const int8_t* __restrict__ esc8,    // (B, E8)
                   const int16_t* __restrict__ esc16,  // (B, E16)
                   const int32_t* __restrict__ dc,     // (B, NB) or null
                   int32_t* __restrict__ out,          // (B, NB, 64)
                   int nb, int mcap, int nv, int e8cap, int e16cap,
                   int sentinel) {
  __shared__ __align__(16) int32_t s_out[BT * 64];
  __shared__ int32_t s_val[kValsPerBlock * BT];
  __shared__ int32_t s_off[4][BT + 1];
  __shared__ int32_t s_dc[BT];
  __shared__ uint8_t s_mask[8 * BT];
  __shared__ int8_t s_e8[kEsc8PerBlock * BT];
  __shared__ int16_t s_e16[kEsc16PerBlock * BT];
  __shared__ uint2 s_words[BT];  // each block's zigzag mask (lo, hi)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * BT;
  const int n = min(BT, nb - j0);  // blocks of this tile (the last is ragged)

  // 1. offsets and DC of the tile's blocks
  const int32_t* o = offs + (long)b * 4 * (nb + 1) + j0;
  for (int i = tid; i < 4 * (BT + 1); i += kThreads) {
    const int r = i / (BT + 1), k = i - r * (BT + 1);
    if (k <= n) cp_async4(&s_off[r][k], o + (long)r * (nb + 1) + k, 4);
  }
  const bool has_dc = dc != nullptr;
  if (has_dc && tid < n) cp_async4(&s_dc[tid], dc + (long)b * nb + j0 + tid, 4);
  cp_async_wait_all();
  __syncthreads();

  // 2. the tile's segments of the four streams, each at most its share of
  // shared memory: values by cp.async (zero fill past the capacity), the
  // byte and int16 streams through registers, all loads in flight at once
  const int ms0 = s_off[0][0], vs0 = s_off[1][0];
  const int es0 = s_off[2][0], fs0 = s_off[3][0];
  const int t2m = max(0, min(s_off[0][n] - ms0, 8 * BT));
  const int t2v = max(0, min(s_off[1][n] - vs0, kValsPerBlock * BT));
  const int t2e = max(0, min(s_off[2][n] - es0, kEsc8PerBlock * BT));
  const int t2f = max(0, min(s_off[3][n] - fs0, kEsc16PerBlock * BT));
  const uint8_t* mrow = ms + (long)b * mcap;
  const int32_t* vrow = vals + (long)b * nv;
  const int8_t* erow = esc8 + (long)b * e8cap;
  const int16_t* frow = esc16 + (long)b * e16cap;
  fd::stage_words(s_val, vrow, nv, vs0, t2v, tid, kThreads);
  constexpr int kM = (8 * BT + kThreads - 1) / kThreads;
  constexpr int kE = (kEsc8PerBlock * BT + kThreads - 1) / kThreads;
  constexpr int kF = (kEsc16PerBlock * BT + kThreads - 1) / kThreads;
  int rm[kM], re[kE], rf[kF];
#pragma unroll
  for (int q = 0; q < kM; ++q)
    rm[q] = fd::window_at(mrow, mcap, ms0, t2m, tid + q * kThreads);
#pragma unroll
  for (int q = 0; q < kE; ++q)
    re[q] = fd::window_at(erow, e8cap, es0, t2e, tid + q * kThreads);
#pragma unroll
  for (int q = 0; q < kF; ++q)
    rf[q] = fd::window_at(frow, e16cap, fs0, t2f, tid + q * kThreads);
#pragma unroll
  for (int q = 0; q < kM; ++q)
    if (tid + q * kThreads < t2m) s_mask[tid + q * kThreads] = (uint8_t)rm[q];
#pragma unroll
  for (int q = 0; q < kE; ++q)
    if (tid + q * kThreads < t2e) s_e8[tid + q * kThreads] = (int8_t)re[q];
#pragma unroll
  for (int q = 0; q < kF; ++q)
    if (tid + q * kThreads < t2f) s_e16[tid + q * kThreads] = (int16_t)rf[q];
  cp_async_wait_all();
  __syncthreads();

  // 3. one thread per block assembles its mask from the staged bytes
  if (tid < n) {
    s_words[tid] = fd::staged_mask(s_mask, t2m, mrow, mcap, ms0,
                                   s_off[0][tid], s_off[0][tid + 1]);
  }
  __syncthreads();

  // 4. one warp per block: ranks, values, escapes, placement
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes < this one
  const fd::Placement pl = fd::placement(lane);
  for (int jt = tid >> 5; jt < n; jt += kWarps) {
    const uint2 mw = s_words[jt];
    const fd::LaneBits zb = fd::lane_bits(mw.x, mw.y, lane);
    const bool bit0 = zb.bit0, bit1 = zb.bit1;
    const int voff = s_off[1][jt];
    const int2 v = fd::lane_values(s_val, t2v, vrow, nv, vs0, voff,
                                   s_off[1][jt + 1] - voff, zb);
    int v0 = v.x, v1 = v.y;
    const int e1off = s_off[2][jt];
    const int n1 = min(s_off[2][jt + 1] - e1off, kEW1);
    if (n1 <= 0) {
      // the common block: no escape entries (a sentinel reads the empty
      // escape window: 0)
      if (v0 == sentinel) v0 = 0;
      if (v1 == sentinel) v1 = 0;
    } else {
      // level 1: value-stream sentinel -> esc8
      const bool f0 = bit0 && v0 == sentinel;
      const bool f1 = bit1 && v1 == sentinel;
      const unsigned m0 = __ballot_sync(kFull, f0);
      const unsigned m1 = __ballot_sync(kFull, f1);
      if (m0 | m1) {
        if (f0) {
          v0 = fd::staged_at(s_e8, t2e, erow, e8cap, es0, e1off, n1,
                             __popc(m0 & below));
        }
        if (f1) {
          v1 = fd::staged_at(s_e8, t2e, erow, e8cap, es0, e1off, n1,
                             __popc(m0) + __popc(m1 & below));
        }
        // level 2: esc8 sentinel -128 -> esc16
        const bool g0 = f0 && v0 == -128;
        const bool g1 = f1 && v1 == -128;
        const unsigned q0 = __ballot_sync(kFull, g0);
        const unsigned q1 = __ballot_sync(kFull, g1);
        if (q0 | q1) {
          const int e2off = s_off[3][jt];
          const int n2 = min(s_off[3][jt + 1] - e2off, kEW2);
          if (g0) {
            v0 = fd::staged_at(s_e16, t2f, frow, e16cap, fs0, e2off, n2,
                               __popc(q0 & below));
          }
          if (g1) {
            v1 = fd::staged_at(s_e16, t2f, frow, e16cap, fs0, e2off, n2,
                               __popc(q0) + __popc(q1 & below));
          }
        }
      }
    }
    if (has_dc && lane == 0) v0 = s_dc[jt];  // zigzag 0 is natural 0
    fd::store_natural(s_out + jt * 64, pl, v0, v1);
  }
  __syncthreads();

  // 5. the tile's rows: one contiguous span, 16-byte stores
  fd::store_rows(out + ((long)b * nb + j0) * 64, s_out, n, tid, kThreads);
}

template <int BT>
cudaError_t launch(const void* offs, const void* ms, const void* vals,
                   const void* esc8, const void* esc16, const void* dc,
                   void* out, int nframes, int nb, int mcap, int nv,
                   int e8cap, int e16cap, int sentinel,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((nb + BT - 1) / BT), (unsigned)nframes);
  sparse_tile_kernel<BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(offs), static_cast<const uint8_t*>(ms),
      static_cast<const int32_t*>(vals), static_cast<const int8_t*>(esc8),
      static_cast<const int16_t*>(esc16), static_cast<const int32_t*>(dc),
      static_cast<int32_t*>(out), nb, mcap, nv, e8cap, e16cap, sentinel);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fd_sparse_reconstruct(const void* offs, const void* ms,
                                     const void* vals, const void* esc8,
                                     const void* esc16, const void* dc,
                                     void* out, int nframes, int nb,
                                     int mcap, int nv, int e8cap, int e16cap,
                                     int sentinel, int bt, void* stream) {
  if (nframes <= 0 || nb <= 0) return (int)cudaSuccess;
  if (nframes > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 8:
      return (int)launch<8>(offs, ms, vals, esc8, esc16, dc, out, nframes,
                            nb, mcap, nv, e8cap, e16cap, sentinel, s);
    case 16:
      return (int)launch<16>(offs, ms, vals, esc8, esc16, dc, out, nframes,
                             nb, mcap, nv, e8cap, e16cap, sentinel, s);
    case 32:
      return (int)launch<32>(offs, ms, vals, esc8, esc16, dc, out, nframes,
                             nb, mcap, nv, e8cap, e16cap, sentinel, s);
    case 64:
      return (int)launch<64>(offs, ms, vals, esc8, esc16, dc, out, nframes,
                             nb, mcap, nv, e8cap, e16cap, sentinel, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
