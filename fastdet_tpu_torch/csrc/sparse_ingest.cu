// Kernel B1: sparse JPEG AC-coefficient reconstruction for Hopper (sm_90a).
//
// Replaces the TPU kernel fastdet_tpu/ops/pallas/sparse_ingest.py::_kernel
// (launched by _reconstruct). Python side: fastdet_tpu_torch/ops/
// sparse_ingest.py, whose reconstruct_plain() is this kernel's plain
// PyTorch version and whose docstring states the semantics both follow.
//
// What it computes, per frame and per JPEG block j (AC only; DC lane 0):
//   mask  = the block's zigzag mask prefix bytes maskstream[moff[j] + k],
//           k < min(moff[j+1] - moff[j], 8), expanded to 64 bits;
//   value = vals[voff[j] + rank] at each set bit, rank = in-block
//           exclusive popcount, for rank < voff[j+1] - voff[j];
//   level-1 escapes (value == sentinel, -4 for v6 / -8 for v5) take
//           esc8[e1off[j] + r], r = exclusive count of earlier escapes,
//           r < min(block count, 32); level-2 escapes (esc8 == -128)
//           take esc16[e2off[j] + r], r < min(block count, 16);
//   output in natural order through the zigzag table.
// Every read past a stream's capacity reads 0 (the TPU kernel's zero pad
// rows): zeroed rows and truncated overflow rows stay in bounds.
//
// What bounds it on this card: bytes. Per 4:2:0 416x416 frame it reads a
// ~48 KB packed row (less the unpacked int32 value stream the wrapper
// hands it) and writes 4056 x 64 int32 = 1.04 MB; the arithmetic is a
// few dozen integer ops per coefficient, far below the card's rate.
// Design for that bound: no windows, one-hot matmuls or permutation
// matmuls (the TPU workarounds for a core without gathers) — one warp
// per block, two zigzag positions per lane, the mask assembled from 8
// lane-loaded bytes by shuffles, ranks from popcounts of the mask words,
// escape ranks from two warp ballots per level, and each lane writing
// its two int32 results straight to their natural positions (the 256-B
// output row of a block is written by one warp, so the stores of a warp
// land in the same two 128-B lines). The window read, mask assembly,
// ranks and placement are the device functions of ingest_common.cuh,
// which the stage kernels D1/D2 (ingest_stages.cu) run and write out
// step by step.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest_common.cuh"

namespace {

constexpr int kEW1 = 32;  // level-1 escapes per block (kMaxEsc8PerBlock)
constexpr int kEW2 = 16;  // level-2 escapes per block (kMaxEsc16PerBlock)
constexpr int kWarpsPerCta = 8;
using fd::kFull;

__global__ void __launch_bounds__(kWarpsPerCta * 32)
sparse_reconstruct_kernel(const int32_t* __restrict__ offs,   // (B, 4, NB+1)
                          const uint8_t* __restrict__ ms,     // (B, MCAP)
                          const int32_t* __restrict__ vals,   // (B, NV)
                          const int8_t* __restrict__ esc8,    // (B, E8)
                          const int16_t* __restrict__ esc16,  // (B, E16)
                          int32_t* __restrict__ out,          // (B, NB, 64)
                          int nframes, int nb, int mcap, int nv, int e8cap,
                          int e16cap, int sentinel) {
  const int lane = threadIdx.x & 31;
  const long g = (long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (g >= (long)nframes * nb) return;  // whole warp exits together
  const int b = (int)(g / nb);
  const int j = (int)(g - (long)b * nb);

  const int32_t* o = offs + (long)b * 4 * (nb + 1);
  const int moff = o[j], mend = o[j + 1];
  const int voff = o[(nb + 1) + j], vend = o[(nb + 1) + j + 1];
  const int e1off = o[2 * (nb + 1) + j], e1end = o[2 * (nb + 1) + j + 1];
  const int e2off = o[3 * (nb + 1) + j], e2end = o[3 * (nb + 1) + j + 1];

  // mask prefix: lanes 0..7 load one byte each of the block's window (at
  // most 8 bytes), then every lane gathers the two 32-bit mask words
  unsigned lo, hi;
  fd::mask_words(fd::window_at(ms + (long)b * mcap, mcap, moff,
                               min(mend - moff, 8), lane),
                 lo, hi);
  const unsigned below = (1u << lane) - 1u;  // lanes < this one
  const fd::LaneBits zb = fd::lane_bits(lo, hi, lane);
  const bool bit0 = zb.bit0, bit1 = zb.bit1;

  const int nnz = vend - voff;
  const int32_t* vrow = vals + (long)b * nv;
  int v0 = bit0 ? fd::window_at(vrow, nv, voff, nnz, zb.rank0) : 0;
  int v1 = bit1 ? fd::window_at(vrow, nv, voff, nnz, zb.rank1) : 0;

  // level 1: value-stream sentinel -> esc8
  const bool f0 = bit0 && v0 == sentinel;
  const bool f1 = bit1 && v1 == sentinel;
  const unsigned m0 = __ballot_sync(kFull, f0);
  const unsigned m1 = __ballot_sync(kFull, f1);
  if (m0 | m1) {
    const int n1 = min(e1end - e1off, kEW1);
    const int8_t* erow = esc8 + (long)b * e8cap;
    if (f0) v0 = fd::window_at(erow, e8cap, e1off, n1, __popc(m0 & below));
    if (f1) {
      v1 = fd::window_at(erow, e8cap, e1off, n1,
                         __popc(m0) + __popc(m1 & below));
    }
    // level 2: esc8 sentinel -128 -> esc16
    const bool g0 = f0 && v0 == -128;
    const bool g1 = f1 && v1 == -128;
    const unsigned q0 = __ballot_sync(kFull, g0);
    const unsigned q1 = __ballot_sync(kFull, g1);
    if (q0 | q1) {
      const int n2 = min(e2end - e2off, kEW2);
      const int16_t* frow = esc16 + (long)b * e16cap;
      if (g0) v0 = fd::window_at(frow, e16cap, e2off, n2, __popc(q0 & below));
      if (g1) {
        v1 = fd::window_at(frow, e16cap, e2off, n2,
                           __popc(q0) + __popc(q1 & below));
      }
    }
  }

  fd::store_natural(out + g * 64, lane, v0, v1);
}

}  // namespace

extern "C" int fd_sparse_reconstruct(const void* offs, const void* ms,
                                     const void* vals, const void* esc8,
                                     const void* esc16, void* out,
                                     int nframes, int nb, int mcap, int nv,
                                     int e8cap, int e16cap, int sentinel,
                                     void* stream) {
  const long warps = (long)nframes * nb;
  if (warps <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta);
  sparse_reconstruct_kernel<<<grid, kWarpsPerCta * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offs), static_cast<const uint8_t*>(ms),
      static_cast<const int32_t*>(vals), static_cast<const int8_t*>(esc8),
      static_cast<const int16_t*>(esc16), static_cast<int32_t*>(out),
      nframes, nb, mcap, nv, e8cap, e16cap, sentinel);
  return (int)cudaGetLastError();
}

extern "C" const char* fd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
