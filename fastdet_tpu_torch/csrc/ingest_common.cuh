// Device steps shared by kernel B1 (sparse_ingest.cu) and the stage
// kernels D1/D2 (ingest_stages.cu): the window read, the mask assembly,
// the in-block ranks and the zigzag -> natural placement of one JPEG
// block, one warp per block, two zigzag positions per lane (z = lane and
// z = lane + 32). D1 writes what each step returns, so it checks stage by
// stage the code B1 runs on the card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fd {
namespace {

// ZZ[j] = natural-order position of the j-th zigzag coefficient
__constant__ int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

constexpr unsigned kFull = 0xffffffffu;

// Entry k of a block's window: row[start + k] for 0 <= k < count, 0 past
// the window and past the stream's capacity (the TPU kernels' zero pad
// rows), so inconsistent rows never read out of bounds.
template <typename T>
__device__ __forceinline__ int window_at(const T* __restrict__ row, long cap,
                                         long start, int count, int k) {
  const long i = start + k;
  return (k >= 0 && k < count && i >= 0 && i < cap) ? (int)row[i] : 0;
}

// The block's 64-bit zigzag mask from the 8 mask bytes held by lanes 0..7
// (low 8 bits of each lane's value); every lane of the warp must call it.
__device__ __forceinline__ void mask_words(unsigned byte, unsigned& lo,
                                           unsigned& hi) {
  byte &= 0xffu;
  lo = hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo |= __shfl_sync(kFull, byte, k) << (8 * k);
    hi |= __shfl_sync(kFull, byte, k + 4) << (8 * k);
  }
}

// This lane's two zigzag positions: their mask bits and exclusive in-block
// ranks (popcounts of the set bits below each position).
struct LaneBits {
  bool bit0, bit1;
  int rank0, rank1;
};

__device__ __forceinline__ LaneBits lane_bits(unsigned lo, unsigned hi,
                                              int lane) {
  const unsigned below = (1u << lane) - 1u;
  LaneBits r;
  r.bit0 = (lo >> lane) & 1u;
  r.bit1 = (hi >> lane) & 1u;
  r.rank0 = __popc(lo & below);
  r.rank1 = __popc(lo) + __popc(hi & below);
  return r;
}

// Write this lane's two zigzag values to their natural positions of the
// block's 64-entry output row.
__device__ __forceinline__ void store_natural(int32_t* __restrict__ orow,
                                              int lane, int v0, int v1) {
  orow[kZigzag[lane]] = v0;
  orow[kZigzag[lane + 32]] = v1;
}

}  // namespace
}  // namespace fd
