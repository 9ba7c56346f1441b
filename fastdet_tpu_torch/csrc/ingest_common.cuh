// Device steps shared by kernel B1 (sparse_ingest.cu) and the stage
// kernels D1/D2 (ingest_stages.cu): the window read (from global memory,
// or from a tile's segment staged in shared memory), the mask assembly,
// the in-block ranks and the zigzag -> natural placement of one JPEG
// block, two zigzag positions per lane of a warp (z = lane and
// z = lane + 32). D1 writes what each step returns and D2 runs the staged
// reads, so together they check stage by stage the code B1 runs on the
// card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fd {
namespace {

// ZZ[j] = natural-order position of the j-th zigzag coefficient. In
// global memory (read through L1), not __constant__: each lane of a warp
// reads its own entry, and the constant cache serialises a warp's
// distinct addresses (32 here).
__device__ int kZigzag[64] = {
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

// Entry k of a block's window [start, start + count) of a stream whose
// entries [s0, s0 + t2) are staged in shared memory at ``seg``: from the
// segment when the entry lies in it, else window_at's global read. The
// segment holds window_at's values (0 past the stream's capacity), so the
// two routes differ in where they read, never in what.
template <typename T>
__device__ __forceinline__ int staged_at(const T* seg, int t2,
                                         const T* __restrict__ row, long cap,
                                         int s0, int start, int count, int k) {
  const long li = (long)start - s0 + k;
  if (k >= 0 && k < count && li >= 0 && li < t2) return (int)seg[li];
  return window_at(row, cap, start, count, k);
}

// Whether the window [start, start + count) lies wholly in the staged
// entries [s0, s0 + t2) (an empty window reads 0 from anywhere).
__device__ __forceinline__ bool window_staged(int t2, int s0, int start,
                                              int count) {
  const long li = (long)start - s0;
  return count <= 0 || (li >= 0 && li + count <= t2);
}

// Entry k of a window that window_staged() found in the segment, from
// seg[li0 + k]: the value staged_at() reads, without its per-entry checks
// against the segment.
template <typename T>
__device__ __forceinline__ int inside_at(const T* seg, int li0, int count,
                                         int k) {
  return (k >= 0 && k < count) ? (int)seg[li0 + k] : 0;
}

// The block's 64-bit zigzag mask from its window's 8 bytes, byte k as
// ``byte_at(k)`` (low 8 bits): the one assembly of the mask, which B1
// runs per thread on a staged segment and D1/D2 per warp (mask_words).
template <typename ByteAt>
__device__ __forceinline__ void assemble_mask(ByteAt byte_at, unsigned& lo,
                                              unsigned& hi) {
  lo = hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo |= ((unsigned)byte_at(k) & 0xffu) << (8 * k);
    hi |= ((unsigned)byte_at(k + 4) & 0xffu) << (8 * k);
  }
}

// The block's mask from the 8 bytes held by lanes 0..7 (low 8 bits of
// each lane's value); every lane of the warp must call it.
__device__ __forceinline__ void mask_words(unsigned byte, unsigned& lo,
                                           unsigned& hi) {
  assemble_mask([byte](int k) { return __shfl_sync(kFull, byte, k); }, lo,
                hi);
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

// Natural-order positions of this lane's two zigzag positions, looked
// up once per thread.
struct Placement {
  int p0, p1;
};

__device__ __forceinline__ Placement placement(int lane) {
  return {kZigzag[lane], kZigzag[lane + 32]};
}

// Write this lane's two zigzag values to their natural positions of the
// block's 64-entry output row (global or shared memory).
__device__ __forceinline__ void store_natural(int32_t* __restrict__ orow,
                                              Placement pl, int v0, int v1) {
  orow[pl.p0] = v0;
  orow[pl.p1] = v1;
}

}  // namespace
}  // namespace fd
