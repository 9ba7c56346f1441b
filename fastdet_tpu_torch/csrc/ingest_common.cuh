// Device steps shared by kernel B1 (sparse_ingest.cu) and the stage
// kernels D1/D2 (ingest_stages.cu).
//
// Per block: the window read (from global memory, or from a tile's
// segment staged in shared memory), the mask assembly, the in-block ranks
// and the zigzag -> natural placement of one JPEG block, two zigzag
// positions per lane of a warp (z = lane and z = lane + 32). Per tile:
// the cp.async staging of an int32 segment with zero fill past the
// stream's capacity (stage_words), one thread's mask from the staged
// bytes (staged_mask), a lane's two values from the staged or global
// window (lane_values) and the 16-byte write-back of the tile's rows
// (store_rows).
//
// B1 and D2 run the same tile phases: stage_words, staged_mask,
// lane_values and store_rows are B1's phases 2-5 and D2's. D1 writes out
// what each per-block step returns. So D1 checks B1's steps one by one
// and D2 checks B1's staged tile structure, on the card.
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
// and D2 run per thread on a staged segment (staged_mask) and D1 per warp
// (mask_words).
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

// 4-byte cp.async into shared memory; src_bytes 0 writes a zero (the
// read past a stream's capacity).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of entries [s0, s0 + count) of an int32 stream of ``cap``
// entries into seg[0, count), zero past the capacity: window_at's values,
// as staged_at expects. The block's ``nthreads`` threads share the copy;
// cp_async_wait_all() and a barrier complete it.
__device__ __forceinline__ void stage_words(int32_t* seg,
                                            const int32_t* __restrict__ row,
                                            long cap, int s0, int count,
                                            int tid, int nthreads) {
  for (int i = tid; i < count; i += nthreads) {
    const long gi = (long)s0 + i;
    const bool in = gi >= 0 && gi < cap;
    cp_async4(&seg[i], in ? row + gi : row, in ? 4 : 0);
  }
}

// The 64-bit zigzag mask (lo, hi) of the block whose mask window starts at
// ``moff`` and whose successor's starts at ``mend`` (at most 8 bytes),
// assembled by one thread from the stream's segment [s0, s0 + t2) staged
// at ``seg`` (staged_at's rule outside it).
template <typename T>
__device__ __forceinline__ uint2 staged_mask(const T* seg, int t2,
                                             const T* __restrict__ row,
                                             long cap, int s0, int moff,
                                             int mend) {
  const int count = min(mend - moff, 8);
  unsigned lo, hi;
  assemble_mask(
      [&](int k) { return staged_at(seg, t2, row, cap, s0, moff, count, k); },
      lo, hi);
  return make_uint2(lo, hi);
}

// This lane's two values (x: zigzag lane, y: lane + 32) from the block's
// value window [voff, voff + nnz), 0 where the lane's mask bit is clear:
// entry ``rank`` of the window, read from the segment [s0, s0 + t2) staged
// at ``seg``. A window wholly in the segment (most blocks) skips the
// per-entry segment checks; any other reads by staged_at's rule, so an
// empty segment (t2 = 0) reads every value by window_at.
__device__ __forceinline__ int2 lane_values(const int32_t* seg, int t2,
                                            const int32_t* __restrict__ row,
                                            long cap, int s0, int voff,
                                            int nnz, LaneBits zb) {
  int v0 = 0, v1 = 0;
  if (window_staged(t2, s0, voff, nnz)) {
    if (zb.bit0) v0 = inside_at(seg, voff - s0, nnz, zb.rank0);
    if (zb.bit1) v1 = inside_at(seg, voff - s0, nnz, zb.rank1);
  } else {
    if (zb.bit0) v0 = staged_at(seg, t2, row, cap, s0, voff, nnz, zb.rank0);
    if (zb.bit1) v1 = staged_at(seg, t2, row, cap, s0, voff, nnz, zb.rank1);
  }
  return make_int2(v0, v1);
}

// Write a tile's ``n`` 64-entry rows from shared memory (16-byte aligned)
// to one contiguous, 16-byte aligned span of the output: 16-byte stores.
__device__ __forceinline__ void store_rows(int32_t* __restrict__ dst,
                                           const int32_t* src, int n,
                                           int tid, int nthreads) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = tid; i < n * 16; i += nthreads) d[i] = s[i];
}

}  // namespace
}  // namespace fd
