// Kernel B2: fused 4:2:0 plane ingest for Hopper (sm_90a) — libjpeg
// "fancy" h2v2 chroma upsample + YCbCr->RGB + uint8 rounding + /255.
//
// Replaces the TPU kernel fastdet_tpu/ops/pallas/plane_ingest.py::_kernel
// (launched by plane_ingest / plane_ingest_batch). Python side:
// fastdet_tpu_torch/ops/plane_ingest.py; its plane_ingest_plain() is this
// kernel's plain PyTorch version (jpeg_device.upsample2x_triangle +
// ycbcr_to_rgb01), and the two agree bit for bit.
//
// Per output pixel (r, c) of an H x W frame, chroma planes h x w = H/2 x W/2:
//   vertical   t(col) = 3*C[r/2][col] + C[r/2 -+ 1][col]   (row above for
//              even r, below for odd r, edges replicated)
//   horizontal even c: (3*t[c/2] + t[c/2 - 1] + 8) >> 4
//              odd c:  (3*t[c/2] + t[c/2 + 1] + 7) >> 4   (edges replicated)
//   colour     r = y + 1.402 cr', g = y - 0.344136 cb' - 0.714136 cr',
//              b = y + 1.772 cb' (cb' = cb - 128, cr' = cr - 128), each
//              rounded half to even, clipped to [0, 255], times 1/255.
// The TPU kernel spelled the upsample as two banded f32 matmuls (its core
// has no cheap shifts across lanes); here it is the integer stencil. The
// float steps are written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc
// cannot contract them into FMAs: every product and sum rounds exactly
// where PyTorch's separate elementwise ops (and XLA's) round, which keeps
// the kernel bit-identical to its plain version.
//
// What bounds it on this card: bytes. Per 416x416 frame it reads 260 KB
// of uint8 planes and writes 2.08 MB of float32 NHWC; a few dozen
// operations per pixel are far below the card's rate. The first design
// (one thread per pixel, 12-byte stores at a 12-byte stride, two 64-bit
// divisions and seven byte loads per pixel) reached 47 % of that bound.
//
// Design: one CTA per pair of output rows (2i, 2i+1) and chunk of up to
// kChunk columns of one frame, on a (chunks, row pairs, frames) grid.
//   - The two rows share chroma rows i-1, i and i+1 of both planes, which
//     the CTA stages in shared memory once, edge columns replicated.
//   - Each thread makes 4 horizontally adjacent pixels: Y arrives as one
//     4-byte load where its address allows (the planes tier packs frames
//     at a 259,588-byte stride, so only 4-byte alignment holds), else as
//     bytes; the 48 bytes of RGB go to shared memory.
//   - The CTA's output rows then leave as 16-byte stores, consecutive
//     threads on consecutive addresses, where the row span is 16-byte
//     aligned (always when W is a multiple of 4), else as 4-byte stores.
//     Any even W is taken; a row whose width is not a multiple of 4 ends
//     in a 2-pixel group.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;            // output columns per CTA
constexpr int kThreads = kChunk / 2;   // 2 rows x kChunk / 4 groups
constexpr int kCols = kChunk / 2 + 2;  // staged chroma columns (with halo)
// the colour constants rounded from double, as PyTorch and XLA round a
// Python float scalar for a float32 tensor
constexpr float kCrR = static_cast<float>(1.402);
constexpr float kCbG = static_cast<float>(0.344136);
constexpr float kCrG = static_cast<float>(0.714136);
constexpr float kCbB = static_cast<float>(1.772);

__device__ __forceinline__ float to_unit(float v) {
  v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  return __fmul_rn(v, static_cast<float>(1.0 / 255.0));
}

// One pixel's RGB from its luma and upsampled chroma bytes.
__device__ __forceinline__ void rgb(int yv, int cbv, int crv, float* o) {
  const float yf = (float)yv;
  const float cbf = __fsub_rn((float)cbv, 128.0f);
  const float crf = __fsub_rn((float)crv, 128.0f);
  o[0] = to_unit(__fadd_rn(yf, __fmul_rn(kCrR, crf)));
  o[1] = to_unit(__fsub_rn(__fsub_rn(yf, __fmul_rn(kCbG, cbf)),
                           __fmul_rn(kCrG, crf)));
  o[2] = to_unit(__fadd_rn(yf, __fmul_rn(kCbB, cbf)));
}

__global__ void __launch_bounds__(kThreads)
plane_ingest_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ cb,
                    const uint8_t* __restrict__ cr,
                    float* __restrict__ out, int height, int width,
                    long y_bstride, long c_bstride) {
  __shared__ __align__(16) float s_out[2][kChunk * 3];
  __shared__ uint8_t s_c[2][3][kCols];  // plane x (above, row, below) x col

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChunk;  // first output column
  const int i = blockIdx.y;            // chroma row of output rows 2i, 2i+1
  const int b = blockIdx.z;
  const int h = height >> 1, w = width >> 1;
  const int cw = min(kChunk, width - c0);  // columns of this CTA (even)

  // Y of this thread's group: row 2i + r, columns c0 + 4g ...
  const int r = tid / (kChunk / 4), g = tid - r * (kChunk / 4);
  const int npx = min(4, cw - 4 * g);  // 4, 2 (a ragged row end) or <= 0
  const uint8_t* yp = y + (long)b * y_bstride + (long)(2 * i + r) * width +
                      c0 + 4 * g;
  uint32_t yq = 0;
  if (npx == 4 && (reinterpret_cast<uintptr_t>(yp) & 3) == 0) {
    yq = *reinterpret_cast<const uint32_t*>(yp);
  } else {
    for (int q = 0; q < npx; ++q) yq |= (uint32_t)yp[q] << (8 * q);
  }

  // chroma rows i-1, i, i+1 (edges replicated), columns from c0/2 - 1
  const int jlo = (c0 >> 1) - 1;
  const int ncols = cw / 2 + 2;
  const long rows[3] = {(long)max(i - 1, 0) * w, (long)i * w,
                        (long)min(i + 1, h - 1) * w};
  const uint8_t* planes[2] = {cb + (long)b * c_bstride,
                              cr + (long)b * c_bstride};
  for (int k = tid; k < ncols; k += kThreads) {
    const int j = min(max(jlo + k, 0), w - 1);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int v = 0; v < 3; ++v) s_c[p][v][k] = planes[p][rows[v] + j];
    }
  }
  __syncthreads();

  if (npx > 0) {
    // t(col) = 3*C[i][col] + C[i -+ 1][col] at staged columns 2g .. 2g+3
    // (chroma columns c/2 - 1 .. c/2 + 2 of the group's first pixel c)
    int up[2][4];
    const int vrow = r ? 2 : 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      int t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = min(2 * g + k, ncols - 1);
        t[k] = 3 * s_c[p][1][col] + s_c[p][vrow][col];
      }
      up[p][0] = (3 * t[1] + t[0] + 8) >> 4;
      up[p][1] = (3 * t[1] + t[2] + 7) >> 4;
      up[p][2] = (3 * t[2] + t[1] + 8) >> 4;
      up[p][3] = (3 * t[2] + t[3] + 7) >> 4;
    }
    float px[12];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rgb((yq >> (8 * q)) & 0xff, up[0][q], up[1][q], px + 3 * q);
    float* so = &s_out[r][12 * g];
    if (npx == 4) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        reinterpret_cast<float4*>(so)[k] =
            make_float4(px[4 * k], px[4 * k + 1], px[4 * k + 2],
                        px[4 * k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) so[k] = px[k];
    }
  }
  __syncthreads();

  // the two rows' spans of out, 16-byte stores where aligned
  const int len = 3 * cw;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* dst = out + (((long)b * height + 2 * i + rr) * width + c0) * 3;
    const float* src = s_out[rr];
    if (((reinterpret_cast<uintptr_t>(dst) & 15) | (len & 3)) == 0) {
      for (int k = tid; k < len / 4; k += kThreads)
        reinterpret_cast<float4*>(dst)[k] =
            reinterpret_cast<const float4*>(src)[k];
    } else {
      for (int k = tid; k < len; k += kThreads) dst[k] = src[k];
    }
  }
}

}  // namespace

extern "C" int fd_plane_ingest(const void* y, const void* cb, const void* cr,
                               void* out, int nframes, int height, int width,
                               long y_bstride, long c_bstride, void* stream) {
  if (nframes <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if ((height | width) & 1 || nframes > 65535 || height / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((width + kChunk - 1) / kChunk),
                  (unsigned)(height / 2), (unsigned)nframes);
  plane_ingest_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), static_cast<float*>(out), height,
      width, y_bstride, c_bstride);
  return (int)cudaGetLastError();
}
