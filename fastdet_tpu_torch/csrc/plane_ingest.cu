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
// operations per pixel are far below the card's rate. One thread per
// output pixel, consecutive threads on consecutive pixels of a row, so
// the 12-byte RGB stores of a warp cover one contiguous 384-byte span
// and the chroma reads hit the same few cached lines.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ int upsample(const uint8_t* __restrict__ c,
                                        int h, int w, int r, int col) {
  const int i = r >> 1, j = col >> 1;
  const int iv = (r & 1) ? min(i + 1, h - 1) : max(i - 1, 0);
  const int jn = (col & 1) ? min(j + 1, w - 1) : max(j - 1, 0);
  const uint8_t* cur = c + (long)i * w;
  const uint8_t* vert = c + (long)iv * w;
  const int t = 3 * cur[j] + vert[j];
  const int tn = 3 * cur[jn] + vert[jn];
  return (3 * t + tn + ((col & 1) ? 7 : 8)) >> 4;
}

__global__ void __launch_bounds__(kThreads)
plane_ingest_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ cb,
                    const uint8_t* __restrict__ cr,
                    float* __restrict__ out, int nframes, int height,
                    int width, long y_bstride, long c_bstride) {
  const long npix = (long)height * width;
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nframes * npix) return;
  const int b = (int)(idx / npix);
  const long p = idx - (long)b * npix;
  const int r = (int)(p / width);
  const int col = (int)(p - (long)r * width);
  const int h = height >> 1, w = width >> 1;

  const float yf = (float)y[(long)b * y_bstride + p];
  const float cbf =
      __fsub_rn((float)upsample(cb + (long)b * c_bstride, h, w, r, col), 128.0f);
  const float crf =
      __fsub_rn((float)upsample(cr + (long)b * c_bstride, h, w, r, col), 128.0f);

  const float rr = __fadd_rn(yf, __fmul_rn(kCrR, crf));
  const float gg = __fsub_rn(__fsub_rn(yf, __fmul_rn(kCbG, cbf)),
                             __fmul_rn(kCrG, crf));
  const float bb = __fadd_rn(yf, __fmul_rn(kCbB, cbf));
  float* o = out + idx * 3;
  o[0] = to_unit(rr);
  o[1] = to_unit(gg);
  o[2] = to_unit(bb);
}

}  // namespace

extern "C" int fd_plane_ingest(const void* y, const void* cb, const void* cr,
                               void* out, int nframes, int height, int width,
                               long y_bstride, long c_bstride, void* stream) {
  const long total = (long)nframes * height * width;
  if (total <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  plane_ingest_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), static_cast<float*>(out), nframes,
      height, width, y_bstride, c_bstride);
  return (int)cudaGetLastError();
}
