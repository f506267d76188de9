// K6: bilinear sampling of the frame thumbnail at warped verification points.
//
// Replaces slideo_tpu/ops/pallas_warp.py:bilinear_sample_pallas (_kernel),
// which builds tent matrices on the fly and contracts them on the MXU in
// bf16. Contract, held to ops/verify._bilinear_image in float32:
//   inb  = 0 <= x <= w-1 and 0 <= y <= h-1
//   xc   = clip(x, 0, w-1), yc = clip(y, 0, h-1)
//   out  = inb ? sum_{taps} max(0, 1-|yc-i|) * max(0, 1-|xc-j|) * img[i, j] : 0
// The TPU kernel's bf16 MXU inputs were a TPU choice, not the contract: this
// kernel samples in f32.
//
// What bounds it on the card: 4 image reads and a few flops per point
// (~300 K points per frame) — latency of the scattered reads. Design: one
// thread per sample point, reading the four taps straight from the f32
// thumbnail in global memory. The thumbnail (259 x 461 x 4 B = 478 KB) is too
// large for one block's shared memory but stays resident in L2, and
// neighbouring points of the verification grid hit neighbouring pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bilinear_sample_kernel(const float* __restrict__ img, int h, int w,
                                       const float* __restrict__ xs,
                                       const float* __restrict__ ys, int64_t n,
                                       float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = xs[i], y = ys[i];
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  if (!(x >= 0.0f && x <= wm1 && y >= 0.0f && y <= hm1)) {
    out[i] = 0.0f;
    return;
  }
  const int x0 = (int)floorf(x), y0 = (int)floorf(y);
  const float wx0 = 1.0f - (x - (float)x0), wy0 = 1.0f - (y - (float)y0);
  const float wx1 = 1.0f - ((float)(x0 + 1) - x), wy1 = 1.0f - ((float)(y0 + 1) - y);
  const bool has_x1 = x0 + 1 < w, has_y1 = y0 + 1 < h;
  const float* r0 = img + (int64_t)y0 * w;
  float top = wx0 * __ldg(r0 + x0);
  if (has_x1) top += wx1 * __ldg(r0 + x0 + 1);
  float v = wy0 * top;
  if (has_y1) {
    const float* r1 = r0 + w;
    float bot = wx0 * __ldg(r1 + x0);
    if (has_x1) bot += wx1 * __ldg(r1 + x0 + 1);
    v += wy1 * bot;
  }
  out[i] = v;
}

}  // namespace

extern "C" int slideo_bilinear_sample(const void* img, int h, int w,
                                      const void* xs, const void* ys, int n,
                                      void* out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  bilinear_sample_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const float*>(xs),
      static_cast<const float*>(ys), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
