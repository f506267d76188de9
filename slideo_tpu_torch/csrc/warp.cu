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
// (~300 K points per frame) — latency of the scattered reads. The thumbnail
// (259 x 461 x 4 B = 478 KB) is too large for one block's shared memory but
// stays resident in L2, and neighbouring points of the verification grid hit
// neighbouring pixels.
//
// Design: the kernel forms the points itself, from the T similarity
// transforms and the grid constants of ops/verify.warp_coords, so no [T, P]
// coordinate tensors are built or read. Each coordinate repeats the plain
// version's float32 operations in its order with _rn intrinsics, which nvcc
// cannot contract into FMAs, so the points are bit-equal to the torch ones
// (the Python-float constants arrive as float32, as torch casts them). One
// block per (output row, candidate), 1,300 blocks at the main path's shape,
// so that the scattered tap reads of many threads are in flight at once;
// each thread takes two neighbouring outputs of the flat [T, P] result and
// stores them as one float2 (a candidate's row starts only 8-byte aligned).
// Taps are read through the read-only cache (__ldg). Staging each row's
// footprint in shared memory first was timed on the card and was slower
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Grid {
  float sx, sy, inv_fx, inv_fy;   // slide-thumbnail -> full slide, frame -> frame thumbnail
  int out_h, out_w, stride;
};

// verify.warp_coords for output (row, col) of a transform (a, b, tx, ty).
__device__ __forceinline__ void warp_point(const Grid& g, float a, float b, float tx, float ty,
                                           int row, int col, float& x, float& y) {
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn((float)(col * g.stride), 0.5f), g.sx), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn((float)(row * g.stride), 0.5f), g.sy), 0.5f);
  const float fx = __fadd_rn(__fsub_rn(__fmul_rn(a, gx), __fmul_rn(b, gy)), tx);
  const float fy = __fadd_rn(__fadd_rn(__fmul_rn(b, gx), __fmul_rn(a, gy)), ty);
  x = __fsub_rn(__fmul_rn(__fadd_rn(fx, 0.5f), g.inv_fx), 0.5f);
  y = __fsub_rn(__fmul_rn(__fadd_rn(fy, 0.5f), g.inv_fy), 0.5f);
}

__device__ __forceinline__ float tap(const float* __restrict__ img, int w, int r, int c) {
  return __ldg(img + (int64_t)r * w + c);
}

__device__ __forceinline__ float bilinear(const float* __restrict__ img, int h, int w, float x,
                                          float y) {
  if (!(x >= 0.0f && x <= (float)(w - 1) && y >= 0.0f && y <= (float)(h - 1))) return 0.0f;
  const int x0 = (int)floorf(x), y0 = (int)floorf(y);
  const float wx0 = __fsub_rn(1.0f, __fsub_rn(x, (float)x0));
  const float wy0 = __fsub_rn(1.0f, __fsub_rn(y, (float)y0));
  const float wx1 = __fsub_rn(1.0f, __fsub_rn((float)(x0 + 1), x));
  const float wy1 = __fsub_rn(1.0f, __fsub_rn((float)(y0 + 1), y));
  // On the last column (row) the second tap's weight is exactly 0: reading
  // the clamped pixel there instead of branching adds 0 to a finite sum.
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float top = fmaf(wx1, tap(img, w, y0, x1), __fmul_rn(wx0, tap(img, w, y0, x0)));
  const float bot = fmaf(wx1, tap(img, w, y1, x1), __fmul_rn(wx0, tap(img, w, y1, x0)));
  return fmaf(wy1, bot, __fmul_rn(wy0, top));
}

__global__ void __launch_bounds__(THREADS)
warp_sample_kernel(const float* __restrict__ img, int h, int w, const float* __restrict__ ta,
                   const float* __restrict__ tb, const float* __restrict__ ttx,
                   const float* __restrict__ tty, Grid g, float* __restrict__ out) {
  const int t = blockIdx.y, row = blockIdx.x;
  const float a = ta[t], b = tb[t], tx = ttx[t], ty = tty[t];
  // Outputs [g0, g1) of the flat [T, out_h * out_w] result, in pairs that
  // start at even flat indices; a pair's half outside the row is not stored.
  const int64_t g0 = ((int64_t)t * g.out_h + row) * g.out_w, g1 = g0 + g.out_w;
  for (int64_t e = (g0 & ~int64_t(1)) + 2 * threadIdx.x; e < g1; e += 2 * THREADS) {
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x, y;
      warp_point(g, a, b, tx, ty, row, (int)(e + j - g0), x, y);
      v[j] = bilinear(img, h, w, x, y);
    }
    if (e >= g0 && e + 1 < g1) {
      *reinterpret_cast<float2*>(out + e) = make_float2(v[0], v[1]);
    } else if (e >= g0) {
      out[e] = v[0];
    } else {
      out[e + 1] = v[1];
    }
  }
}

}  // namespace

// img [h, w] f32; a, b, tx, ty [n_t] f32; out [n_t, out_h * out_w] f32,
// 8-byte aligned.
extern "C" int slideo_warp_sample(const void* img, int h, int w, const void* a, const void* b,
                                  const void* tx, const void* ty, int n_t, float sx, float sy,
                                  float inv_fx, float inv_fy, int out_h, int out_w, int stride,
                                  void* out, void* stream) {
  const Grid g{sx, sy, inv_fx, inv_fy, out_h, out_w, stride};
  const dim3 grid(out_h, n_t);
  warp_sample_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(tx), static_cast<const float*>(ty),
      g, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
