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
//
// K6h, the homography form: the same TPU kernel at its second call site,
// slideo_tpu/ops/verify.py:199 (warp_similarity_homography, the SIFT
// engine), where the points come from 8-parameter homographies with the
// perspective divide (verify.py:189-191, homography.py:36-44). It is bound
// the same way, by the latency of the scattered tap reads: the divide adds
// a few instructions a point and no bytes. So it shares the sampling body,
// the block layout and the float2 stores, and differs only in how a point
// is formed (one template over the point form, below): it reads the
// candidate's 8 parameters once a block and forms each point with the
// plain version's operations in its order (__fmul_rn, __fadd_rn,
// __fdiv_rn: no FMA, no approximate divide), w = (h6 x + h7 y) + 1 with a
// |w| <= 1e-8 made +1e-8 (so a tiny negative w becomes +1e-8), then
// u = ((h0 x + h1 y) + h2) / w and v the same way, bit-equal to the torch
// points of ops/verify.warp_coords_homography.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Grid {
  float sx, sy, inv_fx, inv_fy;   // slide-thumbnail -> full slide, frame -> frame thumbnail
  int out_h, out_w, stride;
};

// Full-res slide coordinates of output (row, col): verify._grid_points.
__device__ __forceinline__ void grid_point(const Grid& g, int row, int col, float& gx, float& gy) {
  gx = __fsub_rn(__fmul_rn(__fadd_rn((float)(col * g.stride), 0.5f), g.sx), 0.5f);
  gy = __fsub_rn(__fmul_rn(__fadd_rn((float)(row * g.stride), 0.5f), g.sy), 0.5f);
}

// Full-res frame coordinates -> frame-thumbnail coordinates.
__device__ __forceinline__ void to_thumbnail(const Grid& g, float fx, float fy, float& x, float& y) {
  x = __fsub_rn(__fmul_rn(__fadd_rn(fx, 0.5f), g.inv_fx), 0.5f);
  y = __fsub_rn(__fmul_rn(__fadd_rn(fy, 0.5f), g.inv_fy), 0.5f);
}

// K6: a similarity (a, b, tx, ty) per candidate, verify.warp_coords.
struct SimilarityForm {
  const float *a, *b, *tx, *ty;
  struct Params {
    float a, b, tx, ty;
  };
  __device__ __forceinline__ Params load(int t) const { return {a[t], b[t], tx[t], ty[t]}; }
  __device__ __forceinline__ static void point(const Grid& g, const Params& p, int row, int col,
                                               float& x, float& y) {
    float gx, gy;
    grid_point(g, row, col, gx, gy);
    const float fx = __fadd_rn(__fsub_rn(__fmul_rn(p.a, gx), __fmul_rn(p.b, gy)), p.tx);
    const float fy = __fadd_rn(__fadd_rn(__fmul_rn(p.b, gx), __fmul_rn(p.a, gy)), p.ty);
    to_thumbnail(g, fx, fy, x, y);
  }
};

// K6h: a homography h0..h7 (h8 = 1) per candidate, [n_t, 8] row-major,
// verify.warp_coords_homography.
struct HomographyForm {
  const float* h;
  struct Params {
    float h[8];
  };
  __device__ __forceinline__ Params load(int t) const {
    Params p;
#pragma unroll
    for (int i = 0; i < 8; ++i) p.h[i] = h[8 * t + i];
    return p;
  }
  __device__ __forceinline__ static void point(const Grid& g, const Params& p, int row, int col,
                                               float& x, float& y) {
    float gx, gy;
    grid_point(g, row, col, gx, gy);
    float w = __fadd_rn(__fadd_rn(__fmul_rn(p.h[6], gx), __fmul_rn(p.h[7], gy)), 1.0f);
    w = fabsf(w) > 1e-8f ? w : 1e-8f;
    const float u = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.h[0], gx), __fmul_rn(p.h[1], gy)), p.h[2]), w);
    const float v = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.h[3], gx), __fmul_rn(p.h[4], gy)), p.h[5]), w);
    to_thumbnail(g, u, v, x, y);
  }
};

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

template <class Form>
__global__ void __launch_bounds__(THREADS)
warp_sample_kernel(const float* __restrict__ img, int h, int w, Form form, Grid g,
                   float* __restrict__ out) {
  const int t = blockIdx.y, row = blockIdx.x;
  const typename Form::Params p = form.load(t);
  // Outputs [g0, g1) of the flat [T, out_h * out_w] result, in pairs that
  // start at even flat indices; a pair's half outside the row is not stored.
  const int64_t g0 = ((int64_t)t * g.out_h + row) * g.out_w, g1 = g0 + g.out_w;
  for (int64_t e = (g0 & ~int64_t(1)) + 2 * threadIdx.x; e < g1; e += 2 * THREADS) {
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x, y;
      Form::point(g, p, row, (int)(e + j - g0), x, y);
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

template <class Form>
int launch(const void* img, int h, int w, Form form, int n_t, const Grid& g, void* out,
           void* stream) {
  const dim3 grid(g.out_h, n_t);
  warp_sample_kernel<Form><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, form, g, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img [h, w] f32; a, b, tx, ty [n_t] f32; out [n_t, out_h * out_w] f32,
// 8-byte aligned.
extern "C" int slideo_warp_sample(const void* img, int h, int w, const void* a, const void* b,
                                  const void* tx, const void* ty, int n_t, float sx, float sy,
                                  float inv_fx, float inv_fy, int out_h, int out_w, int stride,
                                  void* out, void* stream) {
  const SimilarityForm form{static_cast<const float*>(a), static_cast<const float*>(b),
                            static_cast<const float*>(tx), static_cast<const float*>(ty)};
  return launch(img, h, w, form, n_t, Grid{sx, sy, inv_fx, inv_fy, out_h, out_w, stride}, out,
                stream);
}

// img [h, w] f32; hparams [n_t, 8] f32 contiguous; out [n_t, out_h * out_w]
// f32, 8-byte aligned.
extern "C" int slideo_warp_sample_homography(const void* img, int h, int w, const void* hparams,
                                             int n_t, float sx, float sy, float inv_fx,
                                             float inv_fy, int out_h, int out_w, int stride,
                                             void* out, void* stream) {
  const HomographyForm form{static_cast<const float*>(hparams)};
  return launch(img, h, w, form, n_t, Grid{sx, sy, inv_fx, inv_fy, out_h, out_w, stride}, out,
                stream);
}
