// K3+K4: orientation bin + blur-folded steered BRIEF, one block per keypoint.
//
// Replaces both passes of slideo_tpu/ops/pallas_orb.py:orb_descriptors_pallas
// (_kernel_bins: window DMA + moments + _sector32; _kernel_desc_t: per-bin
// table contraction). Contract, per keypoint with patch origin (y0, x0):
//   P      = atlas[y0 .. y0+62, x0 .. x0+62] (bf16 -> f32; beyond the atlas 0)
//   m10    = sum P * disc * (c - 31),  m01 = sum P * disc * (r - 31)   (f32)
//   bin    = _sector32(m10, m01)       (same f32 constants, no FMA contraction)
//   v[s]   = sum_i A[bin][s][i] * sum_j D[bin][s][j] * P[i][j]
//   bit[i] = v[256 + i] > v[i] ? +1 : -1
// A and D are the bf16-rounded blur-folded tent tables, stored compactly:
// each row is a tent convolved with a 7-tap band, so it has at most 8
// consecutive nonzeros: (start, 8 weights).
//
// What bounds it on the card: per keypoint 4 K patch pixels and 512 samples
// of 64 multiply-adds each (~33 K FMA) — tiny. The TPU grouped keypoints by
// bin to batch MXU contractions; on the card that grouping buys nothing, so
// each block is one keypoint: 256 threads stage the patch in shared memory
// (16 KB), reduce the two moments, and each thread then produces one bit
// from its two samples, reading 8 x 8 pixels from shared memory. Summation
// order differs from the MXU's, so bits whose two samples nearly tie may
// flip; the contract's tolerance covers that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 63;
constexpr int HALF = 31;
constexpr int NBITS = 256;
constexpr int NSAMP = 2 * NBITS;
constexpr int TAPS = 8;
constexpr int THREADS = 256;

// Same arithmetic as pallas_orb._sector32: explicit _rn intrinsics keep the
// compiler from contracting a*b+c into an FMA, which would round differently.
__device__ int sector32(float x, float y) {
  int b = 0;
  if (y < 0.0f) { b += 16; x = -x; y = -y; }
  if (x < 0.0f) { b += 8; const float t = x; x = y; y = -t; }
  if (y > x) {
    b += 4;
    const float isq2 = 0.70710677f;  // f32(1/sqrt(2))
    const float nx = __fmul_rn(__fadd_rn(x, y), isq2);
    const float ny = __fmul_rn(__fsub_rn(y, x), isq2);
    x = nx; y = ny;
  }
  const float c8 = 0.9238795f;       // f32(cos(pi/8))
  const float s8 = 0.38268343f;      // f32(sin(pi/8))
  if (y > __fmul_rn(x, 0.41421357f)) {  // f32(tan(pi/8))
    b += 2;
    const float nx = __fadd_rn(__fmul_rn(x, c8), __fmul_rn(y, s8));
    const float ny = __fsub_rn(__fmul_rn(y, c8), __fmul_rn(x, s8));
    x = nx; y = ny;
  }
  if (y > __fmul_rn(x, 0.19891237f)) b += 1;  // f32(tan(pi/16))
  return b;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  }
  return total;  // valid in thread 0 only
}

__device__ __forceinline__ float sample(const float (*p)[PATCH + 1], int as,
                                        const float* aw, int ds,
                                        const float* dw) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    const float* row = p[as + i] + ds;
    float r = 0.0f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) r = fmaf(dw[j], row[j], r);
    v = fmaf(aw[i], r, v);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
orb_describe_kernel(const __nv_bfloat16* __restrict__ atlas, int ha, int wa,
                    const int* __restrict__ y0s, const int* __restrict__ x0s,
                    const int* __restrict__ a_start, const float* __restrict__ a_w,
                    const int* __restrict__ d_start, const float* __restrict__ d_w,
                    int* __restrict__ bins, int8_t* __restrict__ out) {
  __shared__ float p[PATCH][PATCH + 1];
  __shared__ float red[2][THREADS / 32];
  __shared__ int s_bin;
  const int k = blockIdx.x;
  const int y0 = y0s[k], x0 = x0s[k];
  const int t = threadIdx.x;

  float m10 = 0.0f, m01 = 0.0f;
  for (int i = t; i < PATCH * PATCH; i += THREADS) {
    const int r = i / PATCH, c = i % PATCH;
    const int gy = y0 + r, gx = x0 + c;
    float v = 0.0f;
    if (gy >= 0 && gy < ha && gx >= 0 && gx < wa) v = __bfloat162float(atlas[(int64_t)gy * wa + gx]);
    p[r][c] = v;
    const int dy = r - HALF, dx = c - HALF;
    if (dy * dy + dx * dx <= HALF * HALF) {
      m10 += v * (float)dx;
      m01 += v * (float)dy;
    }
  }
  m10 = block_sum(m10, red[0]);
  m01 = block_sum(m01, red[1]);
  if (t == 0) {
    const int b = sector32(m10, m01);
    s_bin = b;
    bins[k] = b;
  }
  __syncthreads();
  const int b = s_bin;

  const int sa = b * NSAMP + t, sb = sa + NBITS;
  const float va = sample(p, a_start[sa], a_w + (int64_t)sa * TAPS, d_start[sa], d_w + (int64_t)sa * TAPS);
  const float vb = sample(p, a_start[sb], a_w + (int64_t)sb * TAPS, d_start[sb], d_w + (int64_t)sb * TAPS);
  out[(int64_t)k * NBITS + t] = vb > va ? 1 : -1;
}

}  // namespace

extern "C" int slideo_orb_describe(const void* atlas, int ha, int wa,
                                   const void* y0, const void* x0, int k,
                                   const void* a_start, const void* a_w,
                                   const void* d_start, const void* d_w,
                                   void* bins, void* out, void* stream) {
  orb_describe_kernel<<<k, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(atlas), ha, wa,
      static_cast<const int*>(y0), static_cast<const int*>(x0),
      static_cast<const int*>(a_start), static_cast<const float*>(a_w),
      static_cast<const int*>(d_start), static_cast<const float*>(d_w),
      static_cast<int*>(bins), static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
