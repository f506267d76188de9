// K1 and K2: FAST-9/16 corner score + 3x3 non-maximum suppression over a bf16 atlas.
//
// Replaces slideo_tpu/ops/pallas_fast.py:fast_scores_pallas (bodies _kernel
// and _compute_chunk), which streams row bands of the pyramid atlas through
// VMEM. Contract (bit-equal to ops/fast.py nms3x3(fast_scores(...))):
//   d_i   = bf16_rne(tap_i - c)          (f32 difference, rounded to bf16)
//   score = max(max_s min_{j<9} d_{s+j}, -min_s max_{j<9} d_{s+j})
//   score = score > threshold ? score : 0; 0 on the 3 px image ring
//   out   = score >= max(8 neighbours) ? score : 0
//
// What bounds it on the card: each pixel reads 16 circle taps and 8 NMS
// neighbours, so a naive kernel is bound by global loads (24 reads/pixel).
// Design: one block owns a TH x TW tile of output pixels. It copies the tile
// plus a 4 px halo (3 for the circle, 1 for NMS) from the bf16 atlas into
// shared memory once, computes the score of the tile plus a 1 px ring into a
// second shared array, then applies NMS from shared memory. Global traffic
// is ~2 bytes in + 4 bytes out per pixel; the 2 x 16 x 9 min/max per pixel
// run from shared memory and registers. The TPU kernel's compass pretest
// (sparse_skip) is not ported: it only skips work, and the tile form has
// no per-chunk grid step for it to skip.
//
// K2 (slideo_fast_nms_batch) replaces slideo_tpu/ops/pallas_fast.py:
// fast_scores_pallas_batch, K1 over a [B, H, W] batch in one launch: the
// same kernel with a third grid dimension, blockIdx.z selecting the frame
// (64-bit frame offsets: a 64-frame 1080p atlas batch is 477 M pixels), so
// each frame's map is bit-equal to K1's. Bound: the same per-pixel work,
// B times; one launch instead of B saves B - 1 launch overheads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // tile width (one warp per row)
constexpr int TH = 16;  // tile height
constexpr int HALO = 4;

__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float fast_score(const float (*px)[TW + 2 * HALO], int r, int c) {
  const float center = px[r][c];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float diff = __fsub_rn(px[r + kCircleDy[i]][c + kCircleDx[i]], center);
    d[i] = __bfloat162float(__float2bfloat16_rn(diff));
  }
  float bright = -CUDART_INF_F;  // max_s min over the 9-arc
  float dark = CUDART_INF_F;     // min_s max over the 9-arc
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = d[s], mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(s + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = fmaxf(bright, mn);
    dark = fminf(dark, mx);
  }
  return fmaxf(bright, -dark);
}

__global__ void fast_nms_kernel(const __nv_bfloat16* __restrict__ img,
                                float* __restrict__ out, int h, int w,
                                float threshold) {
  __shared__ float px[TH + 2 * HALO][TW + 2 * HALO];
  __shared__ float sc[TH + 2][TW + 2];
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  img += frame;
  out += frame;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  for (int i = tid; i < (TH + 2 * HALO) * (TW + 2 * HALO); i += nthreads) {
    const int r = i / (TW + 2 * HALO), c = i % (TW + 2 * HALO);
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = __bfloat162float(img[(int64_t)gy * w + gx]);
    px[r][c] = v;
  }
  __syncthreads();

  // Scores of the tile plus a 1 px ring; sc[r][c] is pixel (y0-1+r, x0-1+c).
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthreads) {
    const int r = i / (TW + 2), c = i % (TW + 2);
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float s = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      s = fast_score(px, r + HALO - 1, c + HALO - 1);
      s = s > threshold ? s : 0.0f;
    }
    sc[r][c] = s;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= h || gx >= w) return;
  const int r = threadIdx.y + 1, c = threadIdx.x + 1;
  const float s = sc[r][c];
  float neigh = -CUDART_INF_F;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      if (dy != 0 || dx != 0) neigh = fmaxf(neigh, sc[r + dy][c + dx]);
  out[(int64_t)gy * w + gx] = s >= neigh ? s : 0.0f;
}

}  // namespace

extern "C" int slideo_fast_nms(const void* img, void* out, int h, int w,
                               float threshold, void* stream) {
  dim3 block(TW, TH);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(img), static_cast<float*>(out), h, w,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slideo_fast_nms_batch(const void* imgs, void* out, int b, int h,
                                     int w, float threshold, void* stream) {
  dim3 block(TW, TH);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(imgs), static_cast<float*>(out), h, w,
      threshold);
  return static_cast<int>(cudaGetLastError());
}
