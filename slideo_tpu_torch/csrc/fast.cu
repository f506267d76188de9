// K1 and K2: FAST-9/16 corner score + 3x3 non-maximum suppression over a bf16 atlas.
//
// Replaces slideo_tpu/ops/pallas_fast.py:fast_scores_pallas (:286, K1, one
// image) and fast_scores_pallas_batch (:340, K2, a [B, H, W] batch in one
// launch), kernel bodies _kernel and _compute_chunk, in their production
// form (sparse_skip on). Contract, bit-equal to ops/fast.py
// nms3x3(fast_scores(...)):
//   d_i   = bf16_rne(tap_i - c)          (f32 difference, rounded to bf16)
//   score = max(max_s min_{j<9} d_{s+j}, -min_s max_{j<9} d_{s+j})
//   score = score > threshold ? score : 0; 0 on the 3 px image ring
//   out   = score >= max(8 neighbours) ? score : 0
//
// What bounds it on the card depends on the content. A pixel moves 6 bytes
// (2 in, 4 out). On slide content few pixels can be corners, and the kernel
// is a memory pass: its floor is the bytes over the memory rate. On
// corner-dense content (noise, texture) it is bound by the instructions of
// the score, and the design cuts those:
//
// 1. Exact compass pretest, skipped by the warp. A 9-contiguous arc of the
//    16-tap circle holds two adjacent compass taps (positions 0/4, 4/8,
//    8/12, 12/0), so a score above the threshold needs such a pair with
//    both d_i > threshold (bright) or both < -threshold (dark). The test
//    runs on the same rounded d_i as the score, so it is exact for any
//    threshold. Every pixel, the 1 px NMS ring included, takes it (5 shared
//    loads, ~20 instructions); a warp none of whose pixels passes writes
//    zeros and skips the score. Lanes that fail in a warp that goes on get
//    a score <= threshold, which the threshold test zeroes.
// 2. Chains in packed bf16. f(t) = bf16_rne(t - c) is monotone in t, so
//    max_s min_j f(t_{s+j}) = f(max_s min_j t_{s+j}) (and the same for the
//    dark side): the min/max chains run on the raw bf16 taps and the two
//    differences are taken once, after them, instead of 16. Each tap is
//    kept in shared memory as the pair (t, -t) in one __nv_bfloat162, so a
//    min chain yields (min t, -max t) and one packed chain gives both
//    polarities. The circular 9-windows are van Herk/Gil-Werman
//    prefix/suffix chains over two blocks of 8 (pallas_fast.py:201-217):
//    59 __hmin2/__hmax2 (HMNMX2) for both polarities, against 2 x 143 f32
//    min/max for the naive windows.
// 3. Few instructions around the score, few redundant scores, wide memory
//    access. A block of 256 threads owns a 64 x 30 output tile and scores
//    it with its 1 px ring (66 x 32, 1.10x the outputs): each warp walks 8
//    rows of 32 columns, unrolled, so a pixel costs no index arithmetic,
//    and one more step of 8 lanes a warp scores the two ring columns. The
//    halo tile (80 x 38 pixels, 8 columns on each side so that every row is
//    16-byte aligned) is read with 16-byte loads, both of a thread's loads
//    in flight before either is stored, and each thread stores 4
//    NMS outputs, zeros included, with one 16-byte store. A row width that
//    is not a multiple of 8 (4 for the stores), or an unaligned pointer,
//    takes scalar accesses instead. 32 registers a thread let 8 blocks
//    share an SM.
//
// K2 (slideo_fast_nms_batch) is the same kernel with a third grid
// dimension, blockIdx.z selecting the frame (64-bit frame offsets: a
// 64-frame 1080p atlas batch is 477 M pixels), so each frame's map is
// bit-equal to K1's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TW = 64;                // output tile width
constexpr int TH = 30;                // output tile height
constexpr int NTHREADS = 256;         // 8 warps: 2 column halves x 4 row bands
constexpr int PW = TW + 16;           // pixel tile: columns x0-8 .. x0+TW+7
constexpr int PH = TH + 8;            // rows y0-4 .. y0+TH+3
constexpr int SH = TH + 2;            // scored rows y0-1 .. y0+TH
constexpr int BAND = SH / 4;          // scored rows of a warp
constexpr int SCW = TW + 8;           // score array: column 3 is x0-1 (so x0 is 16-byte aligned)
constexpr int GROUPS = TW / 4 * TH;   // 4-output groups of the NMS phase
constexpr unsigned FULL = 0xffffffffu;
static_assert(SH % 4 == 0 && 2 * SH <= 8 * 8, "the ring columns take 8 lanes of each warp");

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, sizeof(r));
  return r;
}

// From a packed (B, -D): max(bf16_rne(B - c), -bf16_rne(D - c)) as f32, both
// roundings in one conversion (-bf16_rne(D - c) = bf16_rne(c + (-D))).
__device__ __forceinline__ float polar_score(__nv_bfloat162 v, float c) {
  const __nv_bfloat162 d =
      __floats2bfloat162_rn(__fsub_rn(__low2float(v), c), __fadd_rn(c, __high2float(v)));
  return fmaxf(__low2float(d), __high2float(d));
}

// max_s min over the circular 9-window starting at s, of the packed taps:
// (max_s min_j t, max_s min_j -t) = (max_s min_j t, -min_s max_j t).
__device__ __forceinline__ __nv_bfloat162 arc_chain(const __nv_bfloat162 (&p)[16]) {
  __nv_bfloat162 suf[16], pre[16];
#pragma unroll
  for (int blk = 0; blk < 16; blk += 8) {
    suf[blk + 7] = p[blk + 7];
#pragma unroll
    for (int s = blk + 6; s >= blk; --s) suf[s] = __hmin2(p[s], suf[s + 1]);
    pre[blk] = p[blk];
#pragma unroll
    for (int j = blk + 1; j < blk + 8; ++j) pre[j] = __hmin2(pre[j - 1], p[j]);
  }
  // window s = suffix of s's block + prefix of the other block up to s + 8.
  __nv_bfloat162 acc = __hmin2(suf[0], pre[8]);
#pragma unroll
  for (int s = 1; s < 16; ++s) acc = __hmax2(acc, __hmin2(suf[s], pre[(s + 8) & 15]));
  return acc;
}

// The thresholded score of the pixel whose packed centre word is p0[0], or 0
// off the image's interior (``inner`` false). Every lane of the warp calls it
// together: the pretest's ballot decides whether the warp scores at all.
__device__ __forceinline__ float score_px(const uint32_t* p0, bool inner, float threshold) {
  const float center = __low2float(as_bf2(p0[0]));
  __nv_bfloat162 p[16];
  p[0] = as_bf2(p0[-3 * PW]);
  p[4] = as_bf2(p0[3]);
  p[8] = as_bf2(p0[3 * PW]);
  p[12] = as_bf2(p0[-3]);
  // Adjacent compass pairs: (max_pair min t, -min_pair max t).
  const __nv_bfloat162 compass = __hmax2(__hmax2(__hmin2(p[0], p[4]), __hmin2(p[4], p[8])),
                                         __hmax2(__hmin2(p[8], p[12]), __hmin2(p[12], p[0])));
  const bool cand = inner && polar_score(compass, center) > threshold;
  if (!__ballot_sync(FULL, cand)) return 0.0f;
  p[1] = as_bf2(p0[-3 * PW + 1]);
  p[2] = as_bf2(p0[-2 * PW + 2]);
  p[3] = as_bf2(p0[-PW + 3]);
  p[5] = as_bf2(p0[PW + 3]);
  p[6] = as_bf2(p0[2 * PW + 2]);
  p[7] = as_bf2(p0[3 * PW + 1]);
  p[9] = as_bf2(p0[3 * PW - 1]);
  p[10] = as_bf2(p0[2 * PW - 2]);
  p[11] = as_bf2(p0[PW - 3]);
  p[13] = as_bf2(p0[-PW - 3]);
  p[14] = as_bf2(p0[-2 * PW - 2]);
  p[15] = as_bf2(p0[-3 * PW - 1]);
  const float v = polar_score(arc_chain(p), center);
  return (cand && v > threshold) ? v : 0.0f;
}

__global__ void __launch_bounds__(NTHREADS, 8)
fast_nms_kernel(const __nv_bfloat16* __restrict__ img, float* __restrict__ out, int h, int w,
                float threshold, int vec_in, int vec_out) {
  // Pixel t as the packed pair (t, -t).
  __shared__ __align__(16) uint32_t px[PH][PW];
  __shared__ __align__(16) float sc[SH][SCW];
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  img += frame;
  out += frame;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Halo tile: chunks of 8 pixels, 16-byte loads where the chunk lies in
  // the image and rows are aligned. Pixels outside the image are 0; only
  // ring pixels, whose scores are zeroed, ever read them.
  constexpr int CHUNKS = PH * (PW / 8);
  constexpr int LOAD_ROUNDS = (CHUNKS + NTHREADS - 1) / NTHREADS;
  uint32_t v[LOAD_ROUNDS][4];
#pragma unroll
  for (int k = 0; k < LOAD_ROUNDS; ++k) {
    const int i = tid + k * NTHREADS;
    const int r = i / (PW / 8), cc = i % (PW / 8);
    const int gy = y0 - 4 + r, gx = x0 - 8 + 8 * cc;
    v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0u;
    if (i < CHUNKS && gy >= 0 && gy < h) {
      const __nv_bfloat16* row = img + static_cast<int64_t>(gy) * w;
      if (vec_in && gx >= 0 && gx + 8 <= w) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + gx));
        v[k][0] = q.x; v[k][1] = q.y; v[k][2] = q.z; v[k][3] = q.w;
      } else {
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          e[j] = (gx + j >= 0 && gx + j < w)
                     ? __ldg(reinterpret_cast<const unsigned short*>(row) + gx + j) : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = e[2 * j] | (static_cast<uint32_t>(e[2 * j + 1]) << 16);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < LOAD_ROUNDS; ++k) {
    const int i = tid + k * NTHREADS;
    if (i >= CHUNKS) break;
    uint32_t pk[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t neg = v[k][j] ^ 0x80008000u;
      pk[2 * j] = __byte_perm(v[k][j], neg, 0x5410);      // (t0, -t0)
      pk[2 * j + 1] = __byte_perm(v[k][j], neg, 0x7632);  // (t1, -t1)
    }
    uint4* dst = reinterpret_cast<uint4*>(&px[i / (PW / 8)][8 * (i % (PW / 8))]);
    dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
  __syncthreads();

  // Scores of the tile's columns: warp (half, band) walks BAND rows of 32
  // columns; scored row r is image row y0-1+r, and sc column 3+c is x0-1+c.
  {
    const int c = 1 + 32 * (warp & 1) + lane;
    const int r0 = BAND * (warp >> 1);
    const int gx = x0 - 1 + c;
    const bool col_ok = gx >= 3 && gx < w - 3;
#pragma unroll
    for (int k = 0; k < BAND; ++k) {
      const int gy = y0 - 1 + r0 + k;
      const float s = score_px(&px[r0 + k + 3][c + 7], col_ok && gy >= 3 && gy < h - 3, threshold);
      sc[r0 + k][c + 3] = s;
    }
  }
  // The 1 px ring columns x0-1 and x0+TW: 8 lanes of each warp.
  {
    const int i = 8 * warp + min(lane, 7);
    const int r = i >> 1, c = (i & 1) ? TW + 1 : 0;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool inner = lane < 8 && gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3;
    const float s = score_px(&px[r + 3][c + 7], inner, threshold);
    if (lane < 8) sc[r][c + 3] = s;
  }
  __syncthreads();

  // NMS: each thread owns groups of 4 adjacent outputs, one 16-byte store.
#pragma unroll 1
  for (int g = tid; g < GROUPS; g += NTHREADS) {
    const int r = g / (TW / 4), c4 = 4 * (g % (TW / 4));
    const int gy = y0 + r, gx = x0 + c4;
    const float4 mid = *reinterpret_cast<const float4*>(&sc[r + 1][c4 + 4]);
    float res[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool any = mid.x != 0.0f || mid.y != 0.0f || mid.z != 0.0f || mid.w != 0.0f;
    if (__ballot_sync(FULL, any)) {
      // Columns c4+3 .. c4+8 of the score rows above, at and below.
      float row[3][6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* src = &sc[r + k][c4 + 3];
        const float4 q = *reinterpret_cast<const float4*>(src + 1);
        row[k][0] = src[0];
        row[k][1] = q.x; row[k][2] = q.y; row[k][3] = q.z; row[k][4] = q.w;
        row[k][5] = src[5];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = row[1][j + 1];
        float neigh = fmaxf(row[1][j], row[1][j + 2]);
#pragma unroll
        for (int d = 0; d < 3; ++d) neigh = fmaxf(neigh, fmaxf(row[0][j + d], row[2][j + d]));
        res[j] = s >= neigh ? s : 0.0f;
      }
    }
    if (gy < h) {
      float* dst = out + static_cast<int64_t>(gy) * w + gx;
      if (vec_out && gx + 4 <= w) {
        *reinterpret_cast<float4*>(dst) = make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gx + j < w) dst[j] = res[j];
      }
    }
  }
}

int launch(const void* img, void* out, int b, int h, int w, float threshold, void* stream) {
  const int vec_in = (w % 8 == 0) && (reinterpret_cast<uintptr_t>(img) % 16 == 0);
  const int vec_out = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  fast_nms_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(img), static_cast<float*>(out), h, w, threshold, vec_in,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int slideo_fast_nms(const void* img, void* out, int h, int w, float threshold,
                               void* stream) {
  return launch(img, out, 1, h, w, threshold, stream);
}

extern "C" int slideo_fast_nms_batch(const void* imgs, void* out, int b, int h, int w,
                                     float threshold, void* stream) {
  return launch(imgs, out, b, h, w, threshold, stream);
}
