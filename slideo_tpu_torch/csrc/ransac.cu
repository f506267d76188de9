// RANSAC similarity fits of C candidates in one call: hypotheses, their
// scores, the first best and its least-squares refinements.
//
// Replaces no TPU kernel: the JAX package leaves ransac_similarity to XLA
// (slideo_tpu/ops/ransac.py:106-182, two lax.scans fused under jit). The
// port ran it as a chain of ~580 small eager PyTorch ops a frame (forming
// the hypotheses, scoring them over [C, 500, M] temporaries, then 10
// refinements of ~50 ops each); on a host shared by several processes that
// dispatch, not the card, set the time. This kernel computes the same
// function, ops/ransac.ransac_similarity_plain, in two launches of one
// C call:
//   hyp_ok(h) = den(h) > 1e-9 and i0(h) != i1(h) and n_valid >= 2, with
//               i_k(h) = min(int(u[h, k] * n_valid), max(n_valid - 1, 0))
//   count(h)  = hyp_ok(h) ? #{i : err2(t_h, i) < thr^2 and valid[i]} : -1
//   winner    = the lowest h of the highest count over the first n_used
//               draws (n_used = min(max(H // 500, 1) * 500, H)); zeros if
//               every count is -1; found = count(winner) >= 2
//   10 times: t = fit_weighted(inliers of t) where that fit is ok and found
//   inliers = inliers of t and found; rating = their number.
//
// What bounds it on the card: operations, and at these sizes latency. C =
// 16-40 candidates x 500 hypotheses x M = 512 points is 4-10 M point
// tests of ~12 f32 operations (about 2 us at the f32 rate), over 0.5 MB of
// inputs; the refinements are 10 dependent rounds of two block sums. The
// gain is the launches it removes from the host, not device time.
//
// Design. Pass 1 (hypothesis_kernel), grid (ceil(n_used / 32), C): each
// block stages its candidate's points and validity in shared memory (17 B
// a point, M <= 2048: at most 34 KB), counts n_valid with
// __syncthreads_count, and each of its 8 warps fits 4 hypotheses from
// their two points, its lanes striding over the points and counting the
// inliers with __popc(__ballot_sync). Every fit and error test repeats the
// plain version's float32 operations in its order with _rn intrinsics,
// which nvcc cannot contract into FMAs, so counts and transforms are
// bit-equal to torch's separate elementwise kernels. A block's best goes
// out as one packed key per block, (count + 1) << 16 | (0xFFFF - h): the
// larger key is the higher count, then the lower h, so a max over the keys
// keeps the first-best rule whatever order the blocks ran in, with no
// atomics across blocks. Pass 2 (refine_kernel), one block per candidate
// after every hypothesis block (the same stream): the max of its keys,
// the winner's transform formed again with the same arithmetic, then the
// 10 refinements. Each refinement's sums (weighted means, then the centred
// sums, the plain version's two passes) are block sums in a fixed order:
// each thread adds its points i = tid, tid + 256, ... in turn, a warp's
// lanes fold by __shfl_xor_sync at 16, 8, 4, 2, 1, and the 8 warp sums
// are added in warp order. A rerun is bit-identical; against torch's
// reductions the sums differ in rounding only. The final mask and rating
// come from the same block. The kernel allocates nothing and does not
// synchronise; the wrapper (ops/cuda_ransac.py) allocates the outputs and
// the per-block keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HYP_WARPS = 8;                               // warps of a hypothesis block
constexpr int HYP_PER_WARP = 4;                            // hypotheses a warp fits in turn
constexpr int HYP_PER_BLOCK = HYP_WARPS * HYP_PER_WARP;
constexpr int REFINE_THREADS = 256;
constexpr int REFINE_WARPS = REFINE_THREADS / 32;
constexpr int MAX_POINTS = 2048;                           // M: 4 floats + 1 byte a point staged
constexpr int MAX_HYPOTHESES = 0xFFFF;                     // h fits the key's low 16 bits
constexpr float DEN_MIN = 1e-9f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(MAX_POINTS / REFINE_THREADS <= 32, "a thread's inlier flags fit one 32-bit mask");

struct Sim {
  float a, b, tx, ty;
};

// A candidate's points in shared memory: slide points (sx, sy), frame
// points (dx, dy), validity.
struct Points {
  const float *sx, *sy, *dx, *dy;
  const unsigned char* valid;
};

__host__ __device__ constexpr size_t points_bytes(int m) { return static_cast<size_t>(m) * 17; }

// Stage candidate c's [M, 2] points and [M] validity; returns n_valid.
// Every thread of the block calls it; it ends in a barrier.
__device__ int stage(const float* src, const float* dst, const unsigned char* valid, int m, int c,
                     Points& p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + m;
  float* dx = sy + m;
  float* dy = dx + m;
  unsigned char* v = reinterpret_cast<unsigned char*>(dy + m);
  const float* s = src + static_cast<size_t>(c) * m * 2;
  const float* d = dst + static_cast<size_t>(c) * m * 2;
  const unsigned char* vc = valid + static_cast<size_t>(c) * m;
  int n_valid = 0;
  for (int i0 = 0; i0 < m; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool ok = false;
    if (i < m) {
      sx[i] = s[2 * i];
      sy[i] = s[2 * i + 1];
      dx[i] = d[2 * i];
      dy[i] = d[2 * i + 1];
      v[i] = vc[i];
      ok = vc[i] != 0;
    }
    n_valid += __syncthreads_count(ok);
  }
  __syncthreads();
  p = Points{sx, sy, dx, dy, v};
  return n_valid;
}

// min(int(u * n_valid), max(n_valid - 1, 0)): the product in f32, cut
// toward zero.
__device__ __forceinline__ int draw_index(float u, int n_valid) {
  return min(static_cast<int>(__fmul_rn(u, static_cast<float>(n_valid))), max(n_valid - 1, 0));
}

// torch.clamp(x, min=1e-9): a NaN stays NaN.
__device__ __forceinline__ float clamp_den(float x) { return x < DEN_MIN ? DEN_MIN : x; }

// ransac._fit_two_points for the pair (i0, i1); ok: den > 1e-9.
__device__ __forceinline__ Sim fit_two(const Points& p, int i0, int i1, bool& ok) {
  const float p0x = p.sx[i0], p0y = p.sy[i0], q0x = p.dx[i0], q0y = p.dy[i0];
  const float dpx = __fsub_rn(p.sx[i1], p0x), dpy = __fsub_rn(p.sy[i1], p0y);
  const float dqx = __fsub_rn(p.dx[i1], q0x), dqy = __fsub_rn(p.dy[i1], q0y);
  const float den = __fadd_rn(__fmul_rn(dpx, dpx), __fmul_rn(dpy, dpy));
  ok = den > DEN_MIN;
  Sim t;
  t.a = __fdiv_rn(__fadd_rn(__fmul_rn(dqx, dpx), __fmul_rn(dqy, dpy)), clamp_den(den));
  t.b = __fdiv_rn(__fsub_rn(__fmul_rn(dqy, dpx), __fmul_rn(dqx, dpy)), clamp_den(den));
  t.tx = __fsub_rn(q0x, __fsub_rn(__fmul_rn(t.a, p0x), __fmul_rn(t.b, p0y)));
  t.ty = __fsub_rn(q0y, __fadd_rn(__fmul_rn(t.b, p0x), __fmul_rn(t.a, p0y)));
  return t;
}

// ransac._inliers at point i: ((a x - b y) + tx - qx)^2 + ((b x + a y) + ty - qy)^2 < thr2.
__device__ __forceinline__ bool inlier(const Sim& t, const Points& p, int i, float thr2) {
  const float x = p.sx[i], y = p.sy[i];
  const float ex = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(t.a, x), __fmul_rn(t.b, y)), t.tx), p.dx[i]);
  const float ey = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(t.b, x), __fmul_rn(t.a, y)), t.ty), p.dy[i]);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) < thr2 && p.valid[i];
}

// Pass 1: block (x, c) scores hypotheses x * 32 ... x * 32 + 31 of
// candidate c and writes its best packed key to keys[c, x].
__global__ void __launch_bounds__(HYP_WARPS * 32)
hypothesis_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const unsigned char* __restrict__ valid, const float* __restrict__ u, int m,
                  int n_hyp, int n_used, float thr2, int* __restrict__ keys) {
  __shared__ int block_best;
  const int c = blockIdx.y;
  if (threadIdx.x == 0) block_best = 0;
  Points p;
  const int n_valid = stage(src, dst, valid, m, c, p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int best = 0;
  for (int k = 0; k < HYP_PER_WARP; ++k) {
    const int h = blockIdx.x * HYP_PER_BLOCK + k * HYP_WARPS + warp;
    if (h >= n_used) break;
    const float* uh = u + (static_cast<size_t>(c) * n_hyp + h) * 2;
    const int i0 = draw_index(uh[0], n_valid), i1 = draw_index(uh[1], n_valid);
    bool ok;
    const Sim t = fit_two(p, i0, i1, ok);
    int count = -1;
    if (ok && i0 != i1 && n_valid >= 2) {
      count = 0;
      for (int j = 0; j < m; j += 32) {
        const int i = j + lane;
        count += __popc(__ballot_sync(FULL, i < m && inlier(t, p, i, thr2)));
      }
    }
    best = max(best, ((count + 1) << 16) | (MAX_HYPOTHESES - h));
  }
  if (lane == 0) atomicMax(&block_best, best);
  __syncthreads();
  if (threadIdx.x == 0) keys[static_cast<size_t>(c) * gridDim.x + blockIdx.x] = block_best;
}

// Sum each of v[0..K) over the block, in a fixed order: each thread's own
// sum, the warp's xor fold, then the warp sums in warp order. Every thread
// gets the totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] = __fadd_rn(v[k], __shfl_xor_sync(FULL, v[k], off));
    if (lane == 0) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = red[k];
    for (int w = 1; w < REFINE_WARPS; ++w) s = __fadd_rn(s, red[w * K + k]);
    v[k] = s;
  }
  __syncthreads();  // red is written again by the next call
}

// Pass 2: candidate c's winner, its refinements, the final inliers and
// rating. out [5, C]: a, b, tx, ty, rating.
__global__ void __launch_bounds__(REFINE_THREADS)
refine_kernel(const float* __restrict__ src, const float* __restrict__ dst,
              const unsigned char* __restrict__ valid, const float* __restrict__ u, int m,
              int n_hyp, int n_blocks, float thr2, int n_refine, const int* __restrict__ keys,
              int n_cand, float* __restrict__ out, unsigned char* __restrict__ inliers,
              unsigned char* __restrict__ ok_out, int* __restrict__ winner) {
  __shared__ int best_key;
  __shared__ float red[REFINE_WARPS * 5];
  const int c = blockIdx.x;
  if (threadIdx.x == 0) best_key = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n_blocks; j += REFINE_THREADS)
    atomicMax(&best_key, keys[static_cast<size_t>(c) * n_blocks + j]);
  Points p;
  const int n_valid = stage(src, dst, valid, m, c, p);
  const int count = (best_key >> 16) - 1;
  const int h = MAX_HYPOTHESES - (best_key & 0xFFFF);
  const bool found = count >= 2;
  Sim t{0.f, 0.f, 0.f, 0.f};
  if (count >= 0) {
    const float* uh = u + (static_cast<size_t>(c) * n_hyp + h) * 2;
    bool ok;
    t = fit_two(p, draw_index(uh[0], n_valid), draw_index(uh[1], n_valid), ok);
  }

  // ransac._fit_weighted over the inliers of t (weight 1, the others 0).
  for (int it = 0; it < n_refine; ++it) {
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // w, x, y, qx, qy
    unsigned mask = 0;
    for (int j = 0, i = threadIdx.x; i < m; ++j, i += REFINE_THREADS) {
      if (inlier(t, p, i, thr2)) {
        mask |= 1u << j;
        s[0] = __fadd_rn(s[0], 1.f);
        s[1] = __fadd_rn(s[1], p.sx[i]);
        s[2] = __fadd_rn(s[2], p.sy[i]);
        s[3] = __fadd_rn(s[3], p.dx[i]);
        s[4] = __fadd_rn(s[4], p.dy[i]);
      }
    }
    block_sum(s, red);
    const float wsum = clamp_den(s[0]);
    const float pmx = __fdiv_rn(s[1], wsum), pmy = __fdiv_rn(s[2], wsum);
    const float qmx = __fdiv_rn(s[3], wsum), qmy = __fdiv_rn(s[4], wsum);
    float r[3] = {0.f, 0.f, 0.f};  // den, a's and b's numerators
    for (int j = 0, i = threadIdx.x; i < m; ++j, i += REFINE_THREADS) {
      if (mask >> j & 1u) {
        const float pcx = __fsub_rn(p.sx[i], pmx), pcy = __fsub_rn(p.sy[i], pmy);
        const float qcx = __fsub_rn(p.dx[i], qmx), qcy = __fsub_rn(p.dy[i], qmy);
        r[0] = __fadd_rn(r[0], __fadd_rn(__fmul_rn(pcx, pcx), __fmul_rn(pcy, pcy)));
        r[1] = __fadd_rn(r[1], __fadd_rn(__fmul_rn(qcx, pcx), __fmul_rn(qcy, pcy)));
        r[2] = __fadd_rn(r[2], __fsub_rn(__fmul_rn(qcy, pcx), __fmul_rn(qcx, pcy)));
      }
    }
    block_sum(r, red);
    if (r[0] > DEN_MIN && found) {
      const float a = __fdiv_rn(r[1], r[0]), b = __fdiv_rn(r[2], r[0]);
      t = Sim{a, b, __fsub_rn(qmx, __fsub_rn(__fmul_rn(a, pmx), __fmul_rn(b, pmy))),
              __fsub_rn(qmy, __fadd_rn(__fmul_rn(b, pmx), __fmul_rn(a, pmy)))};
    }
  }

  int n_in = 0;
  for (int i0 = 0; i0 < m; i0 += REFINE_THREADS) {
    const int i = i0 + threadIdx.x;
    const bool in = i < m && found && inlier(t, p, i, thr2);
    if (i < m) inliers[static_cast<size_t>(c) * m + i] = in;
    n_in += __syncthreads_count(in);
  }
  if (threadIdx.x == 0) {
    out[c] = t.a;
    out[n_cand + c] = t.b;
    out[2 * n_cand + c] = t.tx;
    out[3 * n_cand + c] = t.ty;
    out[4 * n_cand + c] = static_cast<float>(n_in);
    ok_out[c] = found;
    winner[c] = count >= 0 ? h : -1;
  }
}

}  // namespace

// src, dst [n_cand, m, 2] f32; valid [n_cand, m] bool (1 byte); u
// [n_cand, n_hyp, 2] f32, all contiguous; 1 <= m <= 2048, n_used <= 65535;
// keys [n_cand, ceil(n_used / 32)] i32 scratch; out [5, n_cand] f32;
// inliers [n_cand, m] bool; ok [n_cand] bool; winner [n_cand] i32 (-1: no
// hypothesis passed).
extern "C" int slideo_ransac(const void* src, const void* dst, const void* valid, const void* u,
                             int n_cand, int m, int n_hyp, int n_used, float thr2, int n_refine,
                             void* keys, void* out, void* inliers, void* ok, void* winner,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = points_bytes(m);
  const int n_blocks = (n_used + HYP_PER_BLOCK - 1) / HYP_PER_BLOCK;
  const float* fsrc = static_cast<const float*>(src);
  const float* fdst = static_cast<const float*>(dst);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const float* fu = static_cast<const float*>(u);
  if (n_blocks > 0) {
    hypothesis_kernel<<<dim3(n_blocks, n_cand), HYP_WARPS * 32, smem, s>>>(
        fsrc, fdst, v, fu, m, n_hyp, n_used, thr2, static_cast<int*>(keys));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refine_kernel<<<n_cand, REFINE_THREADS, smem, s>>>(
      fsrc, fdst, v, fu, m, n_hyp, n_blocks, thr2, n_refine, static_cast<const int*>(keys), n_cand,
      static_cast<float*>(out), static_cast<unsigned char*>(inliers),
      static_cast<unsigned char*>(ok), static_cast<int*>(winner));
  return static_cast<int>(cudaGetLastError());
}
