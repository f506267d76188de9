// K5 (mode b): stage-1 screening scores, the best 128-bit prefix dot product
// of every (query, slide).
//
// Replaces slideo_tpu/ops/pallas_table.py:match_table_scores_pallas in its
// int8 / transposed / max-only / skip_bias mode, as
// slideo_tpu/ops/hamming.py:screen_slides_batched calls it. Contract,
// bit-equal to that call on the index's screening tensor:
//   score[r, s, k] = valid[s*K + k] ? <query[r, :128], desc[s*K + k, :128]> : -254
//   best[r, s]     = max_k score   (int32, exact)
// The TPU kernel reads a second copy of the index, screen_desc [S, 160, K]:
// the 128 prefix rows plus two -127 validity rows that meet two +1 query
// columns, so an invalid slot scores exactly -254 inside the contraction.
// This kernel reads the prefix in place instead: the first 128 bytes of each
// 256-byte row of the port's row-major desc [S*K, 256], and valid [S*K]. It
// computes the same numbers without a second index tensor (164 MB at 500
// slides x 2048 slots) and writes -254 for an invalid slot directly.
// Invalid query rows are all zero and score 0 against every valid slot, as
// on the TPU: __dp4a on int8 keeps them exact, packed bits would not.
//
// What bounds it on the card: 2*R*S*K*128 int8 operations (4.3 T at
// R = 64 frames x 256 queries, S = 500, K = 2048) against ~S*K*128 bytes
// of prefixes: compute-bound, at the int8 tensor-core rate.
// Design (a first, right kernel; tensor cores are later work): one block per
// (64-query tile, slide). The query tile stays in shared memory; the slide's
// prefixes stream through shared memory 64 slots at a time. Each of the 256
// threads owns a 4 x 4 block of (query, slot) dot products, reads both
// operands as 16-byte vectors (rows padded to 36 words: conflict-free
// 128-bit reads) and computes them with __dp4a, folds them into a running
// max per query, and the 16 threads sharing a query reduce with warp
// shuffles. Only the [R, S] result is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 32;           // 128 int8 prefix = 32 packed int32 words
constexpr int ROW_WORDS = 64;       // a desc row is 256 int8 = 64 words
constexpr int QT = 64;              // queries per block
constexpr int KT = 64;              // index slots per shared-memory chunk
constexpr int LD = WORDS + 4;       // padded row, 16-byte aligned
constexpr int INVALID = -254;       // two -127 validity rows x two +1 columns
constexpr int kIntMin = -2147483647 - 1;

// rows x 8 int4 from a source whose rows are `stride` words apart.
__device__ __forceinline__ void load_prefix(int (*dst)[LD], const int* __restrict__ src,
                                            int stride, int rows_avail, int tid) {
  for (int i = tid; i < 64 * (WORDS / 4); i += 256) {
    const int r = i / (WORDS / 4), c4 = i % (WORDS / 4);
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows_avail) v = reinterpret_cast<const int4*>(src + (int64_t)r * stride)[c4];
    *reinterpret_cast<int4*>(&dst[r][c4 * 4]) = v;
  }
}

__device__ __forceinline__ int dot4(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__global__ void __launch_bounds__(256)
screen_kernel(const int* __restrict__ query, int nq,
              const int* __restrict__ desc, const uint8_t* __restrict__ valid,
              int n_slides, int k_per_slide, int* __restrict__ best_out) {
  __shared__ __align__(16) int qs[QT][LD];
  __shared__ __align__(16) int ds[KT][LD];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int q0 = blockIdx.x * QT;
  const int slide = blockIdx.y;
  const int64_t row0 = (int64_t)slide * k_per_slide;

  load_prefix(qs, query + (int64_t)q0 * WORDS, WORDS, nq - q0, tid);

  int best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = kIntMin;

  for (int kc = 0; kc < k_per_slide; kc += KT) {
    __syncthreads();  // previous chunk fully consumed (and qs loaded)
    load_prefix(ds, desc + (row0 + kc) * ROW_WORDS, ROW_WORDS, k_per_slide - kc, tid);
    __syncthreads();
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll
    for (int w = 0; w < WORDS; w += 4) {
      int4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const int4*>(&qs[ty + 16 * i][w]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const int4*>(&ds[tx + 16 * j][w]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc + tx + 16 * j;
      if (k >= k_per_slide) continue;
      const bool ok = valid[row0 + k] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = max(best[i], ok ? acc[i][j] : INVALID);
    }
  }

  // Reduce over the 16 threads (tx) that share each query row.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      best[i] = max(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < nq) best_out[(int64_t)q * n_slides + slide] = best[i];
    }
  }
}

}  // namespace

// query [nq, 128] int8; desc [n_slides * k_per_slide, 256] int8;
// valid [n_slides * k_per_slide] uint8; best [nq, n_slides] int32.
extern "C" int slideo_screen(const void* query, int nq, const void* desc,
                             const void* valid, int n_slides, int k_per_slide,
                             void* best, void* stream) {
  dim3 block(16, 16);
  dim3 grid((nq + QT - 1) / QT, n_slides);
  screen_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(query), nq, static_cast<const int*>(desc),
      static_cast<const uint8_t*>(valid), n_slides, k_per_slide,
      static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}
