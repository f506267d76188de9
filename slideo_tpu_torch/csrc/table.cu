// K5 (mode a): exact per-(query, slide) best dot product and first arg-best.
//
// Replaces slideo_tpu/ops/pallas_table.py:match_table_scores_pallas in its
// int8 / transposed / with-argmax mode (_kernel_t), the exact match table of
// decks up to screen_above_slides, and stage 2 of screened decks over a
// frame's candidate slides. Contract, bit-equal to ops/hamming.match_table:
//   slide(c)       = slide_list ? slide_list[c] : c     (column c of the table)
//   score[q, c, k] = valid[s*K + k] ? <query[q], desc[s*K + k]> : -2^30,
//                    s = slide(c)
//   best[q, c]     = max_k score   (as float32; exact, |score| <= 2^30)
//   arg[q, c]      = the FIRST k attaining it (XLA's argmax; Mosaic's is last)
// The slide list replaces the JAX package's sub-index copy
// (hamming.sub_index_for_slides): the kernel reads the candidate slides'
// rows in place.
// Descriptors are +-1 int8 and invalid query rows are all zero, so a dot is
// an exact small integer. XOR+popcount on packed bits is not used: packed
// bits cannot represent the zero rows.
//
// What bounds it on the card: 2*Q*S*K*256 int8 operations (25.8 G MAC at
// Q=768, S=64, K=2048) against ~S*K*256 bytes of index — compute-bound.
// Design: one block per (64-query tile, table column). The query tile stays in
// shared memory; the slide's descriptors stream through shared memory 64
// rows at a time. Each of the 256 threads owns a 4 x 4 block of (query,
// slot) dot products computed with __dp4a on packed int8 words, folds them
// into a running max / first argmax per query, and the 16 threads sharing a
// query reduce with warp shuffles. Scores never leave the SM; only the
// [Q, S] result is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 64;         // 256 int8 = 64 packed int32 words
constexpr int QT = 64;            // queries per block
constexpr int KT = 64;            // index slots per shared-memory chunk
constexpr int LD = WORDS + 1;     // padded row: conflict-free column reads
constexpr int NEG = -(1 << 30);   // invalid-slot score (hamming._NEG)
constexpr int kIntMin = -2147483647 - 1;

__device__ __forceinline__ void load_rows(int (*dst)[LD], const int* __restrict__ src,
                                          int rows_avail, int tid) {
  // 64 rows x 16 int4 per row; 256 threads -> 4 int4 each.
  for (int i = tid; i < 64 * (WORDS / 4); i += 256) {
    const int r = i / (WORDS / 4), c4 = i % (WORDS / 4);
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows_avail) v = reinterpret_cast<const int4*>(src + (int64_t)r * WORDS)[c4];
    dst[r][c4 * 4 + 0] = v.x;
    dst[r][c4 * 4 + 1] = v.y;
    dst[r][c4 * 4 + 2] = v.z;
    dst[r][c4 * 4 + 3] = v.w;
  }
}

__global__ void __launch_bounds__(256)
match_table_kernel(const int* __restrict__ query, int nq,
                   const int* __restrict__ desc, const uint8_t* __restrict__ valid,
                   int n_cols, int k_per_slide, const int* __restrict__ slide_list,
                   float* __restrict__ best_out, int* __restrict__ arg_out) {
  __shared__ int qs[QT][LD];
  __shared__ int ds[KT][LD];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int q0 = blockIdx.x * QT;
  const int col = blockIdx.y;
  const int slide = slide_list ? slide_list[col] : col;
  const int64_t row0 = (int64_t)slide * k_per_slide;

  load_rows(qs, query + (int64_t)q0 * WORDS, nq - q0, tid);

  int best[4], arg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { best[i] = kIntMin; arg[i] = 0; }

  for (int kc = 0; kc < k_per_slide; kc += KT) {
    __syncthreads();  // previous chunk fully consumed (and qs loaded)
    load_rows(ds, desc + (row0 + kc) * WORDS, k_per_slide - kc, tid);
    __syncthreads();
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 8
    for (int w = 0; w < WORDS; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // ascending slot order: strict > keeps the first
      const int k = kc + tx + 16 * j;
      if (k >= k_per_slide) continue;
      const bool ok = valid[row0 + k] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ok ? acc[i][j] : NEG;
        if (s > best[i]) { best[i] = s; arg[i] = k; }
      }
    }
  }

  // Reduce over the 16 threads (tx) that share each query row.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (ob > best[i] || (ob == best[i] && oa < arg[i])) { best[i] = ob; arg[i] = oa; }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < nq) {
        best_out[(int64_t)q * n_cols + col] = (float)best[i];
        arg_out[(int64_t)q * n_cols + col] = arg[i];
      }
    }
  }
}

}  // namespace

// slide_list: n_cols int32 slide ids, or null for columns 0..n_cols-1.
extern "C" int slideo_match_table(const void* query, int nq, const void* desc,
                                  const void* valid, int n_cols,
                                  int k_per_slide, const void* slide_list,
                                  void* best, void* arg, void* stream) {
  dim3 block(16, 16);
  dim3 grid((nq + QT - 1) / QT, n_cols);
  match_table_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(query), nq, static_cast<const int*>(desc),
      static_cast<const uint8_t*>(valid), n_cols, k_per_slide,
      static_cast<const int*>(slide_list), static_cast<float*>(best),
      static_cast<int*>(arg));
  return static_cast<int>(cudaGetLastError());
}
