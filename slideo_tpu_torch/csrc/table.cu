// K5 (modes a and c): exact per-(query, slide) best dot product and first arg-best,
// on the int8 tensor cores.
//
// Replaces slideo_tpu/ops/pallas_table.py:match_table_scores_pallas in its
// int8 / transposed / with-argmax mode (_kernel_t), the exact match table of
// decks up to screen_above_slides, and stage 2 of screened decks over a
// frame's candidate slides; launched on an index shard it serves the
// non-transposed mode (c) of the index-parallel step. Over the first n_slots
// slots of each slide it also serves the per-frame stage-1 rule's table
// (hamming.py:288 reached from _screen_slides, :774) at a prefix of 128 <
// screen_bits <= 256 bits, the query zero past the prefix and arg unread.
// Contract, bit-equal to ops/hamming.match_table (at n_slots = K):
//   slide(c)       = slide_list ? slide_list[c] : c     (column c of the table)
//   score[q, c, k] = valid[s*K + k] ? <query[q], desc[s*K + k]> : -2^30,
//                    s = slide(c), k < n_slots <= K (the row stride)
//   best[q, c]     = max_k score   (as float32; exact, |score| <= 2^30)
//   arg[q, c]      = the FIRST k attaining it (XLA's argmax; Mosaic's is last)
// The slide list replaces the JAX package's sub-index copy
// (hamming.sub_index_for_slides), and the slot count its prefix index
// (hamming.py:762-773): the kernel reads the candidate slides' rows, and
// the first n_slots of them, in place.
// Descriptors are +-1 int8 and invalid query rows are all zero, so a dot is
// an exact small integer. XOR+popcount on packed bits is not used: packed
// bits cannot represent the zero rows.
//
// What bounds it on the card: 2*Q*S*K*256 int8 operations (25.8 G MAC at
// Q=768, S=64, K=2048) against ~S*K*257 bytes of index: compute-bound, so the
// dots run on the int8 tensor cores (mma.sync m16n8k32 s8.s8.s32), not on
// __dp4a, whose ceiling at this size is ~0.39 ms on 132 SMs.
// Design: one block of 4 warps per (64-query tile, table column), query
// tiles fastest in launch order, so the blocks of one slide run together and
// its 512 KB of descriptors stay in L2 across query tiles. A 64-query tile
// gives 192 blocks even for the 16-column stage 2 at Q=768 (a 128-query tile
// would leave most of the 132 SMs idle there). Warp w holds query rows
// 32*(w&1)..+31 as A fragments for all 8 k-steps in registers (64 registers,
// loaded once with ldmatrix) and multiplies them with slots 32*(w>>1)..+31
// of each 64-slot tile. The slide's descriptor rows (slot-major, 256 B: the
// .col B operand as they lie) stream through a 3-stage shared-memory ring by
// cp.async.cg 16-byte copies and are read with ldmatrix; rows are padded to
// 272 B so that the 8 rows of an ldmatrix hit 8 distinct bank groups. The
// k-steps run outermost over 8 independent accumulator chains (4 slot groups
// x 2 query halves), so consecutive mma do not wait for each other. The
// int32 accumulators are masked by `valid` and folded into a running best
// per row as packed (score, slot) keys, whose integer max is the tie rule:
// the larger score or, on equal scores, the smaller slot. That total order
// makes the result independent of the reduction order (quad shuffles, then
// the two slot-half warps through shared memory). Only [Q, C] is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "int8_mma.cuh"

namespace {

constexpr int D = 256;                 // int8 elements (bytes) per descriptor row
constexpr int LDS = D + 16;            // padded shared-memory row (bytes)
constexpr int CHUNKS = D / 16;         // 16-byte copies per row
constexpr int QT = 64;                 // queries per block
constexpr int NT = 64;                 // slots per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;           // 4 warps: 2 query halves x 2 slot halves
constexpr int KSTEPS = D / 32;         // mma k-steps of 32 bytes
constexpr int SMEM_BYTES = (QT + STAGES * NT) * LDS;   // 69,632 B
constexpr int NEG = -(1 << 30);        // invalid-slot score (hamming._NEG)
constexpr int kIntMin = -2147483647 - 1;
constexpr int NG = NT / 2 / 8;         // 8-slot groups of a warp's half stage
constexpr int BIAS = 512;              // added to every dot: keys of valid slots stay > 0
constexpr int SLOT_MASK = 0xFFFF;      // slots (n_slots + NT - 1 of them) fit 16 bits
constexpr int MAX_SLOTS = SLOT_MASK + 1 - (NT - 1);
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(THREADS)
match_table_kernel(const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
                   const uint8_t* __restrict__ valid, int n_slides, int n_cols,
                   int k_per_slide, int n_slots, const int* __restrict__ slide_list,
                   float* __restrict__ best_out, int* __restrict__ arg_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem;                  // [QT][LDS] query tile
  uint8_t* ring = smem + QT * LDS;     // [STAGES][NT][LDS] descriptor tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int q0 = blockIdx.x * QT;
  const int col = blockIdx.y;
  const int slide = slide_list ? slide_list[col] : col;
  // A slide id out of range is a caller's bug. Trapping makes it a CUDA
  // error at the next synchronisation instead of a table read from another
  // slide's rows (a clamp) or from outside the index; checking on the host
  // would cost a device-to-host sync per call and stall every mesh thread.
  if (slide < 0 || slide >= n_slides) __trap();
  const int64_t row0 = (int64_t)slide * k_per_slide;
  const int8_t* dslide = desc + row0 * D;
  const uint8_t* vslide = valid + row0;
  const int n_tiles = (n_slots + NT - 1) / NT;

  // The query tile (rows past nq zero-filled) rides in the first copy group.
  for (int i = tid; i < QT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = q0 + r < nq;
    cp_async16(smem_addr(qs + r * LDS + c * 16), query + (int64_t)(in ? q0 + r : q0) * D + c * 16,
               in);
  }
  auto load_tile = [&](int tile, int stage) {
    uint8_t* dst = ring + stage * NT * LDS;
    const int k0 = tile * NT;
    for (int i = tid; i < NT * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool in = k0 + r < n_slots;
      cp_async16(smem_addr(dst + r * LDS + c * 16), dslide + (int64_t)(in ? k0 + r : 0) * D + c * 16,
                 in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int wm = (warp & 1) * 32;          // this warp's query rows in the tile
  const int wn = (warp >> 1) * (NT / 2);   // and its slots in each stage

  // A fragments: ldmatrix lane i addresses row (i & 7) + 8 * ((i >> 3) & 1)
  // of the 16-row tile, 16-byte chunk (i >> 4) of the 32-byte k-step.
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t a[2][KSTEPS][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      ldmatrix_x4(smem_addr(qs + (wm + 16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS +
                            (2 * ks + (lane >> 4)) * 16),
                  a[m][ks]);

  // Running best key of rows wm + 16*(r>>1) + 8*(r&1) + g, r = 0..3. A key
  // packs (score, slot) so that one integer max is the tie rule: a valid
  // slot's key is (dot + BIAS) << 16 | (SLOT_MASK - k), >= 2^24; an invalid
  // slot's is SLOT_MASK - k, below every valid key. Higher score wins, then
  // the lower slot; slots past n_slots (zero-filled, invalid) lose to every
  // slot of the slide.
  int best[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) best[r] = kIntMin;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile > 0) {
      cp_async_wait<STAGES - 2>();   // this tile has landed ...
      __syncthreads();               // ... and every warp is done with tile - 1
    }
    const int next = tile + STAGES - 1;   // refills the stage of tile - 1
    if (next < n_tiles) load_tile(next, next % STAGES);
    cp_async_commit();

    const uint8_t* st = ring + (tile % STAGES) * NT * LDS;
    const int k0 = tile * NT;
    // Validity of this lane's slots k0 + wn + 8*ng + 2t (+1), read before the
    // products so that its latency hides behind them.
    bool ok[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + wn + 8 * ng + 2 * t + j;
        ok[ng][j] = k < n_slots && __ldg(vslide + k) != 0;
      }
    // 8 independent accumulator chains (4 slot groups x 2 query halves),
    // k-steps outermost, so consecutive mma do not wait for each other. The
    // accumulators start at BIAS: a dot lies in [-256, 256].
    int c[NG][2][4];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[ng][m][i] = BIAS;
#pragma unroll
    for (int j = 0; j < KSTEPS / 2; ++j)
#pragma unroll
      for (int ng = 0; ng < NG; ++ng) {
        // Lane i: slot wn + 8ng + (i & 7), 16-byte chunk 4j + (i >> 3): b[0],
        // b[1] are k-step 2j's B fragment, b[2], b[3] k-step 2j+1's.
        uint32_t b[4];
        ldmatrix_x4(smem_addr(st + (wn + 8 * ng + (lane & 7)) * LDS + (4 * j + (lane >> 3)) * 16), b);
        mma_s8(c[ng][0], a[0][2 * j], b[0], b[1]);
        mma_s8(c[ng][1], a[1][2 * j], b[0], b[1]);
        mma_s8(c[ng][0], a[0][2 * j + 1], b[2], b[3]);
        mma_s8(c[ng][1], a[1][2 * j + 1], b[2], b[3]);
      }
    // c[ng][m][2h + j]: row 16m + 8h + g, slot k0 + wn + 8ng + 2t + j.
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int low = SLOT_MASK - (k0 + wn + 8 * ng + 2 * t + j);
          const int key = ok[ng][j] ? (c[ng][r >> 1][2 * (r & 1) + j] << 16) | low : low;
          best[r] = max(best[r], key);
        }
  }
  cp_async_wait<0>();

  // The 4 lanes of a quad hold the same rows.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      best[r] = max(best[r], __shfl_xor_sync(0xffffffffu, best[r], off));
  // The two slot-half warps of a query half meet in shared memory.
  __syncthreads();   // every warp is done with the ring and the query tile
  int* red = reinterpret_cast<int*>(smem);   // [QT]
  if (wn != 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) red[wm + 16 * (r >> 1) + 8 * (r & 1) + g] = best[r];
  }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wm + 16 * (r >> 1) + 8 * (r & 1) + g;
      const int key = max(best[r], red[row]);
      const int q = q0 + row;
      if (q < nq) {
        const int hi = key >> 16;
        best_out[(int64_t)q * n_cols + col] = hi ? (float)(hi - BIAS) : (float)NEG;
        arg_out[(int64_t)q * n_cols + col] = SLOT_MASK - (key & SLOT_MASK);
      }
    }
  }
}

}  // namespace

// query [nq, 256] and desc [n_slides * k_per_slide, 256] int8, both 16-byte
// aligned; 1 <= n_slots <= min(k_per_slide, MAX_SLOTS) (else
// cudaErrorInvalidValue); slide_list: n_cols int32 slide ids, or null for
// columns 0..n_cols-1 (then n_cols == n_slides). An id outside
// [0, n_slides) traps.
extern "C" int slideo_match_table(const void* query, int nq, const void* desc,
                                  const void* valid, int n_slides, int n_cols,
                                  int k_per_slide, int n_slots, const void* slide_list,
                                  void* best, void* arg, void* stream) {
  // Above 48 KB of shared memory needs an opt-in, once per device. Mesh
  // threads launch at once: the flags are atomic, and a repeated opt-in is
  // harmless.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(match_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
  }
  if (n_slots < 1 || n_slots > k_per_slide || n_slots > MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nq + QT - 1) / QT, n_cols);
  match_table_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(query), nq, static_cast<const int8_t*>(desc),
      static_cast<const uint8_t*>(valid), n_slides, n_cols, k_per_slide, n_slots,
      static_cast<const int*>(slide_list), static_cast<float*>(best), static_cast<int*>(arg));
  return static_cast<int>(cudaGetLastError());
}
