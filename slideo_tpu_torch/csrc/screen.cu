// K5 (mode b): stage-1 screening scores, the best P-byte prefix dot product
// of every (query, slide), on the int8 tensor cores.
//
// Replaces slideo_tpu/ops/pallas_table.py:match_table_scores_pallas in its
// int8 / transposed / max-only modes, at four call sites of
// slideo_tpu/ops/hamming.py: the batched rule's single-stage sweep (:595),
// its strided pre-vote (:564) and its re-vote over each frame's own slide
// list (:584), all at 128-bit prefixes over full K; and the per-frame rule
// (_screen_slides, :733-782), which reaches the table call at :288 with
// the prefix index desc_t[:, :screen_bits, :ksk] (D = screen_bits, K =
// ksk = min(screen_k_per_slide, K)). Contract, bit-equal to those calls on
// the index's screening tensor (and to the gathered sub-tensors of
// :572-586 and :762-773):
//   slide(g, c)       = slide_ids ? slide_ids[g, c] : c
//   score[r, c, j]    = valid[s*K + j*stride] ? <query[r, :P], desc[s*K + j*stride, :P]> : -254
//                       with s = slide(r / rows_per_group, c), j < n_slots
//   best[r, c]        = max_j score   (int32, exact)
// P is 128 or 64 bytes (a prefix of another width up to 128 runs at the next
// of the two with the query's columns past it zero, which adds nothing to a
// dot) and n_slots <= K / stride. One group (rows_per_group = R), stride 1,
// no list, n_slots = K and P = 128 is the batched single stage; stride 4
// over every slide is the pre-vote; groups of a frame's rows, each against
// its own P listed slides, is the re-vote; one group over the first n_slots
// slots of every slide at P = 64 or 128 is the per-frame rule.
// The TPU kernel reads a second copy of the index, screen_desc [S, 160, K]:
// the 128 prefix rows plus two -127 validity rows that meet two +1 query
// columns, so an invalid slot scores exactly -254 inside the contraction;
// the pre-vote slices its slot axis with a stride and the re-vote gathers
// each frame's P slides into a copy. The per-frame rule's call adds a bias
// of -1e6 on invalid slots instead, which changes only the best of a slide
// with no valid slot among its first n_slots, a slide its vote masks. This
// kernel reads the prefix in place instead: the first P bytes of each
// 256-byte row of the port's row-major desc [S*K, 256], and valid [S*K], at
// the rows a column names, with no copy. A dot lies in [-128, 128], so a
// slide with a valid slot has its best among the valid slots and one with
// none scores -254: the running max takes valid slots only, and a max that
// took none is written as -254. Invalid query rows are all zero and score 0
// against every valid slot, as on the TPU (int8 keeps them exact; packed
// bits would not).
//
// What bounds it on the card: 2*R*S*K*128 int8 operations (4.3 T at
// R = 64 frames x 256 queries, S = 500, K = 2048: 2.17 ms at 1,979 TOP/s)
// against S*K*129 bytes of prefixes and validity read once from device
// memory (132 MB, 0.04 ms): the int8 tensor-core rate. Two more limits
// follow from the tiling. (1) L2 -> shared-memory traffic: each block
// streams its slide's 2048 x 128 B prefixes, so a query tile of QT rows
// reads R/QT * S * K * 128 B from L2 per call (8.4 GB at QT = 256, R =
// 16,384; 33 GB at the earlier 64-query tile). (2) Shared-memory reads: a
// B fragment read by ldmatrix feeds as many mma as the warp holds query
// tiles of 16 rows. One frame of the per-frame rule (R = 256) is bound by
// its bytes instead: S*n_slots*(P+1), 33.0 MB at 500 x 512 slots x 128 B
// (0.0099 ms) and 66.6 MB at 500 x 2048 x 64 B (0.020 ms).
// Design: one block of 4 warps per (256-query tile, column), query tiles
// fastest in launch order, so the blocks of one slide run together and its
// prefixes come from device memory once (a column is a slide, or in the
// listed form the slide that the tile's group lists there). One frame (R = 256) is one tile
// and gives 500 blocks. Each warp holds 64 query rows, the most that fit,
// as A fragments of mma.sync m16n8k32 s8 in registers (4 m-tiles x 4
// k-steps x 4 = 64 registers at P = 128, loaded once from global memory),
// so each ldmatrix_x4 of slot data (8 slots x 2 k-steps) feeds 8 mma. The
// slide's prefixes stream through a 4-stage ring of 64-slot tiles by
// cp.async.cg 16-byte copies (P / 16 a row at the 256-byte row stride;
// slots past n_slots zero-filled), into rows padded to P + 16 bytes (144 B
// at P = 128, 80 B at P = 64) so that the 8 rows of an ldmatrix start at
// 16-byte units 9i resp. 5i mod 8, 8 distinct bank groups. Every warp
// multiplies its rows with all 64 slots of a tile, 16 slots at a time as 8
// independent accumulator chains (2 slot groups x 4 m-tiles) of P / 32
// k-steps. Validity comes as two 32-bit ballots a tile (each lane loads 2
// bytes one tile ahead); slots at or past n_slots count as invalid, so the
// zero-filled rows of a ragged last tile never enter the max. Each thread
// folds its accumulators into a running max of its 8 rows; a quad shuffle
// finishes the max and only [R, S] is written. An int32 max is exact in
// any order. The body is a template on the k-steps a row has (P / 32): at
// P = 64 a warp holds half the A-fragment registers (32) and a tile half
// the copies.
// ptxas gives 128 registers and no spill, so 4 blocks (16 warps) fit an
// SM. A 512-query tile (8 warps) at R >= 8,192, which halves the L2 reads,
// measured no faster: 5.07-5.10 device ms against this tile's 4.98-4.99 at
// R = 16,384 (chip_smoke.py --compare-screen, NVIDIA H100 80GB HBM3,
// 700.00 W), so the L2 traffic does not bind at this tile.
// The other forms run the same body (screen_body<true, *>) in kernels of
// their own, which read the stride, the row groups, the slide list and
// (the prefix form) the slot count; the single stage's kernel has them as
// constants and keeps its 1,344 SASS instructions and 128 registers
// (PERF.md gives its time beside that of the kernel before these forms).
// The strided and listed forms share screen_general_kernel; the per-frame
// rule's trimmed or 64-byte prefix has screen_prefix_kernel<P / 32>. One
// kernel for all three, the slot count a parameter, moved ptxas's spills
// in the strided and listed forms and slowed them by 4-7% (0.7742-0.7907
// and 0.7781-0.7973 device ms against the parent's 0.7347-0.7561 and
// 0.7420-0.7571 in the same calls; chip_smoke.py --compare-screen, NVIDIA
// H100 80GB HBM3, 700.00 W); with a kernel of their own they keep their
// code (1,560 SASS instructions, 72 B spill). Strided: the ring
// copies rows s*K + j*stride (P of every stride * 256 bytes) and the
// ballots read validity at the same rows; slots past n_slots count as
// invalid. Listed: a block's query tile lies inside one group (tiles are
// counted per group, ceil(rows_per_group / 256), and rows past the
// group's end are zero and not written), so a frame's rows never meet
// another frame's slides; its column names the slide through slide_ids,
// as table.cu's slide list does.
// The pre-vote at R = 64 x 128, stride 4 does 2*R*S*(K/4)*128 = 5.4e11
// operations (0.27 ms); the re-vote at 64 groups of 256 x 64 listed slides
// does 5.5e11 (0.28 ms), its floor: the function needs each distinct slide
// the lists name once (at most 500 x 2048 rows, 132 MB, 0.04 ms), though
// this kernel reads each group's 64 x 2048 rows on its own (1.08 GB from
// L2 or memory; the 131 MB of prefixes do not fit in L2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int ROW = 256;               // bytes of an index row
constexpr int WARP_ROWS = 64;          // query rows a warp holds as A fragments
constexpr int MT = WARP_ROWS / 16;     // m16 tiles of a warp
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * WARP_ROWS;  // queries per block
constexpr int NT = 64;                 // slots per ring stage: two per lane of a ballot
constexpr int STAGES = 4;              // 4 x 64 x 144 B = 36,864 B of static shared memory at P = 128
constexpr int NG = 2;                  // 8-slot groups multiplied between two folds
constexpr int INVALID = -254;          // two -127 validity rows x two +1 columns
constexpr int kIntMin = -2147483647 - 1;

// Bit 0: slot k0 + 2 * lane is valid; bit 1: slot k0 + 2 * lane + 1. Slot j
// is row j * step of the slide; slots past n_slots are not valid.
__device__ __forceinline__ int lane_valid(const uint8_t* __restrict__ vslide, int k0, int lane,
                                          int n_slots, int step) {
  const int k = k0 + 2 * lane;
  int v = 0;
  if (k < n_slots && __ldg(vslide + (int64_t)k * step) != 0) v = 1;
  if (k + 1 < n_slots && __ldg(vslide + (int64_t)(k + 1) * step) != 0) v |= 2;
  return v;
}

// The kernel body over prefixes of kKsteps mma k-steps (P = 32 * kKsteps
// bytes, the query's row length). kGeneral false: the single stage (stride
// 1, one group of nq rows, column = slide, n_slots = K); the other
// arguments are not read.
template <bool kGeneral, int kKsteps>
__device__ __forceinline__ void screen_body(
    const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
    const uint8_t* __restrict__ valid, int k_per_slide, int stride, int slots,
    const int* __restrict__ slide_ids, int n_cols, int rows_per_group, int tiles_per_group,
    int* __restrict__ best_out) {
  constexpr int PREFIX = 32 * kKsteps;   // bytes read of each index row and query row
  constexpr int LDS = PREFIX + 16;       // padded shared-memory row (bytes)
  constexpr int CHUNKS = PREFIX / 16;    // 16-byte copies per row
  constexpr int KSTEPS = kKsteps;
  static_assert(NT * CHUNKS % THREADS == 0, "a tile is whole copies of every thread");
  static_assert(KSTEPS % 2 == 0, "an ldmatrix_x4 reads two k-steps");
  __shared__ __align__(128) uint8_t ring[STAGES][NT][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int col = blockIdx.y;
  int group = 0, qtile = blockIdx.x, n_rows = nq, step = 1, n_slots = k_per_slide, slide = col;
  if constexpr (kGeneral) {
    group = blockIdx.x / tiles_per_group;
    qtile = blockIdx.x - group * tiles_per_group;
    n_rows = rows_per_group;
    step = stride;
    n_slots = slots;
    if (slide_ids != nullptr) slide = __ldg(slide_ids + (int64_t)group * n_cols + col);
  }
  const int64_t row0 = (int64_t)slide * k_per_slide;
  const int8_t* dslide = desc + row0 * ROW;
  const uint8_t* vslide = valid + row0;
  const int n_tiles = (n_slots + NT - 1) / NT;
  const int64_t grow0 = (int64_t)group * n_rows;   // the group's first query row

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * NT;
#pragma unroll
    for (int u = 0; u < NT * CHUNKS / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool in = k0 + r < n_slots;
      cp_async16(smem_addr(&ring[stage][r][c * 16]),
                 dslide + (int64_t)(in ? k0 + r : 0) * step * ROW + c * 16, in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // A fragments of the group's rows qw + 16m + 8h + g: register h holds
  // bytes 4t..4t+3 of a k-step, register 2 + h bytes 16 + 4t..; rows past
  // the group's end are zero.
  const int qw = qtile * QT + warp * WARP_ROWS;
  uint32_t a[MT][KSTEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = qw + 16 * m + 8 * h + g;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
                                query + (grow0 + min(q, n_rows - 1)) * PREFIX) + t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        a[m][ks][h] = q < n_rows ? __ldg(src + 8 * ks) : 0u;
        a[m][ks][2 + h] = q < n_rows ? __ldg(src + 8 * ks + 4) : 0u;
      }
    }

  // Running max over valid slots of rows qw + 16m + 8h + g.
  int best[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) best[m][0] = best[m][1] = kIntMin;

  int vnext = lane_valid(vslide, 0, lane, n_slots, step);
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();   // this tile has landed ...
    __syncthreads();               // ... and every warp is done with tile - 1
    const int next = tile + STAGES - 1;   // refills the stage of tile - 1
    if (next < n_tiles) load_tile(next, next % STAGES);
    cp_async_commit();
    // Bit 4n of `even` (`odd`): validity of this lane's slot 8n + 2t (+ 1).
    const uint32_t even = __ballot_sync(0xffffffffu, vnext & 1) >> t;
    const uint32_t odd = __ballot_sync(0xffffffffu, vnext & 2) >> t;
    if (tile + 1 < n_tiles) vnext = lane_valid(vslide, (tile + 1) * NT, lane, n_slots, step);

    const uint8_t* st = &ring[tile % STAGES][0][0];
#pragma unroll
    for (int n0 = 0; n0 < NT / 8; n0 += NG) {
      int c[NG][MT][4];
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[ng][m][i] = 0;
#pragma unroll
      for (int j = 0; j < KSTEPS / 2; ++j)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          // Lane i: slot 8(n0 + ng) + (i & 7), 16-byte chunk 4j + (i >> 3):
          // b[0], b[1] are k-step 2j's B fragment, b[2], b[3] k-step 2j+1's.
          uint32_t b[4];
          ldmatrix_x4(smem_addr(st + (8 * (n0 + ng) + (lane & 7)) * LDS + (4 * j + (lane >> 3)) * 16),
                      b);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_s8(c[ng][m], a[m][2 * j], b[0], b[1]);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_s8(c[ng][m], a[m][2 * j + 1], b[2], b[3]);
        }
      // c[ng][m][2h + j]: row 16m + 8h + g, slot 8(n0 + ng) + 2t + j.
#pragma unroll
      for (int ng = 0; ng < NG; ++ng) {
        const bool ok0 = (even >> (4 * (n0 + ng))) & 1u;
        const bool ok1 = (odd >> (4 * (n0 + ng))) & 1u;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (ok0) best[m][h] = max(best[m][h], c[ng][m][2 * h]);
            if (ok1) best[m][h] = max(best[m][h], c[ng][m][2 * h + 1]);
          }
      }
    }
  }
  cp_async_wait<0>();

  // The 4 lanes of a quad hold the same rows.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = best[m][h];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int q = qw + 16 * m + 8 * h + g;
      if (t == 0 && q < n_rows)
        best_out[(grow0 + q) * n_cols + col] = v == kIntMin ? INVALID : v;
    }
}

// The single stage, with the parameters of the kernel before the strided
// and listed forms: ptxas gives it 128 registers and no spill.
__global__ void __launch_bounds__(THREADS)
screen_kernel(const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
              const uint8_t* __restrict__ valid, int n_slides, int k_per_slide,
              int* __restrict__ best_out) {
  screen_body<false, 4>(query, nq, desc, valid, k_per_slide, 1, k_per_slide, nullptr, n_slides,
                        nq, 0, best_out);
}

// The strided and listed forms. Left free, ptxas gives this body 178
// registers (2 blocks an SM); held to 4 blocks an SM it spills 72 bytes and
// runs 10-13% faster (0.750-0.762 device ms against 0.828-0.869 at R = 64 x
// 128 strided and 64 groups x 256 listed; 3 blocks an SM: 0.760-0.766;
// chip_smoke.py --compare-screen, NVIDIA H100 80GB HBM3, 700.00 W).
__global__ void __launch_bounds__(THREADS, 4)
screen_general_kernel(const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
                      const uint8_t* __restrict__ valid, int k_per_slide, int stride,
                      const int* __restrict__ slide_ids, int n_cols, int rows_per_group,
                      int tiles_per_group, int* __restrict__ best_out) {
  screen_body<true, 4>(query, nq, desc, valid, k_per_slide, stride, k_per_slide / stride,
                       slide_ids, n_cols, rows_per_group, tiles_per_group, best_out);
}

// The per-frame rule's prefix form, at P = 128 (kKsteps 4) or 64 (2): the
// same body over the first n_slots slots, in a kernel of its own, so that
// the strided and listed forms keep their code. ptxas: 128 registers and a
// 48 B spill at P = 128, an 8 B spill at P = 64 (20,480 B shared memory).
template <int kKsteps>
__global__ void __launch_bounds__(THREADS, 4)
screen_prefix_kernel(const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
                     const uint8_t* __restrict__ valid, int k_per_slide, int stride, int n_slots,
                     const int* __restrict__ slide_ids, int n_cols, int rows_per_group,
                     int tiles_per_group, int* __restrict__ best_out) {
  screen_body<true, kKsteps>(query, nq, desc, valid, k_per_slide, stride, n_slots, slide_ids,
                             n_cols, rows_per_group, tiles_per_group, best_out);
}

}  // namespace

// query [nq, prefix] int8, prefix 64 or 128; desc [n_slides * k_per_slide,
// 256] int8, both 16-byte aligned; valid [n_slides * k_per_slide] uint8;
// k_per_slide a multiple of stride; 1 <= n_slots <= k_per_slide / stride;
// slide_ids: [nq / rows_per_group, n_cols] int32 slide ids, or null for
// columns 0..n_cols-1 (n_cols = n_slides) in every group; nq a multiple of
// rows_per_group; best [nq, n_cols] int32. Another prefix or slot count
// returns cudaErrorInvalidValue.
extern "C" int slideo_screen(const void* query, int nq, const void* desc, const void* valid,
                             int k_per_slide, int stride, int n_slots, int prefix,
                             const void* slide_ids, int n_cols, int rows_per_group, void* best,
                             void* stream) {
  if ((prefix != 64 && prefix != 128) || stride < 1 || n_slots < 1 ||
      n_slots > k_per_slide / stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto q = static_cast<const int8_t*>(query);
  const auto d = static_cast<const int8_t*>(desc);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto ids = static_cast<const int*>(slide_ids);
  const auto out = static_cast<int*>(best);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (rows_per_group + QT - 1) / QT;
  const dim3 grid(tiles * (nq / rows_per_group), n_cols);
  if (prefix == 128 && stride == 1 && slide_ids == nullptr && rows_per_group == nq &&
      n_slots == k_per_slide)
    screen_kernel<<<grid, THREADS, 0, st>>>(q, nq, d, v, n_cols, k_per_slide, out);
  else if (prefix == 128 && n_slots == k_per_slide / stride)
    screen_general_kernel<<<grid, THREADS, 0, st>>>(q, nq, d, v, k_per_slide, stride, ids, n_cols,
                                                    rows_per_group, tiles, out);
  else if (prefix == 128)
    screen_prefix_kernel<4><<<grid, THREADS, 0, st>>>(q, nq, d, v, k_per_slide, stride, n_slots,
                                                      ids, n_cols, rows_per_group, tiles, out);
  else
    screen_prefix_kernel<2><<<grid, THREADS, 0, st>>>(q, nq, d, v, k_per_slide, stride, n_slots,
                                                      ids, n_cols, rows_per_group, tiles, out);
  return static_cast<int>(cudaGetLastError());
}
