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
// memory (132 MB, 0.04 ms): the int8 tensor-core rate. The pre-vote at R =
// 64 x 128, stride 4 does 2*R*S*(K/4)*128 = 5.4e11 operations (0.27 ms);
// the re-vote at 64 groups of 256 x 64 listed slides does 5.5e11 (0.28 ms),
// its floor: the function needs each distinct slide the lists name once (at
// most 500 x 2048 rows, 132 MB, 0.04 ms), though a kernel that reads each
// group's 64 x 2048 rows on its own reads 1.08 GB from L2 or memory. One
// frame of the per-frame rule (R = 256) is bound by its bytes instead:
// S*n_slots*(P+1), 33.0 MB at 500 x 512 slots x 128 B (0.0099 ms) and
// 66.6 MB at 500 x 2048 x 64 B (0.020 ms).
//
// Two kernels. The single stage, screen_kernel, is the mma.sync kernel
// below; the strided, listed and prefix forms share
// screen_tma_kernel<P>, on wgmma over a TMA ring.
//
// screen_kernel: one block of 4 warps per (256-query tile, slide), query
// tiles fastest in launch order, so the blocks of one slide run together
// and its prefixes come from device memory once. L2 -> shared-memory
// traffic is R/256 * S * K * 128 B a call (8.4 GB at R = 16,384). Each warp
// holds 64 query rows, the most that fit, as A fragments of mma.sync
// m16n8k32 s8 in registers (4 m-tiles x 4 k-steps x 4 = 64 registers,
// loaded once from global memory), so each ldmatrix_x4 of slot data (8
// slots x 2 k-steps) feeds 8 mma. The slide's prefixes stream through a
// 4-stage ring of 64-slot tiles by cp.async.cg 16-byte copies (8 a row at
// the 256-byte row stride), into 144-byte rows so that the 8 rows of an
// ldmatrix start at 16-byte units 9i mod 8, 8 distinct bank groups. Every
// warp multiplies its rows with all 64 slots of a tile, 16 slots at a time
// as 8 independent accumulator chains (2 slot groups x 4 m-tiles) of 4
// k-steps. Validity comes as two 32-bit ballots a tile (each lane loads 2
// bytes one tile ahead); slots past K count as invalid, so the zero-filled
// rows of a ragged last tile never enter the max. Each thread folds its
// accumulators into a running max of its 8 rows; a quad shuffle finishes
// the max and only [R, S] is written. ptxas gives 128 registers and no
// spill, so 4 blocks (16 warps) fit an SM. A 512-query tile (8 warps) at
// R >= 8,192, which halves the L2 reads, measured no faster: 5.07-5.10
// device ms against this tile's 4.98-4.99 at R = 16,384 (chip_smoke.py
// --compare-screen, NVIDIA H100 80GB HBM3, 700.00 W), so the L2 traffic
// does not bind at this tile.
//
// screen_tma_kernel<P>: persistent blocks, one an SM, each two consumer
// warpgroups and a producer warpgroup (one warp of it works). A block walks
// a contiguous range of the (query tile, column) items, query tiles
// slowest, so it meets few query tiles (one, for one frame) and holds the
// current one in shared memory: 256 query rows x P bytes, loaded by TMA
// once per query tile, not once per slide. The slots are the wgmma's A (64
// slot rows an instruction) and the queries its B, both K-major as 8-bit
// wgmma requires and both read from shared memory: each consumer warpgroup
// multiplies every 64-slot M-block with its half of the tile (wgmma
// m64n128k32 s32.s8.s8, 64 int32 accumulators a thread). The producer warp
// keeps an 8-stage ring of 16 KB slot tiles full by TMA (128 slots at P =
// 128, 256 at P = 64) and waits on nothing but the ring's mbarriers. One
// tensor map a call views desc as [S, n_slots, P] with byte strides (K *
// 256, stride * 256), so the strided form's stride and the prefix form's
// slot count cost nothing: the box is {P, slots a stage, 1} at (0, j0,
// slide), with the 128-byte swizzle at P = 128 and the 64-byte one at P =
// 64, which the wgmma descriptors name; TMA zero-fills slots past n_slots,
// and the listed form takes a column's slide from slide_ids.
// Validity enters the product, as on the TPU: each stage has a validity
// k-step, a 32-byte row a slot (32-byte swizzle), whose bytes 0-3 the
// producer sets to -127 for an invalid slot or one past n_slots and to 0
// otherwise, against a query k-step of +1 in bytes 0-3 of every row, so an
// invalid slot scores its dot - 508 < -128. The producer loads the
// validity bytes a few stages ahead into registers (32 bytes a lane in
// flight), writes the rows, and one arrival publishes them with the
// stage's expected TMA bytes. Each consumer warpgroup holds two
// accumulator sets: it starts the next M-block's chain (P / 32 + 1
// k-steps) into one, waits for the current one (wgmma.wait_group 1),
// releases the stage once both warpgroups' warps have read it (one
// arrival a warp), and folds while the tensor cores run the next: thread
// t holds slot rows 16 (t / 32) + (t % 32) / 4 (+ 8) and query columns 8j
// + 2 (t % 4) (+ 1), j < 16, and one three-way max (__vimax3_s32) a column
// folds its two rows into 32 running maxima. No consumer thread copies or
// waits at a block-wide barrier. A max that took a valid slot is >= -128;
// one that took none lies in [-636, -380] and is written as -254. At the
// end of an item the maxima, packed in 16-bit pairs, are reduced over the
// 8 lanes that share a column pair (shuffles) and over the warpgroup's 4
// warps (shared memory, a 128-thread named barrier, buffers alternating by
// item), and each thread writes one row if it lies inside the item's
// group. Query rows past a group's end enter the product (they belong to
// the next group, or TMA zero-fills them past R) and are never written.
// The next item's loads run under this item's fold and stores. ptxas gives
// a 384-thread block 168 registers a thread; setmaxnreg moves the producer
// warpgroup's down to 72 and the consumers' up to 216, with no spill.
// Two measured choices (PERF.md §6, chip_smoke.py --compare-screen):
// the tensor maps ask for no L2 promotion, since a box row is the first P
// bytes of a 256-byte row and a 256-byte promotion fetches the rest for
// nothing; and the masks in the product replaced a predicated max a value.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "int8_mma.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int ROW = 256;               // bytes of an index row
constexpr int INVALID = -254;          // two -127 validity rows x two +1 columns
constexpr int kMaxDevices = 64;

// ---- screen_kernel: the single stage on mma.sync ----

constexpr int WARP_ROWS = 64;          // query rows a warp holds as A fragments
constexpr int MT = WARP_ROWS / 16;     // m16 tiles of a warp
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * WARP_ROWS;  // queries per block
constexpr int NT = 64;                 // slots per ring stage: two per lane of a ballot
constexpr int STAGES = 4;              // 4 x 64 x 144 B = 36,864 B of static shared memory
constexpr int NG = 2;                  // 8-slot groups multiplied between two folds
constexpr int kIntMin = -2147483647 - 1;

// Bit 0: slot k0 + 2 * lane is valid; bit 1: slot k0 + 2 * lane + 1. Slots
// past n_slots are not valid.
__device__ __forceinline__ int lane_valid(const uint8_t* __restrict__ vslide, int k0, int lane,
                                          int n_slots) {
  const int k = k0 + 2 * lane;
  int v = 0;
  if (k < n_slots && __ldg(vslide + (int64_t)k) != 0) v = 1;
  if (k + 1 < n_slots && __ldg(vslide + (int64_t)(k + 1)) != 0) v |= 2;
  return v;
}

__global__ void __launch_bounds__(THREADS)
screen_kernel(const int8_t* __restrict__ query, int nq, const int8_t* __restrict__ desc,
              const uint8_t* __restrict__ valid, int n_slides, int k_per_slide,
              int* __restrict__ best_out) {
  constexpr int PREFIX = 128;            // bytes read of each index row and query row
  constexpr int LDS = PREFIX + 16;       // padded shared-memory row (bytes)
  constexpr int CHUNKS = PREFIX / 16;    // 16-byte copies per row
  constexpr int KSTEPS = PREFIX / 32;
  static_assert(NT * CHUNKS % THREADS == 0, "a tile is whole copies of every thread");
  __shared__ __align__(128) uint8_t ring[STAGES][NT][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int col = blockIdx.y, qtile = blockIdx.x, n_slots = k_per_slide;
  const int64_t row0 = (int64_t)col * k_per_slide;
  const int8_t* dslide = desc + row0 * ROW;
  const uint8_t* vslide = valid + row0;
  const int n_tiles = (n_slots + NT - 1) / NT;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * NT;
#pragma unroll
    for (int u = 0; u < NT * CHUNKS / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool in = k0 + r < n_slots;
      cp_async16(smem_addr(&ring[stage][r][c * 16]),
                 dslide + (int64_t)(in ? k0 + r : 0) * ROW + c * 16, in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // A fragments of rows qw + 16m + 8h + g: register h holds bytes
  // 4t..4t+3 of a k-step, register 2 + h bytes 16 + 4t..; rows past nq are
  // zero.
  const int qw = qtile * QT + warp * WARP_ROWS;
  uint32_t a[MT][KSTEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = qw + 16 * m + 8 * h + g;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(query + (int64_t)min(q, nq - 1) * PREFIX) + t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        a[m][ks][h] = q < nq ? __ldg(src + 8 * ks) : 0u;
        a[m][ks][2 + h] = q < nq ? __ldg(src + 8 * ks + 4) : 0u;
      }
    }

  // Running max over valid slots of rows qw + 16m + 8h + g.
  int best[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) best[m][0] = best[m][1] = kIntMin;

  int vnext = lane_valid(vslide, 0, lane, n_slots);
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();   // this tile has landed ...
    __syncthreads();               // ... and every warp is done with tile - 1
    const int next = tile + STAGES - 1;   // refills the stage of tile - 1
    if (next < n_tiles) load_tile(next, next % STAGES);
    cp_async_commit();
    // Bit 4n of `even` (`odd`): validity of this lane's slot 8n + 2t (+ 1).
    const uint32_t even = __ballot_sync(0xffffffffu, vnext & 1) >> t;
    const uint32_t odd = __ballot_sync(0xffffffffu, vnext & 2) >> t;
    if (tile + 1 < n_tiles) vnext = lane_valid(vslide, (tile + 1) * NT, lane, n_slots);

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
      if (t == 0 && q < nq) best_out[(int64_t)q * n_slides + col] = v == kIntMin ? INVALID : v;
    }
}

// ---- screen_tma_kernel<P>: the strided, listed and prefix forms ----

constexpr int kQueryTile = 256;        // query rows a block holds
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;          // warpgroups, each with half the query tile
constexpr int kWgQueries = kQueryTile / kConsumers;   // the wgmma's N
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kTmaThreads = kConsumerThreads + kWarpgroup;   // and the producer's
// Registers a thread: ptxas gives a 384-thread block 168 at launch; the
// producer warpgroup frees 96 a thread, which the consumers take (2 x 48).
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
constexpr int kStageBytes = 16384;     // slot bytes a ring stage holds
constexpr int kStages = 8;
constexpr int kFloor = -32768;         // a running max before its first slot
// An invalid slot's row of the validity k-step: four -127 bytes, which
// meet four +1 query bytes, so it scores its dot - 508 < -128.
constexpr uint32_t kInvalidWord = 0x81818181u;
constexpr uint32_t kOnesWord = 0x01010101u;

template <int P>
struct TmaLayout {
  static constexpr int kSlots = kStageBytes / P;   // slots a stage: 128 at P = 128, 256 at 64
  static constexpr int kMBlocks = kSlots / 64;     // wgmma M-blocks a stage
  static constexpr int kKSteps = P / 32;
  static constexpr int kQueryBytes = kQueryTile * P;
  static constexpr int kPerLane = kSlots / 32;     // a producer lane's slots a stage
  // Stages ahead that the producer loads validity: 32 bytes a lane in
  // flight (8 stages at P = 128, 4 at P = 64), which its registers hold.
  static constexpr int kAhead = 32 / kPerLane;
  static_assert(kStages % kAhead == 0, "a stage's validity registers are static");
  // Shared memory, from a 1024-byte aligned base: the query tile, the ring,
  // each stage's validity k-step (a 32-byte row a slot, 32-byte swizzle),
  // the queries' (+1 in bytes 0-3 of each of 128 rows), the warps' column
  // maxima (two buffers, alternating by item), the mbarriers.
  static constexpr int kRing = kQueryBytes;
  static constexpr int kPens = kRing + kStages * kStageBytes;
  static constexpr int kOnes = kPens + kStages * kSlots * 32;
  static constexpr int kRed = kOnes + kWgQueries * 32;
  static constexpr int kRedWords = kConsumers * 4 * (kWgQueries / 2);   // one item's
  static constexpr int kBars = kRed + 2 * kRedWords * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 2) * 8 + 1024;   // + alignment slack
  static_assert(kSlots % 64 == 0 && kSlots <= 256, "a stage is whole M-blocks, one TMA box");
};

// What the walk reads besides the two tensor maps.
struct TmaWork {
  const uint8_t* valid;
  const int* slide_ids;        // [n_groups, n_cols] or null
  int k_per_slide, stride, n_slots, n_cols, rows_per_group, tiles_per_group;
  int n_tiles;                 // stages an item: ceil(n_slots / slots a stage)
  int n_items;                 // query tiles x columns
  int* best;
};

// Item i: query tile i / n_cols (tile `tig` of group `group`), column i % n_cols.
struct Item {
  int qtile, col, group, tig;
};

__device__ __forceinline__ Item item_at(const TmaWork& w, int i) {
  Item it;
  it.qtile = i / w.n_cols;
  it.col = i - it.qtile * w.n_cols;
  it.group = it.qtile / w.tiles_per_group;
  it.tig = it.qtile - it.group * w.tiles_per_group;
  return it;
}

__device__ __forceinline__ int slide_of(const TmaWork& w, const Item& it) {
  return w.slide_ids == nullptr ? it.col
                                : __ldg(w.slide_ids + static_cast<long long>(it.group) * w.n_cols +
                                        it.col);
}

// A cursor over the block's tiles in walk order: item `item`, its tile
// `tile`, and the item's query tile and slide (read when the item changes).
struct TileCursor {
  int item, tile, qtile, group, tig, slide;

  __device__ __forceinline__ void at_item(const TmaWork& w, int i) {
    const Item it = item_at(w, i);
    item = i;
    tile = 0;
    qtile = it.qtile;
    group = it.group;
    tig = it.tig;
    slide = slide_of(w, it);
  }
  __device__ __forceinline__ void next(const TmaWork& w, int hi) {
    if (++tile == w.n_tiles) {
      if (item + 1 < hi) at_item(w, item + 1);
      else tile = w.n_tiles - 1;    // past the block's last tile: stay on it
    }
  }
};

template <int P>
__device__ __forceinline__ void tma_produce(const CUtensorMap* qmap, const CUtensorMap* dmap,
                                            const TmaWork& w, int lo, int hi, uint8_t* qbuf,
                                            uint8_t* ring, uint8_t* pens, uint64_t* full,
                                            uint64_t* empty, uint64_t* qfull, uint64_t* qempty) {
  using L = TmaLayout<P>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    tma_prefetch_map(qmap);
    tma_prefetch_map(dmap);
  }
  const int n_tiles = (hi - lo) * w.n_tiles;
  // This lane's slots of a tile are lane + 32u of the stage. Their validity
  // bytes are loaded kAhead tiles ahead (cursor `ahead`) and consumed only
  // then; past the block's last tile `ahead` stays on it, so every load is
  // in range and none is predicated.
  auto load_valid = [&](const TileCursor& c, uint32_t (&out)[L::kPerLane]) {
    const uint8_t* vs = w.valid + static_cast<long long>(c.slide) * w.k_per_slide;
#pragma unroll
    for (int u = 0; u < L::kPerLane; ++u) {
      const int j = min(c.tile * L::kSlots + lane + 32 * u, w.n_slots - 1);
      out[u] = __ldg(vs + static_cast<long long>(j) * w.stride);
    }
  };
  TileCursor cur, ahead;
  cur.at_item(w, lo);
  ahead = cur;
  uint32_t v[L::kAhead][L::kPerLane];
#pragma unroll
  for (int d = 0; d < L::kAhead; ++d) {
    load_valid(ahead, v[d]);
    ahead.next(w, hi);
  }
  int n_loads = 0, cur_qtile = -1;
  for (int base = 0; base < n_tiles; base += kStages) {
#pragma unroll
    for (int d = 0; d < kStages; ++d) {   // tile t = base + d lands in stage d
      const int t = base + d;
      if (t >= n_tiles) break;
      if (cur.tile == 0 && cur.qtile != cur_qtile) {
        // A new query tile: once the consumers are done with the last one.
        if (n_loads > 0) mbar_wait(qempty, (n_loads - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(qfull, L::kQueryBytes);
          tma_load_2d(qbuf, qmap, qfull, 0, cur.group * w.rows_per_group + cur.tig * kQueryTile);
        }
        ++n_loads;
        cur_qtile = cur.qtile;
      }
      mbar_wait(&empty[d], ((t / kStages) & 1) ^ 1);
      // Each lane writes its slots' validity rows (bytes 4-31 stay zero),
      // then lane 0's one arrival (with the expected bytes) publishes them;
      // the slot tile's TMA completes the phase.
#pragma unroll
      for (int u = 0; u < L::kPerLane; ++u) {
        const int i = lane + 32 * u;
        *reinterpret_cast<uint32_t*>(pens + d * L::kSlots * 32 + swizzle32_row(i)) =
            cur.tile * L::kSlots + i < w.n_slots && v[d % L::kAhead][u] != 0 ? 0u : kInvalidWord;
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[d], kStageBytes);
        tma_load_3d(ring + d * kStageBytes, dmap, &full[d], 0, cur.tile * L::kSlots, cur.slide);
      }
      load_valid(ahead, v[d % L::kAhead]);
      ahead.next(w, hi);
      cur.next(w, hi);
    }
  }
}

// One consumer warpgroup: queries wg * 128 .. + 127 of the block's tile
// against every stage. A unit is one M-block (64 slots) of a stage; units
// run in the producer's order, each item's n_tiles * kMBlocks in turn.
template <int P>
__device__ __forceinline__ void tma_consume(const TmaWork& w, int lo, int hi,
                                            const uint8_t* qbuf, const uint8_t* ring,
                                            const uint8_t* pens, const uint8_t* ones,
                                            uint32_t* red, uint64_t* full,
                                            uint64_t* empty, uint64_t* qfull, uint64_t* qempty) {
  using L = TmaLayout<P>;
  constexpr int kPairs = kWgQueries / 2;
  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const uint8_t* queries = qbuf + wg * kWgQueries * P;   // the wgmma's B
  const int per_item = w.n_tiles * L::kMBlocks;
  // acc[b][4j + 2h + e]: slot row 16 warp + g + 8h of a unit, query 8j + 2 t4 + e
  // of the warpgroup's 128, its dot less 508 if the slot is invalid; the
  // unit in flight and the one being folded alternate between b = 0 and 1.
  int acc[2][64];
  int best[32];               // best[2j + e]: query 8j + 2 t4 + e
#pragma unroll
  for (int c = 0; c < 32; ++c) best[c] = kFloor;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[b][k] = 0;

  int t0 = 0;                 // the block's tile index of the segment's first unit
  // Waits for unit u's stage and starts its wgmma chain: P / 32 k-steps
  // of the prefixes, then the validity k-step.
  auto issue = [&](int u, int (&a)[64]) {
    const int t = t0 + u / L::kMBlocks, mb = u % L::kMBlocks, s = t % kStages;
    if (mb == 0) mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* slots = ring + s * kStageBytes + mb * 64 * P;   // the wgmma's A
#pragma unroll
    for (int k = 0; k < 64; ++k) fence_operand(a[k]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks)
      wgmma_m64n128k32_s8(a, wgmma_desc(slots + 32 * ks, P), wgmma_desc(queries + 32 * ks, P),
                          ks > 0);
    wgmma_m64n128k32_s8(a, wgmma_desc(pens + (s * L::kSlots + mb * 64) * 32, 32),
                        wgmma_desc(ones, 32), 1);
    wgmma_commit();
  };
  int item = lo, left = per_item;   // the item being folded and its units still to fold
  // Folds finished unit u into the running maxima, one three-way max for
  // a column's two slot rows, releasing its stage after its last M-block;
  // at an item's end reduces and stores the item's maxima.
  auto retire = [&](int u, int (&a)[64]) {
#pragma unroll
    for (int k = 0; k < 64; ++k) fence_operand(a[k]);
    if (u % L::kMBlocks == L::kMBlocks - 1) {
      __syncwarp();   // the warp's reads of the stage are done
      if (lane == 0) mbar_arrive(&empty[(t0 + u / L::kMBlocks) % kStages]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      best[2 * j] = __vimax3_s32(best[2 * j], a[4 * j], a[4 * j + 2]);
      best[2 * j + 1] = __vimax3_s32(best[2 * j + 1], a[4 * j + 1], a[4 * j + 3]);
    }
    if (--left > 0) return;
    // The item's end: its maxima, packed in 16-bit pairs, over the 8 lanes
    // of a column pair, then the warpgroup's 4 warps; each thread stores one
    // query row.
    uint32_t pk[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pk[j] = __byte_perm(best[2 * j], best[2 * j + 1], 0x5410);
      best[2 * j] = best[2 * j + 1] = kFloor;
      pk[j] = __vmaxs2(pk[j], __shfl_xor_sync(0xffffffffu, pk[j], 4));
      pk[j] = __vmaxs2(pk[j], __shfl_xor_sync(0xffffffffu, pk[j], 8));
      pk[j] = __vmaxs2(pk[j], __shfl_xor_sync(0xffffffffu, pk[j], 16));
    }
    uint32_t* rb = red + ((item - lo) & 1) * L::kRedWords + wg * 4 * kPairs;   // [warp][pair]
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) rb[warp * kPairs + 4 * j + t4] = pk[j];
    }
    named_barrier(1 + wg, kWarpgroup);
    const Item it = item_at(w, item);
    const int pr = tid >> 1;
    const uint32_t m = __vmaxs2(__vmaxs2(rb[pr], rb[kPairs + pr]),
                                __vmaxs2(rb[2 * kPairs + pr], rb[3 * kPairs + pr]));
    const int v = static_cast<int16_t>(tid & 1 ? m >> 16 : m & 0xFFFFu);
    const int q = it.tig * kQueryTile + wg * kWgQueries + tid;   // row of the group
    if (q < w.rows_per_group)
      w.best[(static_cast<long long>(it.group) * w.rows_per_group + q) * w.n_cols + it.col] =
          v < -128 ? INVALID : v;
    ++item;
    left = per_item;
  };

  // Segments of items on one query tile; within one, the next unit's wgmma
  // runs while this one is folded (the loop body has no branch between an
  // issue and its wait; the last one or two units are peeled off).
  for (int n_loads = 0, i = lo; i < hi; ++n_loads) {
    const int end = min(hi, (i / w.n_cols + 1) * w.n_cols);   // the query tile's last item + 1
    const int units = (end - i) * per_item;
    mbar_wait(qfull, n_loads & 1);
    issue(0, acc[0]);
    int u = 0;
    for (; u + 2 < units; u += 2) {
      issue(u + 1, acc[1]);
      wgmma_wait<1>();
      retire(u, acc[0]);
      issue(u + 2, acc[0]);
      wgmma_wait<1>();
      retire(u + 1, acc[1]);
    }
    if (u + 1 < units) {
      issue(u + 1, acc[1]);
      wgmma_wait<1>();
      retire(u, acc[0]);
      wgmma_wait<0>();
      retire(u + 1, acc[1]);
    } else {
      wgmma_wait<0>();
      retire(u, acc[0]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty);   // done with the query tile
    t0 += units / L::kMBlocks;
    i = end;
  }
}

template <int P>
__global__ void __launch_bounds__(kTmaThreads, 1)
screen_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap dmap, const TmaWork w) {
  using L = TmaLayout<P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qbuf = smem;
  uint8_t* ring = smem + L::kRing;
  uint8_t* pens = smem + L::kPens;
  uint8_t* ones = smem + L::kOnes;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + L::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + 1;
  if (threadIdx.x == kConsumerThreads) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                       // the producer's expect_tx
      mbar_init(&empty[s], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumerThreads / 32);
    mbar_fence_init();
  }
  // The validity k-steps: every stage's rows zero (the producer rewrites
  // bytes 0-3 of each), the queries' +1 in bytes 0-3 of each row.
  for (int i = threadIdx.x; i < (L::kRed - L::kPens) / 16; i += kTmaThreads)
    reinterpret_cast<uint4*>(pens)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x < kWgQueries)
    *reinterpret_cast<uint32_t*>(ones + swizzle32_row(threadIdx.x)) = kOnesWord;
  fence_proxy_async();
  __syncthreads();   // the barriers and blocks exist; the roles split here for good
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * w.n_items / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * w.n_items / gridDim.x);
  if (threadIdx.x >= kConsumerThreads) {
    // One warp of the producer warpgroup issues every copy; all four give
    // their registers to the consumers.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < kConsumerThreads + 32)
      tma_produce<P>(&qmap, &dmap, w, lo, hi, qbuf, ring, pens, full, empty, qfull, qempty);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    tma_consume<P>(w, lo, hi, qbuf, ring, pens, ones, red, full, empty, qfull, qempty);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// An encode that fails returns kEncodeError + its CUresult.
constexpr int kEncodeError = 10000;

// A uint8 tensor map of `rank` dims (innermost first) whose box rows are P
// bytes, swizzled at P bytes (the wgmma descriptors' layout). No L2
// promotion: a box row is the first P bytes of a 256-byte index row, and
// promoting its fetch to 256 bytes reads the rest of the row for nothing
// (PERF.md §6 gives both times).
template <int P>
CUresult encode_map(EncodeTiled encode, CUtensorMap* map, int rank, const void* base,
                    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                P == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Blocks of screen_tma_kernel<P> resident on the current card, its shared
// memory opted in (above 48 KB), once per device. Mesh threads launch at
// once: the cache is atomic, and a repeated opt-in is harmless.
template <int P>
int tma_resident_blocks(int dev) {
  static std::atomic<int> cached[kMaxDevices];
  if (dev < kMaxDevices) {
    const int n = cached[dev].load(std::memory_order_acquire);
    if (n > 0) return n;
  }
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(screen_tma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TmaLayout<P>::kBytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, screen_tma_kernel<P>, kTmaThreads,
                                                    TmaLayout<P>::kBytes) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cached[dev].store(sms * per_sm, std::memory_order_release);
  return sms * per_sm;
}

template <int P>
int launch_tma(const void* query, int nq, const void* desc, const void* valid, int k_per_slide,
               int stride, int n_slots, const void* slide_ids, int n_cols, int rows_per_group,
               void* best, cudaStream_t stream) {
  using L = TmaLayout<P>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = tma_resident_blocks<P>(dev);
  if (resident <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // Queries [nq, P], a box of the query tile; rows past nq are zero-filled.
  CUtensorMap qmap, dmap;
  const cuuint64_t qdims[2] = {P, static_cast<cuuint64_t>(nq)}, qstrides[1] = {P};
  const cuuint32_t qbox[2] = {P, kQueryTile};
  CUresult res = encode_map<P>(encode, &qmap, 2, query, qdims, qstrides, qbox);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  // desc seen as [slides, n_slots, P]: slot j of slide s is row s*K + j*stride.
  // The listed form's ids index a deck whose size the launcher is not told;
  // keeping them in range is the caller's part, as in every form.
  const cuuint64_t n_slides = slide_ids == nullptr ? n_cols : (1u << 20);
  const cuuint64_t ddims[3] = {P, static_cast<cuuint64_t>(n_slots), n_slides};
  const cuuint64_t dstrides[2] = {static_cast<cuuint64_t>(stride) * ROW,
                                  static_cast<cuuint64_t>(k_per_slide) * ROW};
  const cuuint32_t dbox[3] = {P, L::kSlots, 1};
  res = encode_map<P>(encode, &dmap, 3, desc, ddims, dstrides, dbox);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  TmaWork w;
  w.valid = static_cast<const uint8_t*>(valid);
  w.slide_ids = static_cast<const int*>(slide_ids);
  w.k_per_slide = k_per_slide;
  w.stride = stride;
  w.n_slots = n_slots;
  w.n_cols = n_cols;
  w.rows_per_group = rows_per_group;
  w.tiles_per_group = (rows_per_group + kQueryTile - 1) / kQueryTile;
  w.n_tiles = (n_slots + L::kSlots - 1) / L::kSlots;
  const long long n_items =
      static_cast<long long>(w.tiles_per_group) * (nq / rows_per_group) * n_cols;
  if (n_items > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  w.n_items = static_cast<int>(n_items);
  w.best = static_cast<int*>(best);
  const int grid = w.n_items < resident ? w.n_items : resident;
  screen_tma_kernel<P><<<grid, kTmaThreads, L::kBytes, stream>>>(qmap, dmap, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query [nq, prefix] int8, prefix 64 or 128; desc [n_slides * k_per_slide,
// 256] int8, both 16-byte aligned; valid [n_slides * k_per_slide] uint8;
// k_per_slide a multiple of stride; 1 <= n_slots <= k_per_slide / stride;
// slide_ids: [nq / rows_per_group, n_cols] int32 slide ids, or null for
// columns 0..n_cols-1 (n_cols = n_slides) in every group; nq a multiple of
// rows_per_group; best [nq, n_cols] int32. Another prefix or slot count
// returns cudaErrorInvalidValue; a tensor map the encoder refuses returns
// 10000 + its CUresult.
extern "C" int slideo_screen(const void* query, int nq, const void* desc, const void* valid,
                             int k_per_slide, int stride, int n_slots, int prefix,
                             const void* slide_ids, int n_cols, int rows_per_group, void* best,
                             void* stream) {
  if ((prefix != 64 && prefix != 128) || stride < 1 || n_slots < 1 ||
      n_slots > k_per_slide / stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (prefix == 128 && stride == 1 && slide_ids == nullptr && rows_per_group == nq &&
      n_slots == k_per_slide) {
    const dim3 grid((nq + QT - 1) / QT, n_cols);
    screen_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(query), nq, static_cast<const int8_t*>(desc),
        static_cast<const uint8_t*>(valid), n_cols, k_per_slide, static_cast<int*>(best));
    return static_cast<int>(cudaGetLastError());
  }
  return prefix == 128 ? launch_tma<128>(query, nq, desc, valid, k_per_slide, stride, n_slots,
                                         slide_ids, n_cols, rows_per_group, best, st)
                       : launch_tma<64>(query, nq, desc, valid, k_per_slide, stride, n_slots,
                                        slide_ids, n_cols, rows_per_group, best, st);
}
