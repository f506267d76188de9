// K3+K4: orientation bin + blur-folded steered BRIEF of each keypoint.
//
// Replaces both passes of slideo_tpu/ops/pallas_orb.py:orb_descriptors_pallas
// (_kernel_bins: window DMA + moments + _sector32; _kernel_desc_t: per-bin
// table contraction). Contract, per keypoint at level-local (y, x) of level l
// (level table rows: row offset, column offset, height, width):
//   y0     = clip(y + yo - 31, yo, max(yo + h - 63, yo)), x0 likewise
//   P      = atlas[y0 .. y0+62, x0 .. x0+62] (bf16; beyond the atlas 0)
//   m10    = sum P * disc * (c - 31),  m01 = sum P * disc * (r - 31)   (f32)
//   bin    = _sector32(m10, m01)       (same f32 constants, no FMA contraction)
//   v[s]   = sum_i A[bin][s][i] * sum_j D[bin][s][j] * P[i][j]
//   bit[i] = v[256 + i] > v[i] ? +1 : -1
// A and D are the bf16-rounded blur-folded tent tables: each row is a tent
// convolved with a 7-tap band, at most 8 consecutive nonzeros. The wrapper
// (ops/cuda_orb.py:_packed_tables) packs each sample as one head word
// (a_start | d_start << 6 | sample << 12) and its 16 bf16 weights (8 of A,
// then 8 of D; 32 B), per bin in the order of the bank schedule below.
//
// What bounds it on the card. Per keypoint: 4 K patch pixels and 512 samples
// of 8 x 8 taps (~37 K FMA); the f32 FMA bound of 2048 keypoints is 2.5 us.
// A gather does not reach it: the taps are shared-memory reads, and a warp
// whose 32 lanes read words in the same bank serialises. BRIEF's pattern
// clusters around the centre (every start in rows and columns 13-42), so
// with the earlier f32 tile of pitch 64 a warp read took 4.09 wavefronts on
// average. What the design does about it:
//
// 1. A bf16 patch, two columns a 32-bit word, kept twice: copy 0 holds the
//    column pairs (2w, 2w+1), copy 1 the pairs (2w+1, 2w+2), so every
//    sample's 8 columns are 4 whole words of one copy. A sample reads 32
//    words where an f32 tile takes 64; each pair is unpacked exactly (a
//    shift, a mask).
// 2. A bank schedule. A lane's 32 taps share one bank base, the word of its
//    first tap mod 32, so the conflicts of a warp read depend on the bases of
//    its 32 samples alone. The host orders each bin's 512 samples over the
//    16 warp reads (8 warps x 2 slots) from the bases' residues: at row
//    pitch PITCH and copy offset COPY1 the schedule takes 1.50 wavefronts
//    per warp read on average over the 32 bins
//    (cuda_orb.SCHEDULE_WAVEFRONTS; 1.625 at most in one bin). Each lane
//    writes v to shared memory at its sample's index, and a last pass
//    compares v[256 + i] with v[i] in bit order.
// 3. Staging that overlaps the sampling. A block walks keypoints k,
//    k + grid, ... (grid = min(K, resident blocks), so K = 768 still fills
//    the card) and copies the patch two keypoints ahead with 4-byte
//    cp.async, zero-filled outside the atlas: a raw row is the 32 aligned
//    words that hold the patch row, so any atlas width and any 2-byte
//    aligned base work. One pass turns a raw row into the two copies
//    (a shuffle and a byte permute), masks the columns beyond the atlas
//    and sums the moments. Warp w takes rows w + 8 i, whose starts share
//    one parity, so its column masks and moment weights are set once a
//    keypoint.
// 4. One barrier for the bin: warp shuffles reduce the moments, and every
//    thread sums the 8 warp partials and runs _sector32 itself.
// 5. Patch origins formed here from (y, x, level) and the level table (in
//    shared memory): the frame path runs no origin ops before the launch.
// Two barriers a keypoint in all. Summation order differs from the MXU's,
// so bits whose two samples nearly tie may flip; the contract's tolerance
// covers that.
//
// Where it stands (chip_smoke.py --compare-orb on an H100; PERF.md): 64
// registers, 4 blocks an SM, 0.020 ms at K = 2048 against 0.059 before.
// It now issues ~200 instructions a sample (32 loads, 64 unpacks, 72 FMA),
// two thirds of its instructions, and is bound by instruction issue with
// shared memory close behind: a tile of f32 pixels (no unpacks, twice the
// wavefronts) is 26% slower, and the row pitch (34 or 35) changes nothing.
// Of what held the one-keypoint-a-block kernel back (bank conflicts, a
// serial chain of staging, bin and sweep, origin ops around the launch),
// the bank conflicts still cost 1.5 wavefronts a read where 1 is the
// floor; the serial chain and the origin ops are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int PATCH = 63;
constexpr int HALF = 31;
constexpr int NBITS = 256;
constexpr int NSAMP = 2 * NBITS;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RAW_WORDS = 32;                // aligned words that hold a 63-pixel row
constexpr int PITCH = 35;                    // words per tile row (cuda_orb.TILE)
constexpr int COPY1 = PATCH * PITCH + 16;    // word offset of copy 1 (cuda_orb.TILE)
constexpr int ROWS_PER_WARP = (PATCH + WARPS - 1) / WARPS;  // 8: warp w takes rows w + 8 i
constexpr int MAX_LEVELS = 32;               // pyramid levels the level table may hold
constexpr unsigned FULL = 0xffffffffu;

struct Origin {
  int y0, x0;
};

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

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

struct Args {
  const uint16_t* atlas;
  int ha, wa;
  const int* y;
  const int* x;
  const int* level;
  const int* level_table;  // [4, n_levels]
  int n_levels, k;
  const uint32_t* heads;   // [32, 512]
  const uint4* weights;    // [32, 512, 2] (16 bf16 a sample)
  int* bins;
  int8_t* out;
};

struct Keypoint {
  int y, x, level;
};

__device__ __forceinline__ Keypoint keypoint(const Args& g, int k) {
  return {g.y[k], g.x[k], g.level[k]};
}

// patch_origins' clamp inside the keypoint's level (``levels``: the level
// table in shared memory); a level outside the table or an origin outside
// the atlas traps (the tables never give one).
__device__ __forceinline__ Origin origin_of(const Args& g, Keypoint p,
                                           const int (*levels)[MAX_LEVELS]) {
  if (static_cast<unsigned>(p.level) >= static_cast<unsigned>(g.n_levels)) __trap();
  const int yo = levels[0][p.level], xo = levels[1][p.level];
  const int h = levels[2][p.level], w = levels[3][p.level];
  const Origin o{min(max(p.y + yo - HALF, yo), max(yo + h - PATCH, yo)),
                 min(max(p.x + xo - HALF, xo), max(xo + w - PATCH, xo))};
  if (o.y0 < 0 || o.x0 < 0) __trap();
  return o;
}

// Issue the copies of one patch: warp w takes rows w, w + 8, ...; lane i the
// i-th aligned word of the row. Rows outside the atlas and words past its
// end are zero-filled without a read. A word that holds an atlas pixel lies
// inside the atlas's allocation (CUDA allocations are 256-byte aligned and
// PyTorch rounds their sizes to 512 bytes), even where it holds a pixel
// before the first or after the last.
__device__ __forceinline__ void stage(const Args& g, Origin o, uint32_t (*raw)[RAW_WORDS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uintptr_t words = reinterpret_cast<uintptr_t>(g.atlas) & ~static_cast<uintptr_t>(3);
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(g.atlas) >> 1) & 1;
  const int last = ((lead + g.ha * g.wa + 1) >> 1) - 1;  // the last word with an atlas pixel
  const int rows = g.ha - o.y0 - warp;                  // this warp's rows i * 8 with a pixel
  int rel = lead + (o.y0 + warp) * g.wa + o.x0;         // pixel index from `words`
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(&raw[warp][lane]));
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i, rel += WARPS * g.wa) {
    if (i < ROWS_PER_WARP - 1 || warp < PATCH - (ROWS_PER_WARP - 1) * WARPS) {
      const int word = (rel >> 1) + lane;
      const bool full = i * WARPS < rows && word <= last;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       dst + 4 * i * WARPS * RAW_WORDS),
                   "l"(words + 4 * static_cast<uintptr_t>(min(word, last))), "r"(full ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void commit_empty() { asm volatile("cp.async.commit_group;\n" ::); }

// All copy groups but the newest have landed (this thread's).
__device__ __forceinline__ void wait_all_but_newest() { asm volatile("cp.async.wait_group 1;\n" ::); }

// v of one sample: 8 rows of 4 words of the copy that holds its columns.
__device__ __forceinline__ float sample_value(const uint32_t* tile, uint32_t head, uint4 aw,
                                              uint4 dw) {
  const int as = head & 63, ds = (head >> 6) & 63;
  const uint32_t* q = tile + ((ds & 1) ? COPY1 : 0) + as * PITCH + (ds >> 1);
  const float d[8] = {bf_lo(dw.x), bf_hi(dw.x), bf_lo(dw.y), bf_hi(dw.y),
                      bf_lo(dw.z), bf_hi(dw.z), bf_lo(dw.w), bf_hi(dw.w)};
  const uint32_t a[4] = {aw.x, aw.y, aw.z, aw.w};
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float r = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t p = q[i * PITCH + j];
      r = fmaf(d[2 * j], bf_lo(p), r);
      r = fmaf(d[2 * j + 1], bf_hi(p), r);
    }
    v = fmaf((i & 1) ? bf_hi(a[i >> 1]) : bf_lo(a[i >> 1]), r, v);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS, 4) orb_describe_kernel(const Args g) {
  __shared__ uint32_t raw[2][PATCH][RAW_WORDS];
  __shared__ uint32_t tile[COPY1 + PATCH * PITCH];
  __shared__ float vals[NSAMP];
  __shared__ float2 red[WARPS];
  __shared__ int levels[4][MAX_LEVELS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int step = gridDim.x;
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(g.atlas) >> 1) & 1;
  int k = blockIdx.x;  // the launcher starts no more blocks than keypoints

  const Keypoint first = keypoint(g, k);
  const Keypoint second = k + step < g.k ? keypoint(g, k + step) : Keypoint{0, 0, 0};
  if (t < 4 * g.n_levels) levels[t / g.n_levels][t % g.n_levels] = g.level_table[t];
  __syncthreads();
  Origin cur = origin_of(g, first, levels), next{0, 0};
  stage(g, cur, raw[0]);
  if (k + step < g.k) {
    next = origin_of(g, second, levels);
    stage(g, next, raw[1]);
  } else {
    commit_empty();
  }
  wait_all_but_newest();
  __syncthreads();

  for (int j = 0; k < g.k; ++j, k += step) {
    // The keypoint after next: its loads in flight while this one is staged.
    const bool more = k + 2 * step < g.k;
    const Keypoint coming = more ? keypoint(g, k + 2 * step) : Keypoint{0, 0, 0};

    // Raw rows -> the two tile copies, columns beyond the atlas masked,
    // moments over the disc. A warp's rows share their parity, so its raw
    // rows start one pixel early (s = 1) all or none.
    const uint32_t* src = &raw[j & 1][warp][lane];
    uint32_t* dst = &tile[warp * PITCH + lane];
    const int s = (lead + (cur.y0 + warp) * g.wa + cur.x0) & 1;
    const int c = 2 * lane - s;  // patch column of a raw word's low pixel
    const uint32_t mask = (c >= 0 && c < PATCH && cur.x0 + c < g.wa ? 0x0000ffffu : 0u) |
                          (c + 1 < PATCH && cur.x0 + c + 1 < g.wa ? 0xffff0000u : 0u);
    const int sq_lo = (c - HALF) * (c - HALF), sq_hi = (c + 1 - HALF) * (c + 1 - HALF);
    const float x_lo = static_cast<float>(c - HALF), x_hi = x_lo + 1.0f;
    float m10 = 0.0f, m01 = 0.0f;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      if (i < ROWS_PER_WARP - 1 || warp < PATCH - (ROWS_PER_WARP - 1) * WARPS) {
        const uint32_t w = src[i * WARPS * RAW_WORDS] & mask;
        const uint32_t nxt = __shfl_down_sync(FULL, w, 1);
        const uint32_t pair = __byte_perm(w, nxt, 0x5432);  // (w.hi, nxt.lo)
        dst[i * WARPS * PITCH] = s ? pair : w;
        dst[COPY1 + i * WARPS * PITCH] = s ? nxt : pair;
        const int dy = warp + i * WARPS - HALF, room = HALF * HALF - dy * dy;
        const float lo = sq_lo <= room ? bf_lo(w) : 0.0f;
        const float hi = sq_hi <= room ? bf_hi(w) : 0.0f;
        m10 = fmaf(lo, x_lo, fmaf(hi, x_hi, m10));
        m01 = fmaf(lo + hi, static_cast<float>(dy), m01);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m10 += __shfl_xor_sync(FULL, m10, off);
      m01 += __shfl_xor_sync(FULL, m01, off);
    }
    if (lane == 0) red[warp] = make_float2(m10, m01);
    __syncthreads();

    // The raw buffer just turned into the tile takes the keypoint after next.
    Origin after{0, 0};
    if (more) {
      after = origin_of(g, coming, levels);
      stage(g, after, raw[j & 1]);
    } else {
      commit_empty();
    }

    float s10 = 0.0f, s01 = 0.0f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      s10 += red[i].x;
      s01 += red[i].y;
    }
    const int bin = sector32(s10, s01);
    const uint32_t* heads = g.heads + bin * NSAMP;
    const uint4* wts = g.weights + 2 * bin * NSAMP;
    const uint32_t h0 = heads[t], h1 = heads[THREADS + t];
    const uint4 a0 = wts[2 * t], d0 = wts[2 * t + 1];
    const uint4 a1 = wts[2 * (THREADS + t)], d1 = wts[2 * (THREADS + t) + 1];
    vals[h0 >> 12] = sample_value(tile, h0, a0, d0);
    vals[h1 >> 12] = sample_value(tile, h1, a1, d1);
    wait_all_but_newest();
    __syncthreads();

    g.out[static_cast<int64_t>(k) * NBITS + t] = vals[NBITS + t] > vals[t] ? 1 : -1;
    if (t == 0) g.bins[k] = bin;
    cur = next;
    next = after;
  }
}

// Resident blocks of the kernel on the current device, cached per device.
int resident_blocks() {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>* slot = dev < 64 ? &cache[dev] : nullptr;
  int n = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, orb_describe_kernel, THREADS, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
    if (slot) slot->store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace

extern "C" int slideo_orb_describe(const void* atlas, int ha, int wa, const void* y,
                                   const void* x, const void* level, const void* level_table,
                                   int n_levels, int k, const void* heads, const void* weights,
                                   void* bins, void* out, void* stream) {
  if (k <= 0) return 0;
  if (n_levels < 1 || n_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  const Args g{static_cast<const uint16_t*>(atlas), ha, wa,
               static_cast<const int*>(y), static_cast<const int*>(x),
               static_cast<const int*>(level), static_cast<const int*>(level_table),
               n_levels, k,
               static_cast<const uint32_t*>(heads), static_cast<const uint4*>(weights),
               static_cast<int*>(bins), static_cast<int8_t*>(out)};
  const int slots = resident_blocks();
  orb_describe_kernel<<<k < slots ? k : slots, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
