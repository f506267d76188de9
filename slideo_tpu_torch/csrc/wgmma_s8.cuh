// Hopper helpers of screen.cu's TMA / wgmma kernel: mbarriers, TMA tile
// loads into shared memory, wgmma m64n128k32 s8.s8.s32 with both operands
// in shared memory (K-major, 128- or 64-byte swizzle), setmaxnreg and named
// barriers. sm_90a only.
#pragma once

#include <stdint.h>

#include "int8_mma.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// An arrival that also expects `bytes` more of TMA traffic on the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A wait of over
// 2^34 clocks (about 10 s) traps, so a fault in a ring's accounting ends
// the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// TMA tile loads: the box at coordinates (c0 innermost, ...) of the tensor
// map into shared memory at dst, completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor of a K-major tile whose rows of
// `row_bytes` (128, 64 or 32) lie in the swizzle of that width (as TMA
// writes them): start address, stride of 8-row groups (SBO), layout 1
// (128 B), 2 (64 B) or 3 (32 B); the leading offset is unused in a
// swizzled K-major layout. A k-step of 32 bytes advances the start address
// by 32.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, int row_bytes) {
  const uint64_t addr = smem_addr(tile);
  const uint64_t sbo = static_cast<uint64_t>(8 * row_bytes) >> 4;
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return ((addr & 0x3FFFF) >> 4) | (sbo << 32) | (layout << 62);
}

// Byte offset of byte 0 of row `row` in a 32-byte-swizzled K-major tile:
// the 16-byte unit (address bit 4) XOR the 128-byte line's bit 7.
__device__ __forceinline__ int swizzle32_row(int row) { return row * 32 + ((row >> 2) & 1) * 16; }

// Orders this thread's shared-memory writes before the async proxy's
// (wgmma's) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most kPending of this warpgroup's committed groups are
// still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's fence and wait.
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x 128, int32) = A (64 x 32 bytes) * B (128 x 32 bytes)^T + (scale_d ? d : 0),
// A and B K-major in shared memory. Thread t of the warpgroup holds
// d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + e].
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Moves registers between the warpgroups of a block: a block's registers
// are fixed at launch, so the increases may take only what decreases freed.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Barrier `id` (1-15) among `threads` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace
