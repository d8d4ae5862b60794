// Hopper building blocks of K5's and K6's wgmma kernels (mlp.cu) and of
// the accumulation probe (probes/accumulate.cu): mbarriers, TMA tile loads,
// the fence between the generic and the async proxy, named barriers, and
// the tf32 wgmma (64 x 64 and 64 x 128 tiles) with its shared-memory
// descriptors. sm_90a only.
//
// Operand layouts (K-major, 64 rows, fp32 read as tf32). "plain": 8 x
// 16-byte core matrices, rows 16 bytes apart, 8-row groups 128 bytes
// apart, the two 16-byte halves of a k-step of 8 1024 bytes apart, so a
// k-step takes 2 KB; written with ordinary stores (the probe's operands;
// K5's GELU planes, which it reads back as register fragments).
// "swizzled": TMA's 128-byte swizzle, rows 128 bytes apart (32 k), 8-row
// groups 1024 bytes apart, 16-byte chunk q of row r at q ^ (r % 8); a
// k-step is 32 bytes further along the row (K5's and K6's weight boxes;
// a box of 128 rows is 16 such 8-row groups).
#pragma once

#include <cuda.h>

#include <cstdint>

#include "mma.cuh"

namespace mp {
namespace wg {

__device__ __forceinline__ uint32_t sa(const void* p) { return mp::smem_addr(p); }

// ---- mbarriers, TMA, proxy fences, named barriers ---------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sa(b)), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sa(b)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sa(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = sa(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// a 2-D box of the tensor map at element coordinates (c0 inner, c1 outer)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(sa(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sa(b)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier ``id`` (1-15) among ``threads`` threads, whole warps
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptors of a k-step of 8 of a 64-row operand at ``addr``, in the
// plain layout (LBO 1024 bytes between the k-halves, SBO 128 between the
// 8-row groups) or the swizzled one (SBO 1024; LBO unused).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1024 >> 4} << 16) |
         (uint64_t{128 >> 4} << 32);
}
__device__ __forceinline__ uint64_t desc_swizzled(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (+)= A B over one k-step of 8: A 64 x 8 and B 64 x 8 tf32 from shared
// memory; d is the warpgroup's 64 x 64 fp32 accumulator (32 a thread).
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// The same with A in registers: thread (g = lane / 4, t = lane % 4) of
// warp w holds A's rows 16w + g and 16w + g + 8 at k t and t + 4, as
// a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}. The registers stay
// untouched until a wait_group covers the product.
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// The same over a 64 x 128 tile: B 128 x 8 from shared memory (a box of
// 128 rows), d the warpgroup's 64 x 128 fp32 accumulator (64 a thread:
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e).
__device__ __forceinline__ void mma128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// Keeps the compiler from moving writes of ``a`` past the fence below.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins reads of the accumulator after the wait that completes it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace wg
}  // namespace mp
