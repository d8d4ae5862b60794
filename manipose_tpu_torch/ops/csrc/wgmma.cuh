// Hopper building blocks of the wgmma kernels: K5's and K6's (mlp.cu), the
// fp32 linear's (linear.cu) and the accumulation probe's
// (probes/accumulate.cu): mbarriers, TMA tile loads, the fence between the
// generic and the async proxy, named barriers, the tf32 wgmma (64 x 64 and
// 64 x 128 tiles) with its shared-memory descriptors; the persistent
// 3xTF32 tile product that K6's dX and dW and the linear's three products
// run (``gemm``); and, on the host, the tensor maps and the SM count.
// sm_90a only.
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
#include <cudaTypedefs.h>

#include <cstdint>
#include <mutex>

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

// ---- the persistent 3xTF32 tile product -------------------------------------

constexpr int KB = 32;         // k per stage: one 128-byte row of a box
constexpr int THREADS = 384;   // a producer and two consumer warpgroups

// A's fragment of one k-step in registers, split into its tf32 parts.
struct Frag {
  uint32_t big[4], small[4];
};

// A ring's slot and the parity of its current use.
struct Ring {
  int i = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int slots) {
    if (++i == slots) {
      i = 0;
      phase ^= 1;
    }
  }
};

// out (R, N) tiles of 256 x 128 = sum over k of A(r, k) B(n, k), two
// consumer warpgroups of 128 rows each, as two 64-row halves that share
// the stage's B, k in stages of 32. B arrives as big and small tf32 planes
// in 128 x 32 boxes. A comes in one of three layouts:
//   A_RAW     32 x 32 boxes laid [k][r] (r contiguous), raw fp32, split in
//             registers (K6's dW, the linear's dW);
//   A_PLANES  the same boxes of A's big and small tf32 planes (K6's dX);
//   A_ROWS    one box of 256 rows x 32 k laid [r][k] (k contiguous), raw
//             fp32, split in registers as K5 splits x (the linear's
//             forward and dX).
// Each half's stage products go into a fresh 64 x 128 accumulator, small
// parts' first, then into the half's fp32 sum.
enum ALayout : int { A_RAW = 0, A_PLANES = 1, A_ROWS = 2 };
constexpr int TILE_ROWS = 256;
constexpr int A_BOX = 4096;          // 32 x 32 fp32
constexpr int B_PLANE = 16384;       // 128 x 32 fp32
template <int A>
struct Gemm {
  static constexpr int A_HALF = (A == A_PLANES ? 4 : 2) * A_BOX;  // a half's A a stage
  static constexpr int STAGE = 2 * B_PLANE + 4 * A_HALF;
  static constexpr int STAGES = A == A_PLANES ? 2 : 3;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr int SMEM = OFF_BAR + 16 * STAGES + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

// One work item: out rows a0.. (A's row coordinate), columns b0.. (B's
// outer coordinate), k in [k_begin, k_end); a_rows and b_rows are where
// the small planes start in the maps' outer coordinate. ``rows``: the
// item also sums A's raw values over its k, row by row (A_RAW with
// ROWSUM only).
struct Work {
  const CUtensorMap* a;
  const CUtensorMap* b;
  int a0, a_rows, b0, b_rows, k_begin, k_end;
  bool rows = false;
};

__device__ __forceinline__ void products128(float (&d)[64], const Frag& a, uint32_t b_big,
                                            int s) {
  const uint64_t bb = desc_swizzled(b_big + 32 * s);
  mma128(d, a.small, bb, s == 0 ? 0 : 1);
  mma128(d, a.big, desc_swizzled(b_big + B_PLANE + 32 * s), 1);
  mma128(d, a.big, bb, 1);
}

// One stage, 4 k-steps of 8, into the fresh 64 x 128 accumulator d, A's
// fragments from ``load(s, frag)``, two in flight at a time. Returns with
// the products done.
template <typename Load>
__device__ __forceinline__ void stage128(float (&d)[64], uint32_t b_big, Load load) {
  Frag f[2];
#pragma unroll
  for (int s = 0; s < KB / 8; ++s) {
    Frag& a = f[s & 1];
    if (s >= 2) mma_wait<1>();  // the products of k-step s - 2 read a
    load(s, a);
    pin(a.big);
    pin(a.small);
    mma_fence();
    products128(d, a, b_big, s);
    mma_commit();
  }
  mma_wait<0>();
  pin(d);
}

// The whole of a tile-product kernel of 384 threads: ``work(i)`` describes
// item i of ``items``; ``store(i, sum, row0, row1)`` writes a half's fp32
// sums, this thread's rows being row0 and row1 of the tile's 256 (d's h =
// 0 and 1). With ROWSUM, ``store`` also takes the two rows' sums of A's
// raw values over the item's k (a Work's ``rows``; all four lanes of a
// quad hold them), summed in a fixed order.
template <int A, bool ROWSUM = false, typename WorkOf, typename Store>
__device__ __forceinline__ void gemm(int items, WorkOf work, Store store) {
  static_assert(!ROWSUM || A == A_RAW, "row sums of raw [k][r] boxes only");
  using G = Gemm<A>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sa(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* empty = full + G::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring r;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Work w = work(i);
      for (int k0 = w.k_begin; k0 < w.k_end; k0 += KB) {
        bar_wait(&empty[r.i], r.phase ^ 1);
        uint8_t* slot = smem + r.i * G::STAGE;
        bar_expect(&full[r.i], G::STAGE);
        tma_load(slot, w.b, k0, w.b0, &full[r.i]);
        tma_load(slot + B_PLANE, w.b, k0, w.b_rows + w.b0, &full[r.i]);
        if constexpr (A == A_ROWS) {
          tma_load(slot + 2 * B_PLANE, w.a, k0, w.a0, &full[r.i]);
        } else {
          for (int q = 0; q < TILE_ROWS / 32; ++q) {  // half q / 2, its rows 32 (q % 2)..
            uint8_t* a = slot + 2 * B_PLANE + (q >> 1) * G::A_HALF + (q & 1) * A_BOX;
            tma_load(a, w.a, w.a0 + 32 * q, k0, &full[r.i]);
            if constexpr (A == A_PLANES) tma_load(a + 2 * A_BOX, w.a, w.a0 + 32 * q,
                                                  w.a_rows + k0, &full[r.i]);
          }
        }
        r.next(G::STAGES);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = (threadIdx.x >> 7) - 1, lt = threadIdx.x & 127;
  const int wi = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  // [k][r] boxes: wgmma row 16 wi + 8 h + g reads A's row rho(h) of the
  // half's 64, so that the 32 lanes of a fragment load hit 32 banks of the
  // swizzled boxes: 4 t x 8 g at chunks (4 (g / 4) + c') ^ t, words g % 4.
  // [r][k] boxes: row 16 wi + 8 h + g itself, at 128 bytes a row, its
  // k-step s's chunks 2 s and 2 s + 1 at (chunk ^ g) (8 rows of one chunk
  // hit every bank once, as K5's x).
  auto rho = [&](int h) {
    if constexpr (A == A_ROWS) {
      return 16 * wi + 8 * h + g;
    } else {
      return 32 * (wi >> 1) + 4 * (2 * (wi & 1) + h + 4 * (g >> 2)) + (g & 3);
    }
  };
  int off[2][2];  // bytes of (row rho(h), k t + 4q) in its half's boxes
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = rho(h), k = t + 4 * q;
      off[h][q] = A == A_ROWS ? row * 128 + 4 * t
                              : (row >> 5) * A_BOX + k * 128 +
                                    ((((row & 31) >> 2) ^ k) << 4) + (row & 3) * 4;
    }
  const uint32_t base = sa(smem);
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Work w = work(i);
    float sum[2][64], d[64];
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[hf][e] = 0.f;
#pragma unroll 1
    for (int k0 = w.k_begin; k0 < w.k_end; k0 += KB) {
      bar_wait(&full[r.i], r.phase);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint8_t* as = smem + r.i * G::STAGE + 2 * B_PLANE + (2 * c + hf) * G::A_HALF;
        stage128(d, base + r.i * G::STAGE, [&](int s, Frag& a) {
          auto word = [&](int h, int q, int part) {
            if constexpr (A == A_ROWS) {
              return *reinterpret_cast<const uint32_t*>(as + off[h][q] +
                                                        (((2 * s + q) ^ g) << 4));
            } else {
              return *reinterpret_cast<const uint32_t*>(as + part * 2 * A_BOX + off[h][q] +
                                                        1024 * s);
            }
          };
          if constexpr (A == A_PLANES) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a.big[e] = word(e & 1, e >> 1, 0);
              a.small[e] = word(e & 1, e >> 1, 1);
            }
          } else {
            const uint32_t raw[4] = {word(0, 0, 0), word(1, 0, 0), word(0, 1, 0),
                                     word(1, 1, 0)};
            if constexpr (ROWSUM) {
              if (w.rows) {
                rs[hf][0] += __uint_as_float(raw[0]) + __uint_as_float(raw[2]);
                rs[hf][1] += __uint_as_float(raw[1]) + __uint_as_float(raw[3]);
              }
            }
            uint32_t p[2][4];
            mp::Mma<float>::split(raw, p);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a.big[e] = p[0][e];
              a.small[e] = p[1][e];
            }
          }
        });
#pragma unroll
        for (int e = 0; e < 64; ++e) sum[hf][e] += d[e];
      }
      if (lane == 0) bar_arrive(&empty[r.i]);
      r.next(G::STAGES);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row0 = 128 * c + 64 * hf + rho(0), row1 = 128 * c + 64 * hf + rho(1);
      if constexpr (ROWSUM) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) rs[hf][h] += __shfl_xor_sync(0xffffffffu, rs[hf][h], o);
        store(i, sum[hf], row0, row1, rs[hf]);
      } else {
        store(i, sum[hf], row0, row1);
      }
    }
  }
}

}  // namespace wg

// ---- host: tensor maps and the SM count -------------------------------------

// cuTensorMapEncodeTiled from the CUDA driver, looked up once through the
// runtime (the libraries link the runtime only).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  });
  return fn;
}

// A row-major (rows, cols) fp32 matrix, rows ``pitch`` elements apart (cols
// when 0), read in boxes of box_rows rows x 32 columns (128 bytes,
// swizzled as wgmma reads them); rows and columns past the end read zeros.
inline bool encode_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows = 64,
                       long long pitch = 0) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch ? pitch : cols) * sizeof(float)};
  const cuuint32_t box[2] = {wg::KB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of ``device``, asked once per device (a captured launch makes no
// attribute call).
inline cudaError_t sm_count(int device, int* n_sm) {
  constexpr int DEVICES = 16;
  static int sms[DEVICES] = {};
  *n_sm = device >= 0 && device < DEVICES ? sms[device] : 0;
  if (*n_sm == 0) {
    cudaError_t err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < DEVICES) sms[device] = *n_sm;
  }
  return cudaSuccess;
}

}  // namespace mp
