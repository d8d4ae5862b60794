// Tensor-core building blocks of the fused-MLP kernels (mlp.cu): warp-level
// mma.sync tile products, fragment loads from shared memory and the
// cp.async copies that feed a multi-stage shared-memory ring.
//
// One source serves fp32 and bf16. Both mma shapes consume 32 bytes of each
// operand row per k-step (m16n8k8 tf32: 8 floats; m16n8k16 bf16: 16
// halves), and their fragments sit at the same 32-bit word positions:
// lane (g = lane / 4, t = lane % 4) holds A words (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) and B words (n = g, t), (g, t + 4). So an
// operand stored k-contiguous ("natural": A as [row][k], B as [n][k]) is
// read with the same ldmatrix for both types. An operand stored k-major
// ("transposed": [k][row]) is read with 32-bit loads at transposed offsets
// in fp32 and with ldmatrix.trans in bf16.
//
// fp32 runs as 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): each
// operand x splits into big, x rounded to tf32's 11 significant bits, and
// small = x - big (exact in fp32; the mma reads its top 11 bits), and
// small*big + big*small + big*big are summed in fp32. Each product of two
// tf32 values is exact in fp32. big comes from Veltkamp's split, t = x *
// (2^13 + 1), big = t - (t - x): round to nearest in three fp32 operations
// on the FMA pipe, measured faster on the card than cvt.rna.tf32.f32
// (which it matches but at ties).
//
// The tensor cores' fp32 accumulation truncates, so its error grows
// linearly with the reduction length: on an H100 a 1024-long 3xTF32 sum
// of one-signed terms kept in one mma accumulator is 1e-4 off, 6x an fp32
// fmaf loop (probes/accumulate.cu). So an mma accumulator runs over at
// most one stage (at most 64 of k), or for the (64, C) accumulators of the
// row kernels over one k-step (``mma_step_fresh``), and is then added into
// an fp32 sum with ordinary rounded adds, which brings 3xTF32 (and bf16)
// to the accuracy of an fp32 SIMT product.
//
// Bank conflicts. Natural tiles use a row stride of 8n + 4 words (the
// eight 16-byte rows of an ldmatrix phase then sit in distinct bank
// groups); transposed tiles a
// row stride of width + 8 elements (fp32: lanes t * stride + g distinct;
// bf16: the eight 16-byte rows of an ldmatrix phase in distinct bank
// groups).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared, bypassing L1; zero-fills when !valid (``src``
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies ROWS rows of WORDS 32-bit words (a multiple of 4) from ``src``
// (row pitch ``pitch`` bytes) to shared ``dst`` (row stride ``ld`` words).
// Rows at or past ``valid_rows`` are zero-filled.
template <int ROWS, int WORDS, int THREADS>
__device__ __forceinline__ void copy_tile(uint32_t* dst, int ld,
                                          const void* src, long long pitch,
                                          int valid_rows) {
  constexpr int CH = WORDS / 4;
  const char* s = static_cast<const char*>(src);
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * ld + 4 * c, s + (ok ? r * pitch : 0) + 16 * c, ok);
  }
}

// A block's cp.async ring of NSTAGES slots of NSLOT words: ``issue(s)``
// copies stage s of the block's flat schedule into slot s % NSTAGES (and
// always commits a group); ``next()`` waits for the oldest stage, issues
// the one NSTAGES - 1 ahead and returns the oldest stage's slot.
template <int NSTAGES, int NSLOT, typename Issue>
struct Ring {
  uint32_t* smem;
  Issue issue;
  int s;
  __device__ __forceinline__ const uint32_t* next() {
    cp_async_wait<NSTAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    issue(s + NSTAGES - 1);
    return smem + (s++ % NSTAGES) * NSLOT;
  }
};
template <int NSTAGES, int NSLOT, typename Issue>
__device__ __forceinline__ Ring<NSTAGES, NSLOT, Issue> start_ring(uint32_t* smem,
                                                                 Issue issue) {
#pragma unroll 1
  for (int s = 0; s < NSTAGES - 1; ++s) issue(s);
  return Ring<NSTAGES, NSLOT, Issue>{smem, issue, 0};
}

// ---- fragment loads ---------------------------------------------------------

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// ldmatrix on the shared addresses each lane gives: four 8 x 8 b16
// matrices (lanes 8i.. 8i + 7 address matrix i's rows), two (lanes 0..15;
// the others' addresses are ignored), or two transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&w)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&w)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(w[0]), "=r"(w[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&w)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(w[0]), "=r"(w[1])
               : "r"(smem_addr(p)));
}

// A from a natural tile [row][word], rows row0.. row0 + 15, words kw..kw + 7:
// ldmatrix on a b16 view, whose 8 x 8 matrices of 16-byte rows hand lane
// (g, t) word t of row g, the fragment's word for fp32 and bf16 alike.
__device__ __forceinline__ void load_a_nat(uint32_t (&w)[4], const uint32_t* s,
                                           int ld, int row0, int kw) {
  const int l = threadIdx.x & 31, j = l >> 3;
  ldsm_x4(w, s + (row0 + (j & 1) * 8 + (l & 7)) * ld + kw + (j >> 1) * 4);
}

// B from a natural tile [n][word], columns n0.. n0 + 7, words kw..kw + 7.
__device__ __forceinline__ void load_b_nat(uint32_t (&w)[2], const uint32_t* s,
                                           int ld, int n0, int kw) {
  const int l = threadIdx.x & 15;  // lanes 16..31 repeat 0..15's addresses
  ldsm_x2(w, s + (n0 + (l & 7)) * ld + kw + (l >> 3) * 4);
}

// A from a transposed tile [k][row] of T (row stride ld elements): rows
// row0.. row0 + 15, k-step starting at element row k0.
__device__ __forceinline__ void load_a_tr(uint32_t (&w)[4], const float* s,
                                          int ld, int row0, int k0) {
  const float* p = s + (k0 + lane_t()) * ld + row0 + lane_g();
  w[0] = __float_as_uint(p[0]);
  w[1] = __float_as_uint(p[8]);
  w[2] = __float_as_uint(p[4 * ld]);
  w[3] = __float_as_uint(p[4 * ld + 8]);
}
__device__ __forceinline__ void load_a_tr(uint32_t (&w)[4],
                                          const __nv_bfloat16* s, int ld,
                                          int row0, int k0) {
  const int l = threadIdx.x & 31, j = l >> 3, r = l & 7;
  const __nv_bfloat16* p = s + (k0 + (j >> 1) * 8 + r) * ld + row0 + (j & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
      : "r"(smem_addr(p)));
}

// B from a transposed tile [k][n] of T: columns n0.. n0 + 7, k-step at k0.
__device__ __forceinline__ void load_b_tr(uint32_t (&w)[2], const float* s,
                                          int ld, int n0, int k0) {
  const float* p = s + (k0 + lane_t()) * ld + n0 + lane_g();
  w[0] = __float_as_uint(p[0]);
  w[1] = __float_as_uint(p[4 * ld]);
}
__device__ __forceinline__ void load_b_tr(uint32_t (&w)[2],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0) {
  const int l = threadIdx.x & 15;  // lanes 16..31 repeat 0..15's addresses
  ldsm_x2_trans(w, s + (k0 + l) * ld + n0);
}

// ---- the products -----------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same from a zero accumulator: d = A B.
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operands as the tensor cores take them: fp32 in two tf32 parts (big,
// small), bf16 as loaded. ``mma(c, a, b, pass)`` runs pass 0..PASSES-1 of
// the product: small*big, big*small, big*big in fp32; the one bf16 product.
// ``fresh`` runs pass 0 from a zero accumulator.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int PARTS = 2;
  template <int N>
  __device__ __forceinline__ static void split(const uint32_t (&w)[N],
                                               uint32_t (&p)[PARTS][N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = __uint_as_float(w[i]);
      const float t = __fmul_rn(x, 8193.0f);  // _rn: never contracted to fma
      const float big = __fsub_rn(t, __fsub_rn(t, x));
      p[0][i] = __float_as_uint(big);
      p[1][i] = __float_as_uint(__fsub_rn(x, big));
    }
  }
  static constexpr int PASSES = 3;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (&a)[PARTS][4],
                                             const uint32_t (&b)[PARTS][2],
                                             int pass) {
    mma_tf32(c, a[pass == 0], b[pass == 1]);
  }
  __device__ __forceinline__ static void fresh(float (&d)[4],
                                               const uint32_t (&a)[PARTS][4],
                                               const uint32_t (&b)[PARTS][2]) {
    mma_tf32_fresh(d, a[1], b[0]);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int PARTS = 1;
  template <int N>
  __device__ __forceinline__ static void split(const uint32_t (&w)[N],
                                               uint32_t (&p)[PARTS][N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[0][i] = w[i];
  }
  static constexpr int PASSES = 1;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (&a)[PARTS][4],
                                             const uint32_t (&b)[PARTS][2],
                                             int) {
    mma_bf16(c, a[0], b[0]);
  }
  __device__ __forceinline__ static void fresh(float (&d)[4],
                                               const uint32_t (&a)[PARTS][4],
                                               const uint32_t (&b)[PARTS][2]) {
    mma_bf16_fresh(d, a[0], b[0]);
  }
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// One k-step of a warp's (MT x 16) x (NT x 8) tile product:
// acc[mi][ni] += A(mi) B(ni), straight into the mma accumulators (the
// caller keeps the reduction short and adds acc into an fp32 sum).
// ``load_a(mi, w)`` and ``load_b(ni, w)`` fetch raw fragment words; each is
// split once. The passes run one after the other over all MT x NT tiles,
// so consecutive mma are independent.
template <typename T, int MT, int NT, typename LA, typename LB>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], LA load_a,
                                         LB load_b) {
  constexpr int P = Mma<T>::PARTS;
  uint32_t a[MT][P][4], b[NT][P][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    uint32_t w[4];
    load_a(mi, w);
    Mma<T>::split(w, a[mi]);
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    uint32_t w[2];
    load_b(ni, w);
    Mma<T>::split(w, b[ni]);
  }
#pragma unroll
  for (int pass = 0; pass < Mma<T>::PASSES; ++pass)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) Mma<T>::mma(acc[mi][ni], a[mi], b[ni], pass);
}

// The same for an accumulator too large to keep a second copy of in
// registers: each column of MT tiles runs its passes from a zero
// accumulator, which is then added into acc in fp32. A comes split
// already: ``load_a(mi, parts)`` fills all PARTS of row tile mi.
template <typename T, int MT, int NT, typename LA, typename LB>
__device__ __forceinline__ void mma_step_fresh(float (&acc)[MT][NT][4],
                                               LA load_a, LB load_b) {
  constexpr int P = Mma<T>::PARTS;
  uint32_t a[MT][P][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) load_a(mi, a[mi]);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    uint32_t w[2], b[P][2];
    load_b(ni, w);
    Mma<T>::split(w, b);
    float d[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) Mma<T>::fresh(d[mi], a[mi], b);
#pragma unroll
    for (int pass = 1; pass < Mma<T>::PASSES; ++pass)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) Mma<T>::mma(d[mi], a[mi], b, pass);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[mi][e];
  }
}

// acc += part, element by element, in fp32.
template <int MT, int NT>
__device__ __forceinline__ void add_to(float (&acc)[MT][NT][4],
                                       const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
}

// Two fp32 values rounded to T and stored at ``p`` (consecutive elements).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace mp
