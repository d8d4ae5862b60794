// Fused MLP of the MixSTE trunk: y = gelu(x W1^T + b1) W2^T + b2 with the
// exact (erf) GELU, fp32 accumulation, fp32 or bf16 inputs, and its
// gradient. Weights come in torch Linear layout: W1 is (H, C), W2 is (C, H).
//
// Replaces the TPU kernels of manipose_tpu/ops/pallas_mlp.py:
//   fused_mlp_kernel         <- _forward / _fwd_kernel (pallas_mlp.py:83-88,
//                               95-115); for fp32 at C = 512,
//                               fused_mlp_kernel_split, then _sm90
//   fused_mlp_bwd_*_kernel   <- _backward / _bwd_kernel (pallas_mlp.py:123-169,
//                               172-211); for fp32 at C = 512,
//                               fused_mlp_bwd_rows_kernel_split and _sm90,
//                               fused_mlp_bwd_gemm_kernel_dx and _dw,
//                               fused_mlp_bwd_reduce_kernel_sm90
//
// What bounds them on an H100. Every product runs on the tensor cores: bf16
// in one pass, fp32 as 3xTF32, three tf32 passes over operands split into
// big and small tf32 parts, which keeps fp32 accuracy. Against the data
// sheet (dense, 700 W) that is 989 TFLOP/s in bf16 and 495 / 3 = 165
// TFLOP/s for fp32 products; mma.sync (mma.cuh) peaks lower on the card
// (probes/mma_rate.cu: 324 tf32 and 649 bf16 TFLOP/s, so 108 for 3xTF32),
// wgmma does not. At the flagship's rotations trunk (M = 66096 rows, C =
// 512, H = 1024) the forward does 4*M*C*H = 138.6 GFLOP against 0.28 GB
// of device memory (3.35 TB/s) in fp32, so operations bound it (0.84 ms);
// two plain GEMMs would also write and re-read the (M, H) intermediate,
// 0.54 GB more. The backward does five such products, 10*M*C*H = 346
// GFLOP (2.1 ms). Between the two sits L2: every 64-row tile re-reads x
// and the weights chunk by chunk (6.3 GB a forward launch in the mma.sync
// kernel, 9.3 GB with the wgmma kernel's split weights). In fp32 the
// kernels issue more than the tensor cores do: the operand splits,
// fragment loads and fp32 adds (probes/run_probes.py ablates each).
//
// Design of the mma.sync kernels. 8 warps over a cp.async ring of 3 or 4
// slots (16-byte copies, no register staging) that holds operand tiles
// laid out as the mma fragments read them (ldmatrix for k-contiguous
// tiles, mma.cuh), so the next k-slices land while the current one is
// multiplied. The ring runs over one flat schedule of stages per block,
// so prefetch crosses from one product to the next and from one hidden
// chunk to the next. The tensor cores' fp32 accumulation
// truncates (its error grows with the reduction length), so an mma
// accumulator runs over at most one stage (64 of k) or, for the (64, C)
// accumulators, one k-step, and is then added into an fp32 sum.
//
// Forward (K5) on mma.sync, for bf16 and fp32's other widths. The whole
// (64, C) fp32 output accumulator sits in mma fragments over the 8 warps
// (each owns C/8 columns; 128 registers a thread at C = 512). The block
// walks H in chunks of 64 hidden units: the
// chunk of fc1 (x and W1 rows streamed as they lie in memory, both
// k-contiguous; warps 2 x 4 over 32 x 16 tiles), bias and exact GELU in
// registers, the chunk to shared memory once, split into the parts the
// mma takes (rounded to bf16 under bf16, as pallas_mlp.py:86 does), then
// the chunk's fc2 into the accumulator, W2's rows streamed k-contiguous as
// well. The (M, H) intermediate never reaches device memory. Rows past M
// are zero-filled on load and masked on store, so any M is taken.
//
// Forward (K5) on wgmma, for fp32 at C = 512 and H a multiple of 128 (the
// rotations trunk; cuda_mlp.takes_wgmma), at any M: one tile of 64 rows
// takes half the mma.sync kernel's time. A persistent block an SM walks
// the row tiles with three warpgroups. The producer (40 registers) keeps
// TMA loads in flight, each into its own ring with full and empty
// mbarriers: lane 0 of warp 0 loads x's boxes (64 rows x 32 k), lane 0 of
// warp 1 + c the weight boxes of consumer c. The two consumers (232
// registers each) take 128 hidden units at a time: consumer c computes
// fc1 for units 64c.. (m64n64, K = 512 in 16 stages of 32), bias and
// GELU, and writes them split into two tf32 planes in shared memory; once
// both have (named barriers 1 and 2), consumer c computes fc2 for output
// columns 256c.. over all 128 units, 32 units a stage: their fragments
// loaded once, then four 64-column parts. Its registers: the (64, 256)
// fp32 output sums 128, fc1's fp32 sum 32, the wgmma accumulator 32, A's
// fragments 16 in fc1 (two k-steps in flight), 32 in fc2.
// wgmma reads B from shared memory only, so the weights arrive split:
// fused_mlp_kernel_split writes W1's and W2's big and small planes into
// scratch once a launch (4 x 2 MB), which TMA loads in 128-byte swizzled
// boxes, wgmma's layout. A comes from registers and is split there: x
// from its raw box per k-step (so no split copy of x in shared memory and
// no producer work on it: a first version split x once a stage in shared
// memory, in three producer warps, and took 1.58 ms at M = 66096, the
// split on the critical path), the GELU chunk from its planes (W2's
// planes hold each 8 units in the order the chunk is stored). Each stage
// (32 of k) runs in a fresh accumulator, small parts' products first, and
// is added into the fp32 sum: one accumulator over K = 1024 is 1.85e-5
// off fp64, one per 64 of k 1.46e-6, per 32 8.6e-7, an fp32 fmaf loop
// 2.75e-6 (probes/accumulate.cu, inputs of both signs), and per 32 costs
// no measured time. Shared memory: W rings 2 x 4 x 16 KB, x ring 4 x 8
// KB, GELU planes 64 KB. Each output is summed in one fixed order, with
// no atomics and no split of k: runs agree bit for bit. The tensor maps
// are encoded on the host at each launch and passed as __grid_constant__
// parameters, the scratch is the caller's, nothing synchronizes: a CUDA
// graph captures the launch. At M = 66096 it takes 1.35-1.37 ms (101-103
// TFLOP/s, 61 % of 165); with one tf32 pass 0.86, with no wgmma at all
// 0.98, without the weights' or x's loads no faster (run_probes wgmma):
// the consumers' own instructions (fragment loads, splits, the wait and
// fp32 adds a stage, GELU) bound it, not the loads. Loading fc2's
// fragments once for its four parts, not once a part, took 1.50 to 1.35
// ms. Tried and slower: the consumers taking turns to issue (as
// FlashAttention-3's do), 1.63-1.69 ms; two fc2 accumulators, 1.41 (it
// spills); 240 registers a consumer, no change.
//
// Backward (K6) on mma.sync, for bf16 and fp32's other widths. The TPU
// kernel sums dW and db over its sequential grid; blocks on Hopper run in
// no order, so the sums over M take later passes.
// Pass 1 (rows), per 64-row block and chunk: recompute a (as the
// forward), write gelu(a) to (M, H) scratch and keep gelu'(a) in
// registers; dh = g W2[:, chunk] (W2 read k-major: a transposed operand);
// da = dh * gelu'(a), written to (M, H) scratch in the element type. It
// also writes this block's column sums of da (for db1, from the unrounded
// da) and of g (for db2). It holds no (64, C) accumulator, so it fits 128
// registers and two blocks share an SM. Pass 2: three tile GEMMs on
// 128 x 128 output tiles: dX = da W1 over all of H, and dW1 = da^T x and
// dW2 = g^T gelu(a) over a fixed split of M into fp32 partials. Pass 3
// (reduce) adds the slices' partials and the row blocks' column sums in
// a fixed order. No atomics: repeated runs agree bit for bit. Under bf16
// it rounds where _bwd_kernel rounds: gelu(a), g and da before the
// products; db1 sums the unrounded da.
//
// Backward (K6) on wgmma, for the launches K5 sends to wgmma (fp32, C =
// 512, H a multiple of 128; cuda_mlp.takes_wgmma), at any M: 3.16-3.23 ms
// at M = 66096, the mma.sync kernels' 7.2-7.7 (65 % of the 2.10 ms bound,
// 10 M C H at 165 TFLOP/s). wgmma reads a tf32 B from shared memory
// k-major only (its transpose is for 16-bit types), and the weight sums
// reduce over M, where x, g, da and gelu(a) all lie row-major; so pass 1
// writes da and gelu(a) transposed, and x and g, the sums' other
// operands, come through registers as A, which may take any layout.
// fused_mlp_bwd_rows_kernel_split first writes the weights' tf32 planes
// into scratch (W1 (2H, C), W2^T (2H, C), W1^T (2C, H); 12 MB).
// Pass 1, fused_mlp_bwd_rows_kernel_sm90: K5's persistent layout (a TMA
// producer warpgroup, full/empty mbarrier rings, two consumer warpgroups
// of 64 hidden units of a 128-unit pair) over 128-row tiles, whose two
// 64-row halves share each weight box (64-row tiles, reading 8 MB of
// weight boxes a tile, took 1.69 ms). Per pair and half: a - b1 = x
// W1[units]^T and dh = g W2[:, units] (m64n64, K = C in stages of 32, x's
// and g's fragments split in registers from their swizzled boxes, W1's
// and W2^T's planes as B), then gelu(a) and da = dh * gelu'(a) (one erf
// for both), split into big and small tf32 planes and written to (4H, Mp)
// scratch k-major (da^T, gelu(a)^T; 1.08 GB at M = 66096), and db1's
// partial from the unrounded da; producer warp 3 writes db2's (g's column
// sums). Pass 2, fused_mlp_bwd_gemm_kernel_dx and _dw (wgmma.cuh's gemm,
// which linear.cu's fp32 linear shares): persistent blocks
// of a producer and two consumer warpgroups over 256 x 128 output tiles,
// each consumer 128 rows as two m64n128 halves that share the stage's B
// (128 x 128 tiles took 0.57 and 1.19 ms), a TMA ring of 32-deep stages:
// dX = da W1 (A: da^T's planes; B: W1^T's), and dW1^T = x^T da and dW2 =
// g^T gelu(a) over S fixed slices of M into fp32 partials (A: x or g raw,
// split in registers; B: da^T's or gelu(a)^T's planes). A's fragments
// come from 32 x 32 boxes laid [k][r], its rows permuted so that a warp's
// loads hit 32 banks. Pass 3, fused_mlp_bwd_reduce_kernel_sm90, adds the
// partials and the column sums in a fixed order. Every stage's products
// (small parts' first) go into a fresh accumulator added into an fp32
// sum, as K5's: 32 of k an accumulator. No atomics and no split that
// depends on the data: runs agree bit for bit; tail rows read TMA's zeros
// and are masked on store; the tensor maps are encoded on the host and
// passed as __grid_constant__, the scratch is the caller's, nothing
// synchronizes, so a CUDA graph captures the launch.
// What bounds it (run_probes k6wgmma, M = 66096): the rows pass takes 1.52
// ms (91 TFLOP/s), 1.39 with no wgmma at all and 1.36 without its plane
// stores: its consumers' own instructions (fragment loads and splits,
// waits, fp32 adds, the epilogue) bound it, as K5's. The tile products
// take 0.53 (dX) and 1.09 ms (dW), with one tf32 pass 0.36 and 0.53, with
// no wgmma 0.31 and 0.57: the tensor cores bound them (dW at 127 TFLOP/s,
// 77 % of 165).
//
// Not yet: bf16 on wgmma; the rows pass's epilogue overlapped with its
// products (in the same consumer, one element a stage of the next pair,
// it spilled and took 2.69 ms against 1.69); deeper x and g rings (6 or 8
// slots), or both halves' products in flight at once (two accumulators),
// changed nothing; a 2-CTA cluster with TMA multicast of the boxes.

#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 64;        // rows per block of the row kernels
constexpr int BH = 64;        // hidden units per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 4;     // depth of K5's cp.async ring
constexpr int SLOT = 10240;   // 32-bit words per ring slot (40 KB)
constexpr int BWD_STAGES = 3; // K6's row pass: two blocks an SM
constexpr int BWD_SLOT = 8960;

__device__ __forceinline__ float gelu_exact(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float a) {
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  return cdf + a * 0.3989422804014327f * expf(-0.5f * a * a);
}

// Tile geometry of the row kernels for element type T and C channels.
template <typename T, int C>
struct Rows {
  static constexpr int EW = 4 / sizeof(T);  // elements per word
  // words of k per stage of a C-long reduction, and its stages
  static constexpr int KW = (C / EW < 64) ? C / EW : 64;
  static constexpr int N1 = C / (KW * EW);
  // K5's fc2 streams W2 rows (C of them) KW2 words of hidden units a stage
  static constexpr int KW2 = (BH / EW < 8192 / C) ? BH / EW : 8192 / C;
  static constexpr int N2 = BH / EW / KW2;
  static constexpr int NLD = KW + 4;       // natural stage tiles, words
  static constexpr int CLD = BH / EW + 4;  // the chunk tile [row][unit], words
  // the chunk tile holds one part per Mma<T> operand part (fp32: big, small)
  static constexpr int CHUNK = mp::Mma<T>::PARTS * BM * CLD;
  static constexpr int NT = C / 64;        // 8-column tiles per warp, of C
  static_assert(2 * BM * NLD <= SLOT && C * (KW2 + 4) <= SLOT, "slot");
  static_assert(2 * BM * NLD <= BWD_SLOT, "slot");
  static_assert(BM * NLD + KW * EW * (BH + 8) / EW <= BWD_SLOT, "slot");
};

// The warp's place in a (64 rows x 64 units) chunk product: 2 x 4 warps of
// 32 rows x 16 units. Fragment rows / units of (mi, ni, e) are
// chunk_row(mi, e), chunk_unit(ni, e).
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }
__device__ __forceinline__ int chunk_row(int mi, int e) {
  return (warp_id() >> 2) * 32 + mi * 16 + mp::lane_g() + (e >> 1) * 8;
}
__device__ __forceinline__ int chunk_unit(int ni, int e) {
  return (warp_id() & 3) * 16 + ni * 8 + 2 * mp::lane_t() + (e & 1);
}

// One stage of the chunk's fc1 over x and W1 rows in ``slot``.
template <typename T, int C>
__device__ __forceinline__ void fc1_stage(const uint32_t* slot,
                                          float (&acc)[2][2][4]) {
  using R = Rows<T, C>;
  const uint32_t* xs = slot;
  const uint32_t* ws = slot + BM * R::NLD;
  const int wm = warp_id() >> 2, wn = warp_id() & 3;
#pragma unroll
  for (int ks = 0; ks < R::KW / 8; ++ks) {
    mp::mma_step<T>(
        acc,
        [&](int mi, uint32_t (&w)[4]) {
          mp::load_a_nat(w, xs, R::NLD, wm * 32 + mi * 16, ks * 8);
        },
        [&](int ni, uint32_t (&w)[2]) {
          mp::load_b_nat(w, ws, R::NLD, wn * 16 + ni * 8, ks * 8);
        });
  }
}

// Issue the copies of fc1's stage j (k words j*KW..) for rows row0.. and
// hidden units hc..
template <typename T, int C>
__device__ __forceinline__ void fc1_issue(uint32_t* slot, const T* x,
                                          const T* w1, int row0, int M, int hc,
                                          int j) {
  using R = Rows<T, C>;
  constexpr long long pitch = C * sizeof(T);
  const int k = j * R::KW * R::EW;
  mp::copy_tile<BM, R::KW, THREADS>(slot, R::NLD, x + static_cast<long long>(row0) * C + k,
                                    pitch, M - row0);
  mp::copy_tile<BH, R::KW, THREADS>(slot + BM * R::NLD, R::NLD,
                                 w1 + static_cast<long long>(hc) * C + k, pitch, BH);
}

// Store the (64, C) accumulator (+ bias when given) to rows < M of out, in
// the (4 x NT) fragment layout of a warp owning C / 8 columns.
template <typename T, int C>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[4][C / 64][4],
                                           const T* __restrict__ bias, int row0,
                                           int M) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < C / 64; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = row0 + mi * 16 + mp::lane_g() + (e >> 1) * 8;
        const int c = warp_id() * (C / 8) + ni * 8 + 2 * mp::lane_t();
        if (r < M) {
          mp::store2(out + static_cast<long long>(r) * C + c,
                     acc[mi][ni][e] + (bias ? mp::to_float(bias[c]) : 0.f),
                     acc[mi][ni][e + 1] + (bias ? mp::to_float(bias[c + 1]) : 0.f));
        }
      }
}

// Shared memory of a row kernel, in words: the ring and the chunk tile.
template <typename T, int C>
constexpr int rows_smem_words() {
  return STAGES * SLOT + Rows<T, C>::CHUNK;
}

// The chunk tile, written once split into the parts the mma takes (so the
// 8 warps that read it do not each split it again): (row r, units u and
// u + 1) get v0, v1, rounded to T under bf16.
template <typename T, int C>
__device__ __forceinline__ void store_chunk(uint32_t* tile, int r, int u,
                                            float v0, float v1) {
  using R = Rows<T, C>;
  T* at = reinterpret_cast<T*>(tile + r * R::CLD) + u;
  if constexpr (mp::Mma<T>::PARTS == 2) {
    const uint32_t w[2] = {__float_as_uint(v0), __float_as_uint(v1)};
    uint32_t parts[2][2];
    mp::Mma<T>::split(w, parts);
    mp::store2(at, __uint_as_float(parts[0][0]), __uint_as_float(parts[0][1]));
    mp::store2(at + BM * R::CLD * R::EW, __uint_as_float(parts[1][0]),
               __uint_as_float(parts[1][1]));
  } else {
    mp::store2(at, v0, v1);  // rounded to T
  }
}

// Row tile mi's A fragment of the chunk tile at word kw, all its parts.
template <typename T, int C>
__device__ __forceinline__ void load_chunk(uint32_t (&a)[mp::Mma<T>::PARTS][4],
                                           const uint32_t* tile, int mi, int kw) {
  using R = Rows<T, C>;
#pragma unroll
  for (int q = 0; q < mp::Mma<T>::PARTS; ++q) {
    mp::load_a_nat(a[q], tile + q * BM * R::CLD, R::CLD, mi * 16, kw);
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int M, int H) {
  constexpr int C = 64 * NJ;
  using R = Rows<T, C>;
  constexpr int PER = R::N1 + R::N2;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hs = smem + STAGES * SLOT;  // gelu chunk, [part][BM][CLD] of T
  const int row0 = blockIdx.x * BM;
  const int w = warp_id();
  const int total = (H / BH) * PER;

  auto ring = mp::start_ring<STAGES, SLOT>(smem, [&](int s) {
    if (s < total) {
      uint32_t* slot = smem + (s % STAGES) * SLOT;
      const int hc = (s / PER) * BH, j = s % PER;
      if (j < R::N1) {
        fc1_issue<T, C>(slot, x, w1, row0, M, hc, j);
      } else {
        const int u = hc + (j - R::N1) * R::KW2 * R::EW;
        mp::copy_tile<C, R::KW2, THREADS>(slot, R::KW2 + 4, w2 + u,
                                          static_cast<long long>(H) * sizeof(T), C);
      }
    }
    mp::cp_async_commit();
  });

  float acc[4][R::NT][4];
  mp::zero(acc);
#pragma unroll 1
  for (int hc = 0; hc < H; hc += BH) {
    // ---- fc1 of the chunk
    float a[2][2][4];
    mp::zero(a);
#pragma unroll 1
    for (int j = 0; j < R::N1; ++j) {
      float p[2][2][4];  // the stage's partial, added into a in fp32
      mp::zero(p);
      fc1_stage<T, C>(ring.next(), p);
      mp::add_to(a, p);
    }
    // ---- bias + exact GELU; the chunk to hs (read after the next barrier)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = chunk_row(mi, e), u = chunk_unit(ni, e);
          store_chunk<T, C>(hs, r, u, gelu_exact(a[mi][ni][e] + mp::to_float(b1[hc + u])),
                            gelu_exact(a[mi][ni][e + 1] + mp::to_float(b1[hc + u + 1])));
        }
    // ---- fc2: acc += the chunk . W2[:, chunk]^T
#pragma unroll 1
    for (int j = 0; j < R::N2; ++j) {
      const uint32_t* slot = ring.next();
#pragma unroll
      for (int ks = 0; ks < R::KW2 / 8; ++ks) {
        mp::mma_step_fresh<T>(
            acc,
            [&](int mi, auto& f) {
              load_chunk<T, C>(f, hs, mi, j * R::KW2 + ks * 8);
            },
            [&](int ni, uint32_t (&f)[2]) {
              mp::load_b_nat(f, slot, R::KW2 + 4, w * (C / 8) + ni * 8, ks * 8);
            });
      }
    }
  }
  mp::cp_async_wait<0>();
  store_rows<T, C>(out, acc, b2, row0, M);
}

// Pass 1 of the backward, for 64 rows: gelu(a) and da to (M, H) scratch,
// and this block's column sums: colsum[block] holds db1's partial of the
// warp rows 0..31 (H), of rows 32..63 (H), then db2's (C). It keeps no
// (64, C) accumulator (dX is a tile GEMM over da), so two blocks share an
// SM.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 2)
fused_mlp_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ w1, const T* __restrict__ b1,
                          const T* __restrict__ w2, T* __restrict__ da_out,
                          T* __restrict__ h_out, float* __restrict__ colsum,
                          int M, int H) {
  constexpr int C = 64 * NJ;
  using R = Rows<T, C>;
  constexpr int PER = 2 * R::N1;
  constexpr int WLD = BH + 8;     // W2 k-major stage tile [c][unit], elements
  extern __shared__ __align__(16) uint32_t smem[];
  const int row0 = blockIdx.x * BM;
  const int w = warp_id(), wm = w >> 2, wn = w & 3;
  const int total = (H / BH) * PER;
  float* cs = colsum + static_cast<long long>(blockIdx.x) * (2 * H + C);

  // db2's partial: the column sums of g over this block's rows, in order
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float t = 0.f;
    for (int r = row0; r < min(M, row0 + BM); ++r) {
      t += mp::to_float(g[static_cast<long long>(r) * C + c]);
    }
    cs[2 * H + c] = t;
  }

  auto ring = mp::start_ring<BWD_STAGES, BWD_SLOT>(smem, [&](int s) {
    if (s < total) {
      uint32_t* slot = smem + (s % BWD_STAGES) * BWD_SLOT;
      const int hc = (s / PER) * BH, j = s % PER;
      if (j < R::N1) {
        fc1_issue<T, C>(slot, x, w1, row0, M, hc, j);
      } else {  // g slice, and W2[k rows][hc : hc + BH]
        const int k = (j - R::N1) * R::KW * R::EW;
        mp::copy_tile<BM, R::KW, THREADS>(slot, R::NLD,
                                          g + static_cast<long long>(row0) * C + k,
                                          C * sizeof(T), M - row0);
        mp::copy_tile<R::KW * R::EW, BH / R::EW, THREADS>(
            slot + BM * R::NLD, WLD / R::EW, w2 + static_cast<long long>(k) * H + hc,
            static_cast<long long>(H) * sizeof(T), R::KW * R::EW);
      }
    }
    mp::cp_async_commit();
  });

#pragma unroll 1
  for (int hc = 0; hc < H; hc += BH) {
    // ---- a = x . W1[chunk]^T + b1: gelu(a) to scratch, gelu'(a) kept
    float a[2][2][4];
    mp::zero(a);
#pragma unroll 1
    for (int j = 0; j < R::N1; ++j) {
      float p[2][2][4];  // the stage's partial, added into a in fp32
      mp::zero(p);
      fc1_stage<T, C>(ring.next(), p);
      mp::add_to(a, p);
    }
    float gg[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = chunk_row(mi, e), u = chunk_unit(ni, e);
          const float a0 = a[mi][ni][e] + mp::to_float(b1[hc + u]);
          const float a1 = a[mi][ni][e + 1] + mp::to_float(b1[hc + u + 1]);
          gg[mi][ni][e] = gelu_grad(a0);
          gg[mi][ni][e + 1] = gelu_grad(a1);
          if (row0 + r < M) {
            mp::store2(h_out + static_cast<long long>(row0 + r) * H + hc + u,
                       gelu_exact(a0), gelu_exact(a1));
          }
        }

    // ---- dh = g . W2[:, chunk]
    float dh[2][2][4];
    mp::zero(dh);
#pragma unroll 1
    for (int j = 0; j < R::N1; ++j) {
      const uint32_t* slot = ring.next();
      const T* wt = reinterpret_cast<const T*>(slot + BM * R::NLD);
      float p[2][2][4];
      mp::zero(p);
#pragma unroll
      for (int ks = 0; ks < R::KW / 8; ++ks) {
        mp::mma_step<T>(
            p,
            [&](int mi, uint32_t (&f)[4]) {
              mp::load_a_nat(f, slot, R::NLD, wm * 32 + mi * 16, ks * 8);
            },
            [&](int ni, uint32_t (&f)[2]) {
              mp::load_b_tr(f, wt, WLD, wn * 16 + ni * 8, ks * 8 * R::EW);
            });
      }
      mp::add_to(dh, p);
    }

    // ---- da = dh * gelu'(a): rounded to T into the scratch; db1's partial
    // from the unrounded da, summed over the warp's 32 rows
    float csum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = chunk_row(mi, e), u = chunk_unit(ni, e);
          const float d0 = dh[mi][ni][e] * gg[mi][ni][e];
          const float d1 = dh[mi][ni][e + 1] * gg[mi][ni][e + 1];
          csum[ni][0] += d0;
          csum[ni][1] += d1;
          if (row0 + r < M) {
            mp::store2(da_out + static_cast<long long>(row0 + r) * H + hc + u, d0, d1);
          }
        }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float t = csum[ni][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (mp::lane_g() == 0) cs[wm * H + hc + chunk_unit(ni, e)] = t;
      }
  }
  mp::cp_async_wait<0>();
}

constexpr int WT = 128;  // weight-sum output tile edge
constexpr int WK = 64;   // rows of M per weight-sum stage
constexpr int WSTAGES = 3;  // depth of the weight sums' cp.async ring
constexpr int WLDT = WT + 8;  // its k-major stage tiles' row stride, elements

// Stage tile of one operand of the tile GEMM, in words: WK rows of k by
// WT (k-major) or WT rows by WK of k (k-contiguous), whichever is larger.
template <typename T>
__host__ __device__ constexpr int gemm_tile_words() {
  constexpr int ew = 4 / int(sizeof(T));
  return (WK * WLDT / ew > WT * (WK / ew + 4)) ? WK * WLDT / ew : WT * (WK / ew + 4);
}
template <typename T>
constexpr int gemm_smem_words() {
  return WSTAGES * 2 * gemm_tile_words<T>();
}

// Passes 2 and 3 of the backward: out[r][n] = sum over k of A(r, k) b[k][n]
// for one 128 x 128 tile (rows past R and columns past N masked), k over
// this block's slice [z * k_per_split, (z + 1) * k_per_split) of [0, K),
// written at out + z * split_stride. b is k-major (row pitch N). A is
// a[k][r] (k-major, row pitch R) for the weight sums, or a[r][k]
// (k-contiguous, row pitch K) when A_NAT, for dX.
template <typename T, bool A_NAT, typename OutT>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          OutT* __restrict__ out, int R, int N, int K,
                          int k_per_split, long long split_stride) {
  constexpr int EW = 4 / sizeof(T);
  constexpr int TILE = gemm_tile_words<T>();
  constexpr int CH = WT / EW / 4;       // 16-byte chunks of a k-major row
  constexpr int ALD = WK / EW + 4;      // k-contiguous A rows, words
  extern __shared__ __align__(16) uint32_t smem[];
  const int r0 = blockIdx.x * WT, n0 = blockIdx.y * WT;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int total = (k_end - k_begin + WK - 1) / WK;
  const int w = warp_id(), wm = w >> 2, wn = w & 3;

  auto ring = mp::start_ring<WSTAGES, 2 * TILE>(smem, [&](int s) {
    if (s < total) {
      uint32_t* slot = smem + (s % WSTAGES) * 2 * TILE;
      const int k0 = k_begin + s * WK;
      if constexpr (A_NAT) {  // WT rows of A, WK of k each
        constexpr int ACH = WK / EW / 4;
#pragma unroll
        for (int e = threadIdx.x; e < WT * ACH; e += THREADS) {
          const int r = e / ACH, c = e % ACH;
          const int k = k0 + c * 4 * EW;
          const bool ok = r0 + r < R && k < k_end;
          const T* p = a + (ok ? static_cast<long long>(r0 + r) * K + k : 0);
          mp::cp_async16(slot + r * ALD + 4 * c, p, ok);
        }
      } else {  // WK rows of k, WT of A's rows each
#pragma unroll
        for (int e = threadIdx.x; e < WK * CH; e += THREADS) {
          const int r = e / CH, c = e % CH, col = c * 4 * EW;
          const bool ok = k0 + r < k_end && r0 + col < R;
          const T* p = a + (ok ? static_cast<long long>(k0 + r) * R + r0 + col : 0);
          mp::cp_async16(slot + r * (WLDT / EW) + 4 * c, p, ok);
        }
      }
#pragma unroll
      for (int e = threadIdx.x; e < WK * CH; e += THREADS) {  // WK rows of b
        const int r = e / CH, c = e % CH, col = c * 4 * EW;
        const bool ok = k0 + r < k_end && n0 + col < N;
        const T* p = b + (ok ? static_cast<long long>(k0 + r) * N + n0 + col : 0);
        mp::cp_async16(slot + TILE + r * (WLDT / EW) + 4 * c, p, ok);
      }
    }
    mp::cp_async_commit();
  });

  float acc[4][4][4];
  mp::zero(acc);
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    const uint32_t* slot = ring.next();
    const T* as = reinterpret_cast<const T*>(slot);
    const T* bs = reinterpret_cast<const T*>(slot + TILE);
    float p[4][4][4];  // the stage's partial, added into acc in fp32
    mp::zero(p);
#pragma unroll
    for (int ks = 0; ks < WK / (8 * EW); ++ks) {
      mp::mma_step<T>(
          p,
          [&](int mi, uint32_t (&f)[4]) {
            if constexpr (A_NAT) {
              mp::load_a_nat(f, slot, ALD, wm * 64 + mi * 16, ks * 8);
            } else {
              mp::load_a_tr(f, as, WLDT, wm * 64 + mi * 16, ks * 8 * EW);
            }
          },
          [&](int ni, uint32_t (&f)[2]) {
            mp::load_b_tr(f, bs, WLDT, wn * 32 + ni * 8, ks * 8 * EW);
          });
    }
    mp::add_to(acc, p);
  }
  mp::cp_async_wait<0>();

  OutT* dst = out + blockIdx.z * split_stride;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = r0 + wm * 64 + mi * 16 + mp::lane_g() + (e >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * mp::lane_t();
        if (r < R && n < N) {
          mp::store2(dst + static_cast<long long>(r) * N + n, acc[mi][ni][e],
                     acc[mi][ni][e + 1]);
        }
      }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Pass 3: grads = [dW1 (H, C) | db1 (H) | dW2 (C, H) | db2 (C)]. A thread
// per dW element sums the S slices' partials in order; a warp per db
// element has lane l sum the column sums of row blocks l, l + 32, ... in
// order, then adds the lanes in a fixed tree. Deterministic either way.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_reduce_kernel(const float* __restrict__ part,
                            const float* __restrict__ colsum, T* __restrict__ out,
                            int S, int NB, int H, int C) {
  const long long hc = static_cast<long long>(H) * C;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < 2 * hc) {
    float t = 0.f;
    for (int s = 0; s < S; ++s) t += part[s * 2 * hc + i];
    store1(out + (i < hc ? i : i + H), t);
    return;
  }
  const int j = static_cast<int>((i - 2 * hc) / 32), lane = threadIdx.x & 31;
  if (j >= H + C) return;  // whole warps: 2 * hc is a multiple of 32
  const long long pitch = 2 * H + C;
  float t = 0.f;
  for (int blk = lane; blk < NB; blk += 32) {
    const float* cs = colsum + blk * pitch;
    if (j < H) {
      t += cs[j];
      t += cs[H + j];
    } else {
      t += cs[H + j];  // db2's column j - H sits at 2 * H + (j - H)
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0) store1(out + (j < H ? hc + j : 2 * hc + j), t);
}

// ---- K5 on wgmma: fp32 at C = 512 (see the note at the top) ---------------

namespace wg {

constexpr int C = 512;
constexpr int BM = 64;          // rows per tile
constexpr int PAIR = 128;       // hidden units per pair: 64 per consumer warpgroup
using mp::wg::KB;               // k (or hidden units) per stage: one 128-byte row
using mp::wg::THREADS;          // a producer and two consumer warpgroups
constexpr int WS = 4;           // W ring slots per consumer warpgroup
constexpr int XS = 4;           // x ring slots
constexpr int BOX = 8192;       // bytes of one 64 x 32 fp32 TMA box
constexpr int W_SLOT = 2 * BOX;  // a W box pair: big and small parts
constexpr int GELU_PLANE = BM * PAIR * 4;  // 32 KB: the pair's chunk, one part
constexpr int OFF_W = 0;
constexpr int OFF_X = OFF_W + 2 * WS * W_SLOT;
constexpr int OFF_GELU = OFF_X + XS * BOX;
constexpr int OFF_BAR = OFF_GELU + 2 * GELU_PLANE;
constexpr int NBAR = 4 * WS + 2 * XS;
constexpr int SMEM = OFF_BAR + 8 * NBAR + 1024;  // + the base's alignment to 1 KB
static_assert(SMEM <= 232448, "shared memory");

using namespace mp::wg;

// k-step s of a stage's 3xTF32 products into d, small parts first: B a W
// box pair (swizzled, a k-step 32 bytes along its rows), A's fragment
// ``a``; the first of a stage starts the accumulator afresh.
__device__ __forceinline__ void products(float (&d)[32], const Frag& a, uint32_t b_big,
                                         int s) {
  const uint64_t bb = desc_swizzled(b_big + 32 * s);
  mma(d, a.small, bb, s == 0 ? 0 : 1);
  mma(d, a.big, desc_swizzled(b_big + BOX + 32 * s), 1);
  mma(d, a.big, bb, 1);
}

// One stage, 4 k-steps of 8, into the fresh accumulator d, A's fragments
// from ``load(s, frag)``, two in flight at a time. Returns with the
// products done.
template <typename Load>
__device__ __forceinline__ void stage(float (&d)[32], uint32_t b_big, Load load) {
  Frag f[2];
#pragma unroll
  for (int s = 0; s < KB / 8; ++s) {
    Frag& a = f[s & 1];
    if (s >= 2) mma_wait<1>();  // the products of k-step s - 2 read a
    load(s, a);
    pin(a.big);
    pin(a.small);
    mma_fence();
    products(d, a, b_big, s);
    mma_commit();
  }
  mma_wait<0>();
  pin(d);
}

// The same with all 4 k-steps of A in registers already.
__device__ __forceinline__ void stage(float (&d)[32], uint32_t b_big, Frag (&a)[KB / 8]) {
#pragma unroll
  for (int s = 0; s < KB / 8; ++s) {
    pin(a[s].big);
    pin(a[s].small);
  }
  mma_fence();
#pragma unroll
  for (int s = 0; s < KB / 8; ++s) products(d, a[s], b_big, s);
  mma_commit();
  mma_wait<0>();
  pin(d);
}

// The producer: lane 0 of warp 0 loads x, lane 0 of warp 1 + c the
// weights' planes of consumer warpgroup c, each into its own ring, in the
// order the consumers read them. x and the planes stay in L2 between
// the row tiles.
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* w_full, uint64_t* w_empty,
                                        uint64_t* x_full, uint64_t* x_empty,
                                        const CUtensorMap* tx, const CUtensorMap* tw1,
                                        const CUtensorMap* tw2, int tiles, int H) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || warp > 2) return;
  Ring r;
  if (warp == 0) {
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      for (int n = 0; n < (H / PAIR) * (C / KB); ++n) {
        bar_wait(&x_empty[r.i], r.phase ^ 1);
        bar_expect(&x_full[r.i], BOX);
        tma_load(smem + OFF_X + r.i * BOX, tx, (n % (C / KB)) * KB, tile * BM, &x_full[r.i]);
        r.next(XS);
      }
    return;
  }
  const int c = warp - 1;
  auto load = [&](const CUtensorMap* map, int k0, int row0, int plane_rows) {
    bar_wait(&w_empty[c * WS + r.i], r.phase ^ 1);
    uint64_t* full = &w_full[c * WS + r.i];
    uint8_t* slot = smem + OFF_W + (c * WS + r.i) * W_SLOT;
    bar_expect(full, W_SLOT);
    tma_load(slot, map, k0, row0, full);
    tma_load(slot + BOX, map, k0, plane_rows + row0, full);
    r.next(WS);
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int hp = 0; hp < H; hp += PAIR) {
      for (int k0 = 0; k0 < C; k0 += KB) load(tw1, k0, hp + 64 * c, H);
      for (int h0 = hp; h0 < hp + PAIR; h0 += KB)
        for (int j = 0; j < 4; ++j) load(tw2, h0, 256 * c + 64 * j, C);
    }
  }
}

// Consumer warpgroup c (0, 1): fc1 of hidden units hp + 64c.. of each
// pair, and fc2 into output columns 256c.. over the whole pair. Each
// stage's products go into a fresh wgmma accumulator that is then added
// into an fp32 sum: the accumulation truncates, so one accumulator covers
// 32 of k (probes/accumulate.cu).
__device__ __forceinline__ void consume(int c, uint8_t* smem, uint64_t* w_full,
                                        uint64_t* w_empty, uint64_t* x_full,
                                        uint64_t* x_empty, const float* __restrict__ b1,
                                        const float* __restrict__ b2,
                                        float* __restrict__ out, int tiles, int M, int H) {
  const int lt = threadIdx.x - 128 * (c + 1);
  const int wi = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wi + g;  // this thread's fragment rows: r0, r0 + 8
  const uint32_t base = sa(smem);
  uint8_t* gelu = smem + OFF_GELU;
  uint64_t* my_full = w_full + c * WS;
  uint64_t* my_empty = w_empty + c * WS;
  auto w_slot = [&](int i) { return base + OFF_W + (c * WS + i) * W_SLOT; };
  auto release = [&](uint64_t* empty) {
    if (lane == 0) bar_arrive(empty);
  };
  Ring xr, wr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float o[4][32];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    for (int hp = 0; hp < H; hp += PAIR) {
      // ---- fc1: s1 = x . W1[hp + 64c ..]^T. x's fragments come from the
      // TMA box (row r at 128 r bytes, 16-byte chunk q at q ^ (r % 8)) and
      // are split here; 8 rows of one chunk hit every bank once.
      float s1[32], d[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s1[e] = d[e] = 0.f;
#pragma unroll 1
      for (int kb = 0; kb < C / KB; ++kb) {
        bar_wait(&x_full[xr.i], xr.phase);
        bar_wait(&my_full[wr.i], wr.phase);
        const uint8_t* xs = smem + OFF_X + xr.i * BOX + r0 * 128 + 4 * t;
        stage(d, w_slot(wr.i), [&](int s, Frag& a) {
          const uint32_t w[4] = {
              *reinterpret_cast<const uint32_t*>(xs + (((2 * s) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + 1024 + (((2 * s) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + (((2 * s + 1) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + 1024 + (((2 * s + 1) ^ g) << 4))};
          uint32_t p[2][4];
          mp::Mma<float>::split(w, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a.big[e] = p[0][e];
            a.small[e] = p[1][e];
          }
        });
        release(&x_empty[xr.i]);
        release(&my_empty[wr.i]);
#pragma unroll
        for (int e = 0; e < 32; ++e) s1[e] += d[e];
        xr.next(XS);
        wr.next(WS);
      }
      // ---- bias and exact GELU, split into the two parts fc2 reads, once
      // the other warpgroup is done with the previous pair's chunk. Hidden
      // unit 8j + 2t + e of this warpgroup's 64 goes to k-step 8c + j, slot
      // t + 4e (W2's planes hold the same order). A plane's k-step is 2 KB:
      // slots 0-3 and 4-7 of rows 8i.. 8i + 7 at 1024 (slot / 4) + 128 i.
      bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(b1 + hp + 64 * c + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const uint32_t w[2] = {
              __float_as_uint(gelu_exact(s1[4 * j + 2 * h] + bias.x)),
              __float_as_uint(gelu_exact(s1[4 * j + 2 * h + 1] + bias.y))};
          uint32_t p[2][2];
          mp::Mma<float>::split(w, p);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int off = (8 * c + j) * 2048 + e * 1024 + (r >> 3) * 128 + (r & 7) * 16 + t * 4;
            *reinterpret_cast<uint32_t*>(gelu + off) = p[0][e];
            *reinterpret_cast<uint32_t*>(gelu + GELU_PLANE + off) = p[1][e];
          }
        }
      }
      bar_sync(2, 256);
      // ---- fc2: o[j] += gelu . W2[256c + 64j .., pair]^T, a stage of 32
      // units at a time, its fragments loaded once for the four j
      const uint8_t* ga = gelu + (wi * 2) * 128 + g * 16 + t * 4;  // rows r0, r0 + 8
#pragma unroll 1
      for (int hb = 0; hb < PAIR / KB; ++hb) {
        Frag a[KB / 8];
#pragma unroll
        for (int s = 0; s < KB / 8; ++s)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t(&dst)[4] = q ? a[s].small : a[s].big;
            const uint8_t* pl = ga + (4 * hb + s) * 2048 + q * GELU_PLANE;
            dst[0] = *reinterpret_cast<const uint32_t*>(pl);
            dst[1] = *reinterpret_cast<const uint32_t*>(pl + 128);
            dst[2] = *reinterpret_cast<const uint32_t*>(pl + 1024);
            dst[3] = *reinterpret_cast<const uint32_t*>(pl + 1024 + 128);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bar_wait(&my_full[wr.i], wr.phase);
          stage(d, w_slot(wr.i), a);
          release(&my_empty[wr.i]);
#pragma unroll
          for (int e = 0; e < 32; ++e) o[j][e] += d[e];
          wr.next(WS);
        }
      }
    }
    // ---- + b2, rows < M to out
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 256 * c + 64 * j + 8 * n + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tile * BM + r0 + 8 * h;
          if (r < M) {
            mp::store2(out + static_cast<long long>(r) * C + col,
                       o[j][4 * n + 2 * h] + bias.x, o[j][4 * n + 2 * h + 1] + bias.y);
          }
        }
      }
  }
}

}  // namespace wg

__global__ void __launch_bounds__(wg::THREADS, 1)
fused_mlp_kernel_sm90(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, const float* __restrict__ b1,
                      const float* __restrict__ b2, float* __restrict__ out, int M, int H) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::sa(smem_raw) & 1023)) & 1023);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + wg::OFF_BAR);
  uint64_t* w_empty = w_full + 2 * wg::WS;
  uint64_t* x_full = w_empty + 2 * wg::WS;
  uint64_t* x_empty = x_full + wg::XS;
  const int tiles = (M + wg::BM - 1) / wg::BM;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * wg::WS; ++i) {
      wg::bar_init(&w_full[i], 1);
      wg::bar_init(&w_empty[i], 4);  // lane 0 of each of the consumer's warps
    }
    for (int i = 0; i < wg::XS; ++i) {
      wg::bar_init(&x_full[i], 1);
      wg::bar_init(&x_empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    wg::produce(smem, w_full, w_empty, x_full, x_empty, &tx, &tw1, &tw2, tiles, H);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    wg::consume(threadIdx.x < 256 ? 0 : 1, smem, w_full, w_empty, x_full, x_empty, b1, b2,
                out, tiles, M, H);
  }
}

// W1 (H, C) and W2 (C, H) split into big and small tf32 planes: w1p (2H, C)
// holds W1's big parts in rows 0..H-1 and its small parts below them; w2p
// (2C, H) likewise W2's, with the hidden units of each group of 8 in the
// order the consumers store the GELU chunk: slot t + 4e holds unit 2t + e.
__global__ void __launch_bounds__(256)
fused_mlp_kernel_split(const float* __restrict__ w1, const float* __restrict__ w2,
                       float* __restrict__ w1p, float* __restrict__ w2p, int H) {
  constexpr int C = wg::C;
  const long long n8 = static_cast<long long>(H) * C / 8;  // groups of 8 per matrix
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < 2 * n8;
       i += static_cast<long long>(gridDim.x) * 256) {
    const bool second = i >= n8;
    const long long at = 8 * (second ? i - n8 : i);
    const float* src = (second ? w2 : w1) + at;
    float* dst = (second ? w2p : w1p) + at;
    const uint4 lo = *reinterpret_cast<const uint4*>(src);
    const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t in[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) in[e] = second ? w[2 * (e & 3) + (e >> 2)] : w[e];
    uint32_t p[2][8];
    mp::Mma<float>::split(in, p);
    const long long plane = static_cast<long long>(H) * C;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      *reinterpret_cast<uint4*>(dst + q * plane) = make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
      *reinterpret_cast<uint4*>(dst + q * plane + 4) =
          make_uint4(p[q][4], p[q][5], p[q][6], p[q][7]);
    }
  }
}

// ---- K6 on wgmma: fp32 at C = 512 (see the note at the top) ---------------

namespace wg6 {

using namespace mp::wg;
using wg::BOX;
using wg::C;
using wg::Frag;
using wg::KB;
using wg::PAIR;
using wg::Ring;
using wg::THREADS;
using wg::W_SLOT;

// Pass 1 (rows) takes 128-row tiles, two 64-row halves sharing each weight
// box: x's and g's boxes (128 rows x 32 k) in one ring, the weights' planes
// in a ring a consumer warpgroup, as K5's.
constexpr int BM = 128;
constexpr int X_BOX = 2 * BOX;
constexpr int WS = 4;
constexpr int XS = 4;
constexpr int R_OFF_X = 2 * WS * W_SLOT;
constexpr int R_OFF_BAR = R_OFF_X + XS * X_BOX;
constexpr int R_SMEM = R_OFF_BAR + 8 * (4 * WS + 2 * XS) + 1024;
static_assert(R_SMEM <= 232448, "shared memory");

// The producer of pass 1: lane 0 of warp 0 loads x's 16 boxes, then g's,
// for each pair of 64-unit chunks of each row tile; lane 0 of warp 1 + c
// the planes of W1's and then W2^T's rows for consumer c's chunk. Warp 3
// writes db2's partial of each row tile: g's column sums over its rows,
// each in row order.
__device__ __forceinline__ void rows_produce(uint8_t* smem, uint64_t* w_full, uint64_t* w_empty,
                                             uint64_t* x_full, uint64_t* x_empty,
                                             const CUtensorMap* tx, const CUtensorMap* tg,
                                             const CUtensorMap* tw1, const CUtensorMap* tw2t,
                                             const float* __restrict__ g,
                                             float* __restrict__ colsum, int tiles, int M,
                                             int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 3) {
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int rows = min(BM, M - tile * BM);
      const float* gt = g + static_cast<long long>(tile) * BM * C + lane;
      float* cs = colsum + static_cast<long long>(tile) * (4 * H + C) + 4 * H + lane;
#pragma unroll 1
      for (int q = 0; q < C / 128; ++q) {  // 4 columns a lane at a time
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int r = 0; r < rows; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e] += gt[r * C + 128 * q + 32 * e];
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[128 * q + 32 * e] = sum[e];
      }
    }
    return;
  }
  if (lane != 0) return;
  Ring r;
  if (warp == 0) {
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      for (int hp = 0; hp < H; hp += PAIR)
        for (int n = 0; n < 2 * (C / KB); ++n) {
          bar_wait(&x_empty[r.i], r.phase ^ 1);
          bar_expect(&x_full[r.i], X_BOX);
          tma_load(smem + R_OFF_X + r.i * X_BOX, n < C / KB ? tx : tg, (n % (C / KB)) * KB,
                   tile * BM, &x_full[r.i]);
          r.next(XS);
        }
    return;
  }
  const int c = warp - 1;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int hp = 0; hp < H; hp += PAIR)
      for (int n = 0; n < 2 * (C / KB); ++n) {
        bar_wait(&w_empty[c * WS + r.i], r.phase ^ 1);
        uint64_t* full = &w_full[c * WS + r.i];
        uint8_t* slot = smem + (c * WS + r.i) * W_SLOT;
        const CUtensorMap* map = n < C / KB ? tw1 : tw2t;
        const int k0 = (n % (C / KB)) * KB, row0 = hp + 64 * c;
        bar_expect(full, W_SLOT);
        tma_load(slot, map, k0, row0, full);
        tma_load(slot + BOX, map, k0, H + row0, full);
        r.next(WS);
      }
}

// Consumer warpgroup c (0, 1) of pass 1: for hidden units u0 = hp + 64c..
// of each pair and both halves of the row tile, s1 = x W1[u0..]^T (a - b1)
// and dh = g W2[:, u0..], each over C in 16 stages of 32 whose products go
// into a fresh accumulator that is then added into the fp32 sum; then
// gelu(a) and da = dh * gelu'(a), split into tf32 planes, to the (H, Mp)
// planes k-major for pass 2, and db1's partial from the unrounded da.
__device__ __forceinline__ void rows_consume(int c, uint8_t* smem, uint64_t* w_full,
                                             uint64_t* w_empty, uint64_t* x_full,
                                             uint64_t* x_empty, const float* __restrict__ b1,
                                             float* __restrict__ planes,
                                             float* __restrict__ colsum, int tiles, int M,
                                             int Mp, int H) {
  const int lt = threadIdx.x - 128 * (c + 1);
  const int wi = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wi + g;  // this thread's fragment rows: r0, r0 + 8 of each half
  const uint32_t base = sa(smem);
  uint64_t* my_full = w_full + c * WS;
  uint64_t* my_empty = w_empty + c * WS;
  const long long plane = static_cast<long long>(H) * Mp;
  Ring xr, wr;
  // sum[half] += the next 16 stages' products: A from the x (or g) box's
  // half, split here as K5's fc1 splits x; B the consumer's W box pair
  auto product = [&](float (&sum)[2][32]) {
    float d[32];
#pragma unroll 1
    for (int kb = 0; kb < C / KB; ++kb) {
      bar_wait(&x_full[xr.i], xr.phase);
      bar_wait(&my_full[wr.i], wr.phase);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint8_t* xs = smem + R_OFF_X + xr.i * X_BOX + half * BOX + r0 * 128 + 4 * t;
        wg::stage(d, base + (c * WS + wr.i) * W_SLOT, [&](int s, Frag& a) {
          const uint32_t w[4] = {
              *reinterpret_cast<const uint32_t*>(xs + (((2 * s) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + 1024 + (((2 * s) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + (((2 * s + 1) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(xs + 1024 + (((2 * s + 1) ^ g) << 4))};
          uint32_t p[2][4];
          mp::Mma<float>::split(w, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a.big[e] = p[0][e];
            a.small[e] = p[1][e];
          }
        });
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[half][e] += d[e];
      }
      if (lane == 0) {
        bar_arrive(&x_empty[xr.i]);
        bar_arrive(&my_empty[wr.i]);
      }
      xr.next(XS);
      wr.next(WS);
    }
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float* cs = colsum + static_cast<long long>(tile) * (4 * H + C);
    for (int hp = 0; hp < H; hp += PAIR) {
      float s1[2][32], dh[2][32];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 32; ++e) s1[half][e] = dh[half][e] = 0.f;
      product(s1);
      product(dh);
      // unit u0 + 8j + 2t + e, row 64 half + r0 + 8h: s1[half][4j + 2h + e].
      // Rows past M read zeros of x and g: their da is 0, and gelu(a) is
      // written 0.
      const int u0 = hp + 64 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(b1 + u0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0 + 8 * j + 2 * t + e;
          float csum = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = tile * BM + 64 * half + r0 + 8 * h;
              const float a = s1[half][4 * j + 2 * h + e] + (e ? bias.y : bias.x);
              // one erf for both: a * cdf is gelu_exact(a) bit for bit (the
              // halving is exact)
              const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
              const float da = dh[half][4 * j + 2 * h + e] *
                               (cdf + a * 0.3989422804014327f * expf(-0.5f * a * a));
              csum += da;
              const uint32_t w[2] = {__float_as_uint(da),
                                     __float_as_uint(row < M ? a * cdf : 0.f)};
              uint32_t p[2][2];
              mp::Mma<float>::split(w, p);
              float* at = planes + static_cast<long long>(u) * Mp + row;
              at[0] = __uint_as_float(p[0][0]);
              at[plane] = __uint_as_float(p[1][0]);
              at[2 * plane] = __uint_as_float(p[0][1]);
              at[3 * plane] = __uint_as_float(p[1][1]);
            }
          // db1's partial of the warp's 32 rows
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) csum += __shfl_xor_sync(0xffffffffu, csum, o);
          if (g == 0) cs[wi * H + u] = csum;
        }
      }
    }
  }
}

}  // namespace wg6

__global__ void __launch_bounds__(wg6::THREADS, 1)
fused_mlp_bwd_rows_kernel_sm90(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tg,
                               const __grid_constant__ CUtensorMap tw1,
                               const __grid_constant__ CUtensorMap tw2t,
                               const float* __restrict__ g, const float* __restrict__ b1,
                               float* __restrict__ planes, float* __restrict__ colsum, int M,
                               int Mp, int H) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wg::sa(smem_raw) & 1023)) & 1023);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + wg6::R_OFF_BAR);
  uint64_t* w_empty = w_full + 2 * wg6::WS;
  uint64_t* x_full = w_empty + 2 * wg6::WS;
  uint64_t* x_empty = x_full + wg6::XS;
  const int tiles = Mp / wg6::BM;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * wg6::WS; ++i) {
      wg::bar_init(&w_full[i], 1);
      wg::bar_init(&w_empty[i], 4);  // lane 0 of each of the consumer's warps
    }
    for (int i = 0; i < wg6::XS; ++i) {
      wg::bar_init(&x_full[i], 1);
      wg::bar_init(&x_empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    wg6::rows_produce(smem, w_full, w_empty, x_full, x_empty, &tx, &tg, &tw1, &tw2t, g,
                      colsum, tiles, M, H);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    wg6::rows_consume(threadIdx.x < 256 ? 0 : 1, smem, w_full, w_empty, x_full, x_empty, b1,
                      planes, colsum, tiles, M, Mp, H);
  }
}

// dX = da W1: rows of M (256 a tile; the four column tiles of a row tile
// one after another, sharing its da), k over H. A: da^T's planes (2H, Mp);
// B: W1^T's (2C, H).
__global__ void __launch_bounds__(wg6::THREADS, 1)
fused_mlp_bwd_gemm_kernel_dx(const __grid_constant__ CUtensorMap tda,
                             const __grid_constant__ CUtensorMap tw1t, float* __restrict__ dx,
                             int M, int H) {
  constexpr int C = wg6::C, NT = C / 128, TR = mp::wg::TILE_ROWS;
  const int items = (M + TR - 1) / TR * NT;
  mp::wg::gemm<mp::wg::A_PLANES>(
      items,
      [&](int i) {
        return mp::wg::Work{&tda, &tw1t, TR * (i / NT), H, 128 * (i % NT), C, 0, H};
      },
      [&](int i, const float(&sum)[64], int row0, int row1) {
        const int t = threadIdx.x & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = TR * (i / NT) + (h ? row1 : row0);
          if (row >= M) continue;
          float* out = dx + static_cast<long long>(row) * C + 128 * (i % NT) + 2 * t;
#pragma unroll
          for (int j = 0; j < 16; ++j) mp::store2(out + 8 * j, sum[4 * j + 2 * h],
                                                   sum[4 * j + 2 * h + 1]);
        }
      });
}

// The weight sums' partials over S slices of M (kps rows each, the last
// shorter): dW1^T = x^T da and dW2 = g^T gelu(a), (C, H) each, k over the
// slice. A: x or g (M, C) raw; B: da^T's or gelu(a)^T's planes (2H, Mp).
// Item i: dW1 for i < S * per, else dW2; then the slice, then the 256 x
// 128 tile, so the items running together share their rows of M.
// part[z] holds dW1 (H, C) (stored transposed), then dW2 (C, H).
__global__ void __launch_bounds__(wg6::THREADS, 1)
fused_mlp_bwd_gemm_kernel_dw(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tg,
                             const __grid_constant__ CUtensorMap tda,
                             const __grid_constant__ CUtensorMap th, float* __restrict__ part,
                             int Mp, int H, int S, int kps) {
  constexpr int C = wg6::C, TR = mp::wg::TILE_ROWS;
  const int hn = H / 128, per = (C / TR) * hn;
  const long long hc = static_cast<long long>(H) * C;
  mp::wg::gemm<mp::wg::A_RAW>(
      2 * S * per,
      [&](int i) {
        const bool second = i >= S * per;
        const int z = (i / per) % S, tile = i % per;
        return mp::wg::Work{second ? &tg : &tx, second ? &th : &tda, TR * (tile / hn), 0,
                         128 * (tile % hn), H, z * kps, min(Mp, (z + 1) * kps)};
      },
      [&](int i, const float(&sum)[64], int row0, int row1) {
        const bool second = i >= S * per;
        const int z = (i / per) % S, tile = i % per, t = threadIdx.x & 3;
        float* p = part + z * 2 * hc;
        const int n0 = 128 * (tile % hn) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = TR * (tile / hn) + (h ? row1 : row0);  // a channel of C
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = n0 + 8 * j;  // a hidden unit
            if (second) {
              mp::store2(p + hc + static_cast<long long>(row) * H + n, sum[4 * j + 2 * h],
                         sum[4 * j + 2 * h + 1]);
            } else {
              p[static_cast<long long>(n) * C + row] = sum[4 * j + 2 * h];
              p[static_cast<long long>(n + 1) * C + row] = sum[4 * j + 2 * h + 1];
            }
          }
        }
      });
}

// W1 (H, C) and W2 (C, H) split into big and small tf32 planes for K6's
// wgmma path, into wp: W1 (2H, C) as it lies, W2^T (2H, C), W1^T (2C, H),
// one of the three per blockIdx.y, through 32 x 32 tiles in shared memory.
__global__ void __launch_bounds__(256)
fused_mlp_bwd_rows_kernel_split(const float* __restrict__ w1, const float* __restrict__ w2,
                                float* __restrict__ wp, int H) {
  constexpr int C = wg::C;
  __shared__ float tile[32][33];
  const int which = blockIdx.y;
  const int rows = which == 1 ? C : H, cols = which == 1 ? H : C;
  const float* src = which == 1 ? w2 : w1;
  const long long plane = static_cast<long long>(H) * C;
  float* dst = wp + which * 2 * plane;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n = (rows / 32) * (cols / 32);
  for (int tl = blockIdx.x; tl < n; tl += gridDim.x) {
    const int r0 = (tl / (cols / 32)) * 32, c0 = (tl % (cols / 32)) * 32;
    __syncthreads();  // the previous tile's reads are done
    for (int i = ty; i < 32; i += 8) {
      tile[i][tx] = src[static_cast<long long>(r0 + i) * cols + c0 + tx];
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const float v = which == 0 ? tile[i][tx] : tile[tx][i];
      const long long at = which == 0 ? static_cast<long long>(r0 + i) * cols + c0 + tx
                                      : static_cast<long long>(c0 + i) * rows + r0 + tx;
      const uint32_t w[1] = {__float_as_uint(v)};
      uint32_t p[2][1];
      mp::Mma<float>::split(w, p);
      dst[at] = __uint_as_float(p[0][0]);
      dst[plane + at] = __uint_as_float(p[1][0]);
    }
  }
}

// Pass 3 of K6's wgmma path: grads = [dW1 (H, C) | db1 (H) | dW2 (C, H) |
// db2 (C)]. The first 2 H C / 256 blocks: a thread per dW element sums the
// S slices' partials in order. The others: 16 columns of db a block, thread
// (q, j) summing the column sums of row tiles q, q + 16, ... in order (db1:
// the four warps' partials of a tile), then thread j the 16 sums in order.
__global__ void __launch_bounds__(256)
fused_mlp_bwd_reduce_kernel_sm90(const float* __restrict__ part,
                                 const float* __restrict__ colsum, float* __restrict__ out,
                                 int S, int NB, int H) {
  constexpr int C = wg::C;
  const long long hc = static_cast<long long>(H) * C;
  const int dw_blocks = static_cast<int>(2 * hc / 256);
  if (static_cast<int>(blockIdx.x) < dw_blocks) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    float t = 0.f;
    for (int s = 0; s < S; ++s) t += part[s * 2 * hc + i];
    out[i < hc ? i : i + H] = t;
    return;
  }
  __shared__ float sums[16][17];
  const int q = threadIdx.x >> 4, jj = threadIdx.x & 15;
  const int j = (blockIdx.x - dw_blocks) * 16 + jj;  // H + C is a multiple of 16
  const long long pitch = 4 * H + C;
  float t = 0.f;
  for (int blk = q; blk < NB; blk += 16) {
    const float* cs = colsum + blk * pitch;
    if (j < H) {
#pragma unroll
      for (int w = 0; w < 4; ++w) t += cs[w * H + j];
    } else {
      t += cs[3 * H + j];  // db2's column j - H sits at 4 * H + (j - H)
    }
  }
  sums[q][jj] = t;
  __syncthreads();
  if (q == 0) {
    float u = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) u += sums[r][jj];
    out[j < H ? hc + j : 2 * hc + j] = u;
  }
}

using mp::encode_map;
using mp::sm_count;

cudaError_t launch_sm90(const float* x, const float* w1, const float* b1, const float* w2,
                        const float* b2, float* out, float* w1p, float* w2p, int M, int H,
                        int device, cudaStream_t stream) {
  int n_sm;
  if (cudaError_t err = sm_count(device, &n_sm); err != cudaSuccess) return err;
  CUtensorMap tx, tw1, tw2;
  if (!encode_map(&tx, x, M, wg::C) || !encode_map(&tw1, w1p, 2 * H, wg::C) ||
      !encode_map(&tw2, w2p, 2 * wg::C, H)) {
    return cudaErrorNotSupported;
  }
  fused_mlp_kernel_split<<<2 * n_sm, 256, 0, stream>>>(w1, w2, w1p, w2p, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = mp::allow_smem(fused_mlp_kernel_sm90, wg::SMEM)) != cudaSuccess) return err;
  const int tiles = (M + wg::BM - 1) / wg::BM;
  fused_mlp_kernel_sm90<<<tiles < n_sm ? tiles : n_sm, wg::THREADS, wg::SMEM, stream>>>(
      tx, tw1, tw2, b1, b2, out, M, H);
  return cudaGetLastError();
}

// K6 on wgmma: the weights' planes, pass 1 (rows), dX, the weight sums'
// partials over S slices of M, and their reduction.
cudaError_t launch_bwd_sm90(const float* x, const float* g, const float* w1, const float* b1,
                            const float* w2, float* dx, float* planes, float* wp,
                            float* colsum, float* part, float* grads, int M, int H, int S,
                            int device, cudaStream_t stream) {
  constexpr int C = wg::C;
  int n_sm;
  if (cudaError_t err = sm_count(device, &n_sm); err != cudaSuccess) return err;
  const int tiles = (M + wg6::BM - 1) / wg6::BM, Mp = tiles * wg6::BM;
  const long long hc = static_cast<long long>(H) * C;
  float* da_planes = planes;
  float* h_planes = planes + 2LL * H * Mp;
  CUtensorMap tx, tg, tw1, tw2t, tda_a, tw1t, tx_a, tg_a, tda_b, th_b;
  if (!encode_map(&tx, x, M, C, wg6::BM) || !encode_map(&tg, g, M, C, wg6::BM) ||
      !encode_map(&tw1, wp, 2 * H, C) || !encode_map(&tw2t, wp + 2 * hc, 2 * H, C) ||
      !encode_map(&tda_a, da_planes, 2 * H, Mp, 32) ||
      !encode_map(&tw1t, wp + 4 * hc, 2 * C, H, 128) || !encode_map(&tx_a, x, M, C, 32) ||
      !encode_map(&tg_a, g, M, C, 32) || !encode_map(&tda_b, da_planes, 2 * H, Mp, 128) ||
      !encode_map(&th_b, h_planes, 2 * H, Mp, 128)) {
    return cudaErrorNotSupported;
  }
  using DX = mp::wg::Gemm<mp::wg::A_PLANES>;
  using DW = mp::wg::Gemm<mp::wg::A_RAW>;
  cudaError_t err;
  if ((err = mp::allow_smem(fused_mlp_bwd_rows_kernel_sm90, wg6::R_SMEM)) != cudaSuccess ||
      (err = mp::allow_smem(fused_mlp_bwd_gemm_kernel_dx, DX::SMEM)) != cudaSuccess ||
      (err = mp::allow_smem(fused_mlp_bwd_gemm_kernel_dw, DW::SMEM)) != cudaSuccess) {
    return err;
  }
  fused_mlp_bwd_rows_kernel_split<<<dim3(2 * n_sm, 3), 256, 0, stream>>>(w1, w2, wp, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_rows_kernel_sm90<<<std::min(tiles, n_sm), wg6::THREADS, wg6::R_SMEM, stream>>>(
      tx, tg, tw1, tw2t, g, b1, planes, colsum, M, Mp, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int TR = mp::wg::TILE_ROWS;
  const int dx_items = (M + TR - 1) / TR * (C / 128);
  fused_mlp_bwd_gemm_kernel_dx<<<std::min(dx_items, n_sm), wg6::THREADS, DX::SMEM, stream>>>(
      tda_a, tw1t, dx, M, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dw_items = 2 * S * (C / TR) * (H / 128);
  const int kps = ((Mp + S - 1) / S + wg::KB - 1) / wg::KB * wg::KB;
  fused_mlp_bwd_gemm_kernel_dw<<<std::min(dw_items, n_sm), wg6::THREADS, DW::SMEM, stream>>>(
      tx_a, tg_a, tda_b, th_b, part, Mp, H, S, kps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_reduce_kernel_sm90<<<static_cast<unsigned>(2 * hc / 256 + (H + C) / 16), 256, 0,
                                     stream>>>(part, colsum, grads, S, tiles, H);
  return cudaGetLastError();
}

using mp::allow_smem;

template <typename T, int NJ>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int H,
                   cudaStream_t stream) {
  const size_t smem = 4 * rows_smem_words<T, 64 * NJ>();
  cudaError_t err = allow_smem(fused_mlp_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM;
  fused_mlp_kernel<T, NJ><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), M, H);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_bwd(const void* x, const void* g, const void* w1,
                       const void* b1, const void* w2, void* dx, void* da,
                       void* h, float* colsum, float* part, void* grads, int M,
                       int H, int S, cudaStream_t stream) {
  constexpr int C = 64 * NJ;
  const size_t smem = 4 * BWD_STAGES * BWD_SLOT;
  cudaError_t err = allow_smem(fused_mlp_bwd_rows_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return err;
  const size_t gsmem = 4 * gemm_smem_words<T>();
  if ((err = allow_smem(fused_mlp_bwd_gemm_kernel<T, true, T>, gsmem)) != cudaSuccess ||
      (err = allow_smem(fused_mlp_bwd_gemm_kernel<T, false, float>, gsmem)) != cudaSuccess) {
    return err;
  }
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* w1t = static_cast<const T*>(w1);
  T* dat = static_cast<T*>(da);
  T* ht = static_cast<T*>(h);
  const int nb = (M + BM - 1) / BM;
  fused_mlp_bwd_rows_kernel<T, NJ><<<nb, THREADS, smem, stream>>>(
      xt, gt, w1t, static_cast<const T*>(b1), static_cast<const T*>(w2), dat, ht,
      colsum, M, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dX = da W1, over all of H
  const int tm = (M + WT - 1) / WT, th = (H + WT - 1) / WT, tc = (C + WT - 1) / WT;
  fused_mlp_bwd_gemm_kernel<T, true, T><<<dim3(tm, tc, 1), THREADS, gsmem, stream>>>(
      dat, w1t, static_cast<T*>(dx), M, C, H, H, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // partials per split of M: dW1 = da^T x (H, C), then dW2 = g^T gelu(a) (C, H)
  const long long hc = static_cast<long long>(H) * C;
  const int rows_per_split = (M + S - 1) / S;
  fused_mlp_bwd_gemm_kernel<T, false, float><<<dim3(th, tc, S), THREADS, gsmem, stream>>>(
      dat, xt, part, H, C, M, rows_per_split, 2 * hc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_gemm_kernel<T, false, float><<<dim3(tc, th, S), THREADS, gsmem, stream>>>(
      gt, ht, part + hc, C, H, M, rows_per_split, 2 * hc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = 2 * hc + 32LL * (H + C);  // threads of the reduce
  fused_mlp_bwd_reduce_kernel<T><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                                   THREADS, 0, stream>>>(part, colsum,
                                                         static_cast<T*>(grads),
                                                         S, nb, H, C);
  return cudaGetLastError();
}

// Calls f(T{}, std::integral_constant<int, C / 64>{}) for the element type
// and channel count of a launch, with ``device`` current.
template <typename F>
cudaError_t with_types(int dtype, int C, int device, F f) {
  return mp::on_device(device, [&]() -> cudaError_t {
    auto by_c = [&](auto tag) -> cudaError_t {
      switch (C) {
        case 64: return f(tag, std::integral_constant<int, 1>{});
        case 128: return f(tag, std::integral_constant<int, 2>{});
        case 256: return f(tag, std::integral_constant<int, 4>{});
        case 512: return f(tag, std::integral_constant<int, 8>{});
        default: return cudaErrorInvalidValue;
      }
    };
    if (dtype == mp::kF32) return by_c(float{});
    if (dtype == mp::kBF16) return by_c(__nv_bfloat16{});
    return cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" int mp_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int dtype, int M, int C, int H, int device,
                            void* stream) {
  if (M < 1 || H < BH || H % BH != 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, C, device, [&](auto tag, auto nj) {
    using T = decltype(tag);
    return launch<T, decltype(nj)::value>(x, w1, b1, w2, b2, out, M, H, st);
  });
}

// Scratch from the caller, every pointer 16-byte aligned: da and h (M, H)
// of the element type, colsum (ceil(M / 64), 2*H + C) fp32, part (S, 2*H*C)
// fp32. ``grads`` (2*H*C + H + C, element type) receives dW1 (H, C), db1
// (H), dW2 (C, H) and db2 (C) in that order.
extern "C" int mp_fused_mlp_bwd(const void* x, const void* g, const void* w1,
                                const void* b1, const void* w2, void* dx,
                                void* da, void* h, float* colsum, float* part,
                                void* grads, int dtype, int M, int C, int H,
                                int S, int device, void* stream) {
  if (M < 1 || H < BH || H % BH != 0 || S < 1 || S > M) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, C, device, [&](auto tag, auto nj) {
    using T = decltype(tag);
    return launch_bwd<T, decltype(nj)::value>(x, g, w1, b1, w2, dx, da, h,
                                              colsum, part, grads, M, H, S, st);
  });
}

// K5 on wgmma (fp32, C = 512, H a multiple of 128). Scratch from the
// caller, 16-byte aligned: w1p (2H, 512) and w2p (1024, H) fp32, which the
// launch fills with the weights' tf32 planes before the product.
extern "C" int mp_fused_mlp_sm90(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, void* w1p,
                                 void* w2p, int M, int H, int device, void* stream) {
  if (M < 1 || H < wg::PAIR || H % wg::PAIR != 0) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    return launch_sm90(static_cast<const float*>(x), static_cast<const float*>(w1),
                       static_cast<const float*>(b1), static_cast<const float*>(w2),
                       static_cast<const float*>(b2), static_cast<float*>(out),
                       static_cast<float*>(w1p), static_cast<float*>(w2p), M, H, device,
                       static_cast<cudaStream_t>(stream));
  });
}

// K6 on wgmma (fp32, C = 512, H a multiple of 128). Scratch from the
// caller, 16-byte aligned, with Mp = M rounded up to a multiple of 128:
// planes (4H, Mp) fp32 (da^T's big and small tf32 planes, then gelu(a)^T's),
// wp (6 H C) fp32 (the weights' planes), colsum (Mp / 128, 4H + 512) fp32,
// part (S, 2 H 512) fp32. ``grads`` as for mp_fused_mlp_bwd.
extern "C" int mp_fused_mlp_bwd_sm90(const void* x, const void* g, const void* w1,
                                     const void* b1, const void* w2, void* dx, void* planes,
                                     void* wp, float* colsum, float* part, void* grads, int M,
                                     int H, int S, int device, void* stream) {
  if (M < 1 || H < wg::PAIR || H % wg::PAIR != 0 || S < 1) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    return launch_bwd_sm90(static_cast<const float*>(x), static_cast<const float*>(g),
                           static_cast<const float*>(w1), static_cast<const float*>(b1),
                           static_cast<const float*>(w2), static_cast<float*>(dx),
                           static_cast<float*>(planes), static_cast<float*>(wp), colsum, part,
                           static_cast<float*>(grads), M, H, S, device,
                           static_cast<cudaStream_t>(stream));
  });
}
