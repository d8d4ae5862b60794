// Fused MLP of the MixSTE trunk: y = gelu(x W1^T + b1) W2^T + b2 with the
// exact (erf) GELU, fp32 accumulation, fp32 or bf16 inputs, and its
// gradient. Weights come in torch Linear layout: W1 is (H, C), W2 is (C, H).
//
// Replaces the TPU kernels of manipose_tpu/ops/pallas_mlp.py:
//   fused_mlp_kernel         <- _forward / _fwd_kernel (pallas_mlp.py:83-88,
//                               95-115)
//   fused_mlp_bwd_*_kernel   <- _backward / _bwd_kernel (pallas_mlp.py:123-169,
//                               172-211)
//
// What bounds them on an H100. Every product runs on the tensor cores
// through mma.sync (mma.cuh): bf16 in one m16n8k16 pass, fp32 as 3xTF32,
// three m16n8k8 tf32 passes over operands split into big and small tf32
// parts, which keeps fp32 accuracy. Against the data sheet (dense, 700 W)
// that is 989 TFLOP/s in bf16 and 495 / 3 = 165 TFLOP/s for fp32 products;
// mma.sync itself peaks lower on the card (probes/mma_rate.cu: 324 tf32 and
// 649 bf16 TFLOP/s, so 108 for 3xTF32). At the flagship's rotations trunk
// (M = 66096 rows, C = 512, H = 1024) the forward does 4*M*C*H = 138.6
// GFLOP against 0.28 GB of device memory (3.35 TB/s) in fp32, so
// operations bound it (0.84 ms); two plain GEMMs would also write and
// re-read the (M, H) intermediate, 0.54 GB more. The backward does five
// such products, 10*M*C*H = 346 GFLOP (2.1 ms). Between the two sits L2:
// every 64-row block re-reads x and both weight matrices chunk by chunk,
// 6.3 GB a forward launch in fp32. In fp32 the kernels issue more than the
// tensor cores do: the operand splits, fragment loads and fp32 adds take
// as many issue slots as the mma (probes/run_probes.py ablates each).
//
// Design. Every kernel runs 8 warps over a cp.async ring of 3 or 4 slots
// (16-byte copies, no register staging) that holds operand tiles laid out
// as the mma fragments read them (ldmatrix for k-contiguous tiles,
// mma.cuh), so the next k-slices land while the current one is
// multiplied. The ring runs over one flat schedule of stages per block,
// so prefetch crosses from one product to the next and from one hidden
// chunk to the next. The tensor cores' fp32 accumulation
// truncates (its error grows with the reduction length), so an mma
// accumulator runs over at most one stage (64 of k) or, for the (64, C)
// accumulators, one k-step, and is then added into an fp32 sum.
//
// Forward (K5). The whole (64, C) fp32 output accumulator sits in mma
// fragments over the 8 warps (each owns C/8 columns; 128 registers a
// thread at C = 512). The block walks H in chunks of 64 hidden units: the
// chunk of fc1 (x and W1 rows streamed as they lie in memory, both
// k-contiguous; warps 2 x 4 over 32 x 16 tiles), bias and exact GELU in
// registers, the chunk to shared memory once, split into the parts the
// mma takes (rounded to bf16 under bf16, as pallas_mlp.py:86 does), then
// the chunk's fc2 into the accumulator, W2's rows streamed k-contiguous as
// well. The (M, H) intermediate never reaches device memory. Rows past M
// are zero-filled on load and masked on store, so any M is taken.
//
// Backward (K6). The TPU kernel sums dW and db over its sequential grid;
// blocks on Hopper run in no order, so the sums over M take later passes.
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
// Not yet: wgmma and TMA. wgmma's tf32 path reads B from shared memory
// only, so its split would have to be stored there, and its accumulators
// leave no registers for the fp32 sum that the truncating accumulation
// needs; the bf16 path moves to wgmma once bf16 compute is on the main
// path. 128-row tiles over a 2-CTA cluster with TMA multicast would halve
// the per-block accumulator and the L2 traffic.

#include <cmath>

#include "common.cuh"
#include "mma.cuh"

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

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
