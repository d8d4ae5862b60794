// Attention kernels of the MixSTE trunk: softmax(scale * Q K^T) V per
// (batch, head) window, and its gradient, accumulated in fp32 from fp32 or
// bf16 inputs.
//
// Replaces the TPU kernels of manipose_tpu/ops/pallas_attention.py:
//   attention_dense_kernel       <- _forward / _fwd_kernel (temporal layout,
//                                   N = 243 frames; pallas_attention.py:45-54,
//                                   97-112)
//   attention_dense_bwd_*_kernel <- _forward_bwd / _bwd_kernel
//                                   (pallas_attention.py:57-83, 119-140)
//   attention_packed_kernel      <- _packed_forward / _packed_fwd_kernel
//                                   (spatial layout, N = 16 bones or 17 joints;
//                                   pallas_attention.py:149-164, 224-241)
//   attention_packed_bwd_kernel  <- _packed_forward_bwd / _packed_bwd_kernel
//                                   (pallas_attention.py:167-198, 248-271)
//
// Layout. Q, K and V are strided views of the qkv projection
// (B, N, 3, H, D): element (b, h, n, i) sits at b*sb + h*sh + n*sn + i, and
// the three share the strides, so no copy is made before the launch. The
// output is written as (B, N, H, D), which is the merged-head (B, N, H*D)
// tensor the output projection reads, so no transpose follows either. The
// backward kernels read the output and its gradient through their own
// strides (ob, oh, on) and write dQ, dK and dV through theirs (gb, gh, gn):
// views of one (B, N, 3, H, D) tensor, the gradient of the qkv projection.
//
// What bounds them on an H100 (data sheet, dense, 700 W). Dense, at the
// flagship's rotations trunk (2176 windows of 243 x 64): 4*N*N*D flop per
// window forward, 32.9 GFLOP in all against 0.54 GB moved in fp32. fp32
// products at fp32 accuracy run on the tensor cores as 3xTF32 (mma.cuh), a
// third of the 495 TFLOP/s tf32 rate, so arithmetic bounds it at ~0.20 ms;
// the backward recomputes the scores and does 10*N*N*D flop per window,
// ~0.50 ms. mma.sync itself peaks lower on the card (probes/mma_rate.cu).
// Packed (31104 windows of 17 x 64): 2.3 GFLOP against 0.54 GB, so memory
// (3.35 TB/s) bounds it at ~0.16 ms, and its backward, which moves seven
// such tensors, at ~0.28 ms.
//
// Dense design: FlashAttention-2 on warp-level mma.sync (mma.cuh). The TPU
// kernel holds the whole N x N fp32 score matrix in VMEM; at N = 243 that
// is 236 KB, more than a block's shared memory. Here a block of 4 warps
// takes 64 rows of one window, 16 per warp, and streams the other side
// through a 2-slot cp.async ring 64 rows at a time; copies zero-fill rows
// at or past N, and the words that pad a bf16 row of D = 8 to one 16-wide
// k-step are zeroed once. Every product runs on the tensor cores: bf16 in
// one m16n8k16 pass, fp32 as 3xTF32 over operands split into big and
// small tf32 parts. Because the tensor cores' fp32 accumulation truncates,
// no mma accumulator runs over more than 64 of k: scores over d <= 64
// start fresh, and every product over rows (P V, dS K, P^T dO, dS^T Q)
// runs per 64-row tile from a fresh accumulator that is then added into
// an fp32 sum.
//
// The scores' accumulator fragments feed the next product straight from
// registers. Lane (g, t) holds columns 2t and 2t + 1 of rows g and g + 8
// of each 8-column tile. Under bf16 two tiles pack into the A fragment of
// m16n8k16 as they lie (FlashAttention-2's register reuse). tf32's
// m16n8k8 A fragment wants columns t and t + 4 instead, so its k-index is
// permuted (t <-> column 2t, t + 4 <-> column 2t + 1) and the B operand's
// rows are read with the same permutation (load_b_rows); a sum over k
// does not depend on its order.
//
// K1 (forward) keeps its 16 query rows of Q in registers, split once, and
// per 64-key tile takes S = Q K^T, the online softmax on the accumulator
// fragments (row max and sum over the quad of lanes that share a row,
// exp2 of log2e-prescaled scores, keys past N at -inf; key 0 of every tile
// is valid, so the running max stays finite), then P V from a fresh
// accumulator and o = o * corr + pv in fp32. It writes o / l, and the
// log-sum-exp m + log l when a gradient is wanted.
//
// K2 (backward) is FlashAttention-2's two passes from K1's log-sum-exp,
// without atomics: every output row is owned by one warp and summed in a
// fixed order, so repeated runs agree bit for bit. Both rebuild
// P = exp(scale * S - lse) and use delta = rowsum(dO * O), which equals
// the TPU kernel's rowsum(dP * P). The dQ pass takes a block of 64
// queries (Q and dO in shared memory), writes their delta, and streams K
// and V: S = Q K^T, dP = dO V^T, dS = P * (dP - delta), dQ += dS K. The
// dK/dV pass takes a block of 64 keys (K and V in shared memory) and
// streams Q, dO and each query's lse and delta; it computes the transposed
// scores S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the
// accumulator layout with one row per key, and dV += P^T dO and
// dK += dS^T Q need no transpose through shared memory. K and V (or Q and
// dO) stay in shared memory rather than registers, where their split
// fragments would not fit beside the dK and dV sums.
//
// Packed design. The TPU packs G tiny windows into one block-diagonal
// (G*N)^2 tile to fill its 128 x 128 matrix unit. Here that trick has no
// use: one warp takes one window, each lane one query row, K, V and Q are
// staged with coalesced 16-byte loads, and the output is staged back
// through shared memory so it leaves with coalesced stores. No masking is
// needed. Four warps per block keep enough loads in flight across the 132
// SMs for a memory-bound kernel. The packed backward stages Q, K, V and dO
// of its window and works as the TPU kernel does: each lane recomputes its
// row of P and dS in registers and leaves them in shared memory; then lane
// j sums column j for dK and dV and lane i row i for dQ, each result
// written over a staged input that is no longer read, and all three leave
// with coalesced stores. Both run fp32 arithmetic on the CUDA cores.
//
// Not yet: wgmma and TMA with warp specialisation.

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int SUB = 8;           // keys scored in registers per rescale
constexpr int PACKED_WARPS = 4;  // windows per block
constexpr int PACKED_MAX_N = 32;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ void fma4(float s, float4 a, float4& acc) {
  acc.x = fmaf(s, a.x, acc.x);
  acc.y = fmaf(s, a.y, acc.y);
  acc.z = fmaf(s, a.z, acc.z);
  acc.w = fmaf(s, a.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ---- dense kernels (K1, K2) on the tensor cores ----------------------------

constexpr int TROWS = 64;             // rows of a streamed tile: keys or queries
constexpr int DSTAGES = 2;            // slots of the dense kernels' cp.async ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile geometry of the dense kernels for element type T and head dim D.
template <typename T, int D>
struct Dense {
  static constexpr int EW = 4 / int(sizeof(T));  // elements per 32-bit word
  static constexpr int DW = D / EW;              // words of a row
  static constexpr int KS = (DW + 7) / 8;        // k-steps of a product over d
  static constexpr int LD = 8 * KS + 4;          // shared row stride, words
  static constexpr int TILE = TROWS * LD;        // words of a 64-row tile
  static constexpr int NO = D / 8;               // 8-column tiles of a row
  static constexpr int KK = 8 * EW;              // rows a k-step over rows
  static constexpr int PARTS = mp::Mma<T>::PARTS;
  // A block of WARPS warps, 16 rows each, owns ROWS rows of its window; its
  // registers are capped so that BLOCKS blocks share an SM. A third block
  // measured faster (probes/run_probes.py, blocks3) at bf16 d = 64 (K1
  // and K2 by 10-12 %) and fp32 d = 16 (K2 by 10 %), slower elsewhere.
  static constexpr int WARPS = 4;
  static constexpr int BLOCKS = (EW == 2 && D == 64) || (EW == 1 && D == 16) ? 3 : 2;
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int OWN = ROWS * LD;          // words of the block's own rows
  static_assert(THREADS >= 2 * TROWS, "a thread for each lse and delta of a tile");
};

__device__ __forceinline__ int dense_warp() { return threadIdx.x >> 5; }

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
}

template <int NT>
__device__ __forceinline__ void add_acc(float (&acc)[NT][4], const float (&part)[NT][4]) {
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] += part[ni][e];
}

// Zero the words past the head dim up to a whole k-step (bf16 at D = 8,
// whose k-step is 16 elements) in ``rows`` consecutive rows. The copies
// never write them, so once a block is enough.
template <typename T, int D>
__device__ __forceinline__ void zero_pads(uint32_t* s, int rows) {
  using G = Dense<T, D>;
  constexpr int PAD = 8 * G::KS - G::DW;
  if constexpr (PAD > 0) {
    for (int e = threadIdx.x; e < rows * PAD; e += G::THREADS) {
      s[(e / PAD) * G::LD + G::DW + e % PAD] = 0u;
    }
  }
}

// A fragment (all parts) of rows row0.. row0 + 15, words kw.. kw + 7, of a
// [row][word] tile.
template <typename T>
__device__ __forceinline__ void load_a_split(uint32_t (&a)[mp::Mma<T>::PARTS][4],
                                             const uint32_t* s, int ld, int row0,
                                             int kw) {
  uint32_t w[4];
  mp::load_a_nat(w, s, ld, row0, kw);
  mp::Mma<T>::split(w, a);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (all parts) of k-step j of a product whose k runs over the 64
// columns of the accumulator c (16 rows: P, dS or their transposes): bf16
// packs tiles 2j and 2j + 1 as they lie; fp32 takes tile j with its
// k-index permuted (t <-> column 2t, t + 4 <-> column 2t + 1).
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[mp::Mma<T>::PARTS][4],
                                         const float (&c)[8][4], int j) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t w[4] = {__float_as_uint(c[j][0]), __float_as_uint(c[j][2]),
                           __float_as_uint(c[j][1]), __float_as_uint(c[j][3])};
    mp::Mma<float>::split(w, a);
  } else {
    a[0][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[0][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[0][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[0][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// B fragment of a product whose k runs over the rows of a [row][word] tile
// (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q): columns n0.. n0 + 7 of
// the k-step at row k0. fp32 reads its rows in acc_to_a's permutation
// (k-index t from row 2t, t + 4 from row 2t + 1; the row stride of
// 8 * KS + 4 words keeps the 32 lanes on distinct banks); bf16 takes
// ldmatrix.trans.
template <typename T>
__device__ __forceinline__ void load_b_rows(uint32_t (&w)[2], const uint32_t* s,
                                            int ld, int n0, int k0) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t* p = s + (k0 + 2 * mp::lane_t()) * ld + n0 + mp::lane_g();
    w[0] = p[0];
    w[1] = p[ld];
  } else {
    mp::load_b_tr(w, reinterpret_cast<const __nv_bfloat16*>(s), 2 * ld, n0, k0);
  }
}

// acc[ni] += A B(ni) over one k-step for ni < NT, every pass, A split
// already; ``load_b(ni, w)`` fetches B(ni)'s raw words, split here. The
// passes run one after the other over the NT tiles, so consecutive mma are
// independent.
template <typename T, int NT, typename LB>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&a)[mp::Mma<T>::PARTS][4],
                                        LB load_b) {
  using M = mp::Mma<T>;
  uint32_t b[NT][M::PARTS][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    uint32_t w[2];
    load_b(ni, w);
    M::split(w, b[ni]);
  }
#pragma unroll
  for (int pass = 0; pass < M::PASSES; ++pass)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) M::mma(acc[ni], a, b[ni], pass);
}

// The online softmax over one 64-key tile of scores sc (rows g and g + 8 in
// e = 0, 1 and e = 2, 3 of each 8-key tile; keys at or past kn masked):
// sc becomes P = exp2(c * S - m) with the running max m updated, l takes
// the tile's row sums over this lane's keys (the quad's are added at the
// end) and corr the factor that rescales what came before.
__device__ __forceinline__ void online_softmax(float (&sc)[8][4], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float c, int kn) {
  const int t = mp::lane_t();
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[ni][e] = 8 * ni + 2 * t + (e & 1) < kn ? sc[ni][e] * c : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[ni][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[ni][e] = exp2f(sc[ni][e] - m[e >> 1]);
      l[e >> 1] += sc[ni][e];
    }
}

// K1: one block per (window, ROWS query rows). Shared memory: the queries,
// then the ring's slots of (K, V) tiles.
template <typename T, int D>
__global__ void __launch_bounds__(Dense<T, D>::THREADS, Dense<T, D>::BLOCKS)
attention_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int N, long long sb,
                       long long sh, long long sn, float scale) {
  using G = Dense<T, D>;
  extern __shared__ __align__(16) uint32_t tiles_smem[];
  const int tiles = (N + TROWS - 1) / TROWS;  // streamed tiles
  const int per = (N + G::ROWS - 1) / G::ROWS;  // blocks a window
  const int bh = blockIdx.x / per;
  const int q0 = (blockIdx.x % per) * G::ROWS;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long pitch = sn * static_cast<long long>(sizeof(T));
  const int row0 = dense_warp() * 16;  // the warp's rows of the tile

  zero_pads<T, D>(tiles_smem, G::ROWS + 2 * DSTAGES * TROWS);
  mp::copy_tile<G::ROWS, G::DW, G::THREADS>(tiles_smem, G::LD, q + base + q0 * sn, pitch,
                                            N - q0);
  auto ring = mp::start_ring<DSTAGES, 2 * G::TILE>(tiles_smem + G::OWN, [&](int s) {
    if (s < tiles) {
      uint32_t* slot = tiles_smem + G::OWN + (s % DSTAGES) * 2 * G::TILE;
      const long long off = base + static_cast<long long>(s) * TROWS * sn;
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot, G::LD, k + off, pitch, N - s * TROWS);
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot + G::TILE, G::LD, v + off, pitch,
                                            N - s * TROWS);
    }
    mp::cp_async_commit();
  });

  uint32_t qa[G::KS][G::PARTS][4];
  float o[G::NO][4];
  zero_acc(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
#pragma unroll 1
  for (int s = 0; s < tiles; ++s) {
    const uint32_t* ks = ring.next();
    const uint32_t* vs = ks + G::TILE;
    if (s == 0) {  // Q landed with the first tile
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk) load_a_split<T>(qa[kk], tiles_smem, G::LD, row0, 8 * kk);
    }
    float sc[8][4];  // S = Q K^T: d <= 64, one fresh accumulator
    zero_acc(sc);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      mma_row<T>(sc, qa[kk], [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, ks, G::LD, 8 * ni, 8 * kk);
      });
    }
    float corr[2];
    online_softmax(sc, m, l, corr, c, N - s * TROWS);
    float pv[G::NO][4];  // P V over this tile's 64 keys
    zero_acc(pv);
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[G::PARTS][4];
      acc_to_a<T>(a, sc, j);
      mma_row<T>(pv, a, [&](int ni, uint32_t (&w)[2]) {
        load_b_rows<T>(w, vs, G::LD, 8 * ni, G::KK * j);
      });
    }
#pragma unroll
    for (int ni = 0; ni < G::NO; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ni][e] = fmaf(o[ni][e], corr[e >> 1], pv[ni][e]);
  }
  mp::cp_async_wait<0>();

  const int g = mp::lane_g(), t = mp::lane_t();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + row0 + g + 8 * r;
    if (row < N) {  // rows past N ran on zeros; they store nothing
      const float inv = 1.f / l[r];
      T* dst = out + ((static_cast<long long>(b) * N + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int ni = 0; ni < G::NO; ++ni) {
        mp::store2(dst + 8 * ni, o[ni][2 * r] * inv, o[ni][2 * r + 1] * inv);
      }
      if (lse != nullptr && t == 0) {
        lse[static_cast<long long>(bh) * N + row] = (m[r] + log2f(l[r])) * LN2;
      }
    }
  }
}

// dQ pass: one block per (window, ROWS query rows), K and V streamed.
// Shared memory: Q and dO of the block's queries, the ring's slots of
// (K, V) tiles, then the queries' delta. dQ = scale * sum_j dS_ij k_j.
template <typename T, int D>
__global__ void __launch_bounds__(Dense<T, D>::THREADS, Dense<T, D>::BLOCKS)
attention_dense_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int H, int N, long long sb, long long sh, long long sn,
    long long ob, long long oh, long long on, long long gb, long long gh,
    long long gn, float scale) {
  using G = Dense<T, D>;
  extern __shared__ __align__(16) uint32_t tiles_smem[];
  const uint32_t* qs = tiles_smem;
  const uint32_t* gs = tiles_smem + G::OWN;
  float* dls = reinterpret_cast<float*>(tiles_smem + 2 * G::OWN + 2 * DSTAGES * G::TILE);
  const int tiles = (N + TROWS - 1) / TROWS;  // streamed tiles
  const int per = (N + G::ROWS - 1) / G::ROWS;  // blocks a window
  const int bh = blockIdx.x / per;
  const int q0 = (blockIdx.x % per) * G::ROWS;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh, obase = b * ob + h * oh;
  const long long pitch = sn * static_cast<long long>(sizeof(T));
  const int row0 = dense_warp() * 16;

  zero_pads<T, D>(tiles_smem, 2 * G::ROWS + 2 * DSTAGES * TROWS);
  mp::copy_tile<G::ROWS, G::DW, G::THREADS>(tiles_smem, G::LD, q + base + q0 * sn, pitch,
                                            N - q0);
  mp::copy_tile<G::ROWS, G::DW, G::THREADS>(tiles_smem + G::OWN, G::LD,
                                            dout + obase + q0 * on,
                                            on * static_cast<long long>(sizeof(T)), N - q0);
  auto ring = mp::start_ring<DSTAGES, 2 * G::TILE>(tiles_smem + 2 * G::OWN, [&](int s) {
    if (s < tiles) {
      uint32_t* slot = tiles_smem + 2 * G::OWN + (s % DSTAGES) * 2 * G::TILE;
      const long long off = base + static_cast<long long>(s) * TROWS * sn;
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot, G::LD, k + off, pitch, N - s * TROWS);
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot + G::TILE, G::LD, v + off, pitch,
                                            N - s * TROWS);
    }
    mp::cp_async_commit();
  });

  {  // delta = rowsum(dO * O), two threads a row, for the dK/dV pass too
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (row < N) {
      const long long off = obase + row * on + half * (D / 2);
#pragma unroll
      for (int c4 = 0; c4 < D / 8; ++c4) {
        d += dot4(mp::load4(dout + off + 4 * c4), mp::load4(o + off + 4 * c4));
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      dls[r] = d;
      if (row < N) delta[static_cast<long long>(bh) * N + row] = d;
    }
  }

  const int g = mp::lane_g(), t = mp::lane_t();
  float lr[2], dr[2];  // lse (log2 units) and delta of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    lr[r] = row < N ? lse[static_cast<long long>(bh) * N + row] * LOG2E : 0.f;
  }
  float acc[G::NO][4];
  zero_acc(acc);
  const float c = scale * LOG2E;
#pragma unroll 1
  for (int s = 0; s < tiles; ++s) {
    const uint32_t* ks = ring.next();
    const uint32_t* vs = ks + G::TILE;
    if (s == 0) {  // delta is in shared memory now
      dr[0] = dls[row0 + g];
      dr[1] = dls[row0 + g + 8];
    }
    float sc[8][4];  // S = Q K^T, then P
    zero_acc(sc);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, qs, G::LD, row0, 8 * kk);
      mma_row<T>(sc, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, ks, G::LD, 8 * ni, 8 * kk);
      });
    }
    const int kn = N - s * TROWS;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[ni][e] = 8 * ni + 2 * t + (e & 1) < kn
                        ? exp2f(fmaf(sc[ni][e], c, -lr[e >> 1]))
                        : 0.f;
      }
    float dp[8][4];  // dP = dO V^T, then dS = P * (dP - delta)
    zero_acc(dp);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, gs, G::LD, row0, 8 * kk);
      mma_row<T>(dp, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, vs, G::LD, 8 * ni, 8 * kk);
      });
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[ni][e] = sc[ni][e] * (dp[ni][e] - dr[e >> 1]);
    float part[G::NO][4];  // dS K over this tile's 64 keys
    zero_acc(part);
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[G::PARTS][4];
      acc_to_a<T>(a, dp, j);
      mma_row<T>(part, a, [&](int ni, uint32_t (&w)[2]) {
        load_b_rows<T>(w, ks, G::LD, 8 * ni, G::KK * j);
      });
    }
    add_acc(acc, part);
  }
  mp::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row < N) {
      T* dst = dq + b * gb + h * gh + row * gn + 2 * t;
#pragma unroll
      for (int ni = 0; ni < G::NO; ++ni) {
        mp::store2(dst + 8 * ni, acc[ni][2 * r] * scale, acc[ni][2 * r + 1] * scale);
      }
    }
  }
}

// dK/dV pass: one block per (window, ROWS key rows), Q and dO streamed
// with each query's lse and delta. Shared memory: K and V of the block's
// keys, the ring's slots of (Q, dO) tiles, then each slot's lse (log2
// units; +inf past N, so P is 0 there) and delta.
// dV = sum_i P_ij dO_i, dK = scale * sum_i dS_ij q_i.
template <typename T, int D>
__global__ void __launch_bounds__(Dense<T, D>::THREADS, Dense<T, D>::BLOCKS)
attention_dense_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int N, long long sb, long long sh, long long sn, long long ob,
    long long oh, long long on, long long gb, long long gh, long long gn,
    float scale) {
  using G = Dense<T, D>;
  extern __shared__ __align__(16) uint32_t tiles_smem[];
  const uint32_t* ks = tiles_smem;
  const uint32_t* vs = tiles_smem + G::OWN;
  float* lds = reinterpret_cast<float*>(tiles_smem + 2 * G::OWN + 2 * DSTAGES * G::TILE);
  const int tiles = (N + TROWS - 1) / TROWS;  // streamed tiles
  const int per = (N + G::ROWS - 1) / G::ROWS;  // blocks a window
  const int bh = blockIdx.x / per;
  const int k0 = (blockIdx.x % per) * G::ROWS;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh, obase = b * ob + h * oh;
  const long long pitch = sn * static_cast<long long>(sizeof(T));
  const long long opitch = on * static_cast<long long>(sizeof(T));
  const int row0 = dense_warp() * 16;

  zero_pads<T, D>(tiles_smem, 2 * G::ROWS + 2 * DSTAGES * TROWS);
  mp::copy_tile<G::ROWS, G::DW, G::THREADS>(tiles_smem, G::LD, k + base + k0 * sn, pitch,
                                            N - k0);
  mp::copy_tile<G::ROWS, G::DW, G::THREADS>(tiles_smem + G::OWN, G::LD, v + base + k0 * sn,
                                            pitch, N - k0);
  auto ring = mp::start_ring<DSTAGES, 2 * G::TILE>(tiles_smem + 2 * G::OWN, [&](int s) {
    if (s < tiles) {
      uint32_t* slot = tiles_smem + 2 * G::OWN + (s % DSTAGES) * 2 * G::TILE;
      const int r0 = s * TROWS;
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot, G::LD, q + base + r0 * sn, pitch, N - r0);
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot + G::TILE, G::LD, dout + obase + r0 * on,
                                            opitch, N - r0);
      // thread i < 64: lse of query r0 + i; thread 64 + i: its delta
      const int i = threadIdx.x, r = r0 + i % TROWS;
      const long long ri = static_cast<long long>(bh) * N + r;
      float* ls = lds + (s % DSTAGES) * 2 * TROWS;
      if (i < TROWS) {
        ls[i] = r < N ? lse[ri] * LOG2E : INFINITY;
      } else if (i < 2 * TROWS) {
        ls[i] = r < N ? delta[ri] : 0.f;
      }
    }
    mp::cp_async_commit();
  });

  const int t = mp::lane_t();
  float dka[G::NO][4], dva[G::NO][4];
  zero_acc(dka);
  zero_acc(dva);
  const float c = scale * LOG2E;
#pragma unroll 1
  for (int s = 0; s < tiles; ++s) {
    const uint32_t* qs = ring.next();
    const uint32_t* gs = qs + G::TILE;
    const float* ls = lds + (s % DSTAGES) * 2 * TROWS;
    const float* dls = ls + TROWS;
    float st[8][4];  // S^T = K Q^T (row = key, column = query), then P^T
    zero_acc(st);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, ks, G::LD, row0, 8 * kk);
      mma_row<T>(st, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, qs, G::LD, 8 * ni, 8 * kk);
      });
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[ni][e] = exp2f(fmaf(st[ni][e], c, -ls[8 * ni + 2 * t + (e & 1)]));
      }
    float part[G::NO][4];  // P^T dO over this tile's 64 queries
    zero_acc(part);
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[G::PARTS][4];
      acc_to_a<T>(a, st, j);
      mma_row<T>(part, a, [&](int ni, uint32_t (&w)[2]) {
        load_b_rows<T>(w, gs, G::LD, 8 * ni, G::KK * j);
      });
    }
    add_acc(dva, part);
    float dpt[8][4];  // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta)
    zero_acc(dpt);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, vs, G::LD, row0, 8 * kk);
      mma_row<T>(dpt, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, gs, G::LD, 8 * ni, 8 * kk);
      });
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[ni][e] = st[ni][e] * (dpt[ni][e] - dls[8 * ni + 2 * t + (e & 1)]);
      }
    zero_acc(part);  // dS^T Q over this tile's 64 queries
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[G::PARTS][4];
      acc_to_a<T>(a, dpt, j);
      mma_row<T>(part, a, [&](int ni, uint32_t (&w)[2]) {
        load_b_rows<T>(w, qs, G::LD, 8 * ni, G::KK * j);
      });
    }
    add_acc(dka, part);
  }
  mp::cp_async_wait<0>();

  const int g = mp::lane_g();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + row0 + g + 8 * r;
    if (row < N) {
      const long long off = b * gb + h * gh + row * gn + 2 * t;
#pragma unroll
      for (int ni = 0; ni < G::NO; ++ni) {
        mp::store2(dk + off + 8 * ni, dka[ni][2 * r] * scale, dka[ni][2 * r + 1] * scale);
        mp::store2(dv + off + 8 * ni, dva[ni][2 * r], dva[ni][2 * r + 1]);
      }
    }
  }
}

// Shared memory of the dense kernels, in bytes.
template <typename T, int D>
constexpr size_t dense_fwd_smem() {
  return 4u * (Dense<T, D>::OWN + 2 * DSTAGES * Dense<T, D>::TILE);
}
template <typename T, int D>
constexpr size_t dense_dq_smem() {
  return 4u * (2 * Dense<T, D>::OWN + 2 * DSTAGES * Dense<T, D>::TILE + Dense<T, D>::ROWS);
}
template <typename T, int D>
constexpr size_t dense_dkv_smem() {
  return 4u * (2 * Dense<T, D>::OWN + 2 * DSTAGES * Dense<T, D>::TILE + 2 * DSTAGES * TROWS);
}

// ---- per-window kernels (N <= 32) -----------------------------------------
// Fold keys [0, kn) of the staged K/V rows (row stride D floats) into one
// query row's online-softmax state (o, m, l).
template <int D>
__device__ __forceinline__ void attend_keys(const float (&qr)[D],
                                            const float* Ks, const float* Vs,
                                            int kn, float scale, float (&o)[D],
                                            float& m, float& l) {
  for (int j0 = 0; j0 < kn; j0 += SUB) {
    float s[SUB];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      float acc = -INFINITY;
      if (j0 + jj < kn) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + (j0 + jj) * D);
        acc = 0.f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 kv = kr[c];
          acc = fmaf(qr[4 * c + 0], kv.x, acc);
          acc = fmaf(qr[4 * c + 1], kv.y, acc);
          acc = fmaf(qr[4 * c + 2], kv.z, acc);
          acc = fmaf(qr[4 * c + 3], kv.w, acc);
        }
        acc *= scale;
      }
      s[jj] = acc;
      mx = fmaxf(mx, acc);
    }
    const float m_new = fmaxf(m, mx);  // finite: key j0 is always valid
    const float corr = __expf(m - m_new);  // 0 on the first step (m = -inf)
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] *= corr;
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      if (j0 + jj < kn) {
        const float p = __expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + jj) * D);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 vv = vr[c];
          o[4 * c + 0] = fmaf(p, vv.x, o[4 * c + 0]);
          o[4 * c + 1] = fmaf(p, vv.y, o[4 * c + 1]);
          o[4 * c + 2] = fmaf(p, vv.z, o[4 * c + 2]);
          o[4 * c + 3] = fmaf(p, vv.w, o[4 * c + 3]);
        }
      }
    }
    m = m_new;
  }
}

// Shared floats per warp: K and V rows (stride D) and the Q / output rows
// (stride D + 4, so 8 lanes reading 8 rows hit distinct banks).
template <int D>
__host__ __device__ constexpr int packed_warp_floats(int n) {
  return n * (2 * D + D + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(PACKED_WARPS * 32)
attention_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int BH,
                        int H, int N, long long sb, long long sh,
                        long long sn, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QS = D + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * PACKED_WARPS + warp;
  if (bh >= BH) return;  // warp-uniform; only __syncwarp follows
  float* Ks = smem + warp * packed_warp_floats<D>(N);
  float* Vs = Ks + N * D;
  float* Qs = Vs + N * D;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;

  for (int e = lane; e < N * (D / 4); e += 32) {
    const int j = e / (D / 4), c = e % (D / 4);
    const long long off = base + j * sn + 4 * c;
    mp::store4(Ks + j * D + 4 * c, mp::load4(k + off));
    mp::store4(Vs + j * D + 4 * c, mp::load4(v + off));
    mp::store4(Qs + j * QS + 4 * c, mp::load4(q + off));
  }
  __syncwarp();

  if (lane < N) {
    float qr[D], o[D];
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 t = lds4(Qs + lane * QS + 4 * c);
      qr[4 * c + 0] = t.x;
      qr[4 * c + 1] = t.y;
      qr[4 * c + 2] = t.z;
      qr[4 * c + 3] = t.w;
      o[4 * c + 0] = o[4 * c + 1] = o[4 * c + 2] = o[4 * c + 3] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    attend_keys<D>(qr, Ks, Vs, N, scale, o, m, l);
    const float inv = 1.f / l;
    // each lane rewrites only its own Q row, which only it has read
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      sts4(Qs + lane * QS + 4 * c,
           make_float4(o[4 * c] * inv, o[4 * c + 1] * inv, o[4 * c + 2] * inv,
                       o[4 * c + 3] * inv));
    }
  }
  __syncwarp();

  for (int e = lane; e < N * (D / 4); e += 32) {
    const int j = e / (D / 4), c = e % (D / 4);
    T* dst = out + ((static_cast<long long>(b) * N + j) * H + h) * D + 4 * c;
    mp::store4(dst, lds4(Qs + j * QS + 4 * c));
  }
}

// Shared floats per warp of the backward: Q, K, V and dO rows (stride
// D + 4: every one is read or written a row per lane at some point), then
// P and dS (N rows of stride 33, so a column read by 32 lanes is
// conflict-free), rounded up to whole float4s so the next warp's rows stay
// 16-byte aligned.
constexpr int PS = PACKED_MAX_N + 1;
template <int D>
__host__ __device__ constexpr int packed_bwd_warp_floats(int n) {
  return (4 * n * (D + 4) + 2 * n * PS + 3) / 4 * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(PACKED_WARPS * 32)
attention_packed_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int BH, int H, int N, long long sb, long long sh,
    long long sn, long long ob, long long oh, long long on, long long gb,
    long long gh, long long gn, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = D + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * PACKED_WARPS + warp;
  if (bh >= BH) return;  // warp-uniform; only __syncwarp follows
  float* Qs = smem + warp * packed_bwd_warp_floats<D>(N);
  float* Ks = Qs + N * RS;
  float* Vs = Ks + N * RS;
  float* Gs = Vs + N * RS;  // dO
  float* Ps = Gs + N * RS;
  float* Ss = Ps + N * PS;  // dS
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long obase = b * ob + h * oh;
  const long long gbase = b * gb + h * gh;

  for (int e = lane; e < N * (D / 4); e += 32) {
    const int j = e / (D / 4), c = 4 * (e % (D / 4));
    const long long off = base + j * sn + c;
    mp::store4(Qs + j * RS + c, mp::load4(q + off));
    mp::store4(Ks + j * RS + c, mp::load4(k + off));
    mp::store4(Vs + j * RS + c, mp::load4(v + off));
    mp::store4(Gs + j * RS + c, mp::load4(dout + obase + j * on + c));
  }
  __syncwarp();

  // lane i: row i of P = softmax(scale q_i K^T), dP = dO_i V^T and
  // dS = P * (dP - rowsum(dP * P)), into shared memory
  if (lane < N) {
    float s[PACKED_MAX_N], dp[PACKED_MAX_N];
#pragma unroll
    for (int j = 0; j < PACKED_MAX_N; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float4 qv = lds4(Qs + lane * RS + c);
      const float4 gv = lds4(Gs + lane * RS + c);
#pragma unroll
      for (int j = 0; j < PACKED_MAX_N; ++j) {
        if (j < N) {
          s[j] += dot4(qv, lds4(Ks + j * RS + c));
          dp[j] += dot4(gv, lds4(Vs + j * RS + c));
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < PACKED_MAX_N; ++j) {
      if (j < N) m = fmaxf(m, s[j] * scale);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < PACKED_MAX_N; ++j) {
      if (j < N) {
        s[j] = __expf(s[j] * scale - m);
        l += s[j];
      }
    }
    const float inv = 1.f / l;
    float di = 0.f;
#pragma unroll
    for (int j = 0; j < PACKED_MAX_N; ++j) {
      if (j < N) {
        s[j] *= inv;
        di += s[j] * dp[j];
      }
    }
#pragma unroll
    for (int j = 0; j < PACKED_MAX_N; ++j) {
      if (j < N) {
        Ps[lane * PS + j] = s[j];
        Ss[lane * PS + j] = s[j] * (dp[j] - di);
      }
    }
  }
  __syncwarp();

  // lane j: dV_j = sum_i P_ij dO_i, over V's row j (V is no longer read)
  if (lane < N) {
    for (int c = 0; c < D; c += 4) {
      float4 acc = zero4();
      for (int i = 0; i < N; ++i) fma4(Ps[i * PS + lane], lds4(Gs + i * RS + c), acc);
      sts4(Vs + lane * RS + c, acc);
    }
  }
  __syncwarp();
  // lane i: dQ_i = scale * sum_j dS_ij k_j, over dO's row i
  if (lane < N) {
    for (int c = 0; c < D; c += 4) {
      float4 acc = zero4();
      for (int j = 0; j < N; ++j) fma4(Ss[lane * PS + j], lds4(Ks + j * RS + c), acc);
      sts4(Gs + lane * RS + c, scale4(acc, scale));
    }
  }
  __syncwarp();
  // lane j: dK_j = scale * sum_i dS_ij q_i, over K's row j
  if (lane < N) {
    for (int c = 0; c < D; c += 4) {
      float4 acc = zero4();
      for (int i = 0; i < N; ++i) fma4(Ss[i * PS + lane], lds4(Qs + i * RS + c), acc);
      sts4(Ks + lane * RS + c, scale4(acc, scale));
    }
  }
  __syncwarp();

  for (int e = lane; e < N * (D / 4); e += 32) {
    const int j = e / (D / 4), c = 4 * (e % (D / 4));
    const long long off = gbase + j * gn + c;
    mp::store4(dq + off, lds4(Gs + j * RS + c));
    mp::store4(dk + off, lds4(Ks + j * RS + c));
    mp::store4(dv + off, lds4(Vs + j * RS + c));
  }
}

// ---- dispatch ---------------------------------------------------------------
// Calls f(T{}, std::integral_constant<int, D>{}) for the element type and
// head dim of a launch, or returns cudaErrorInvalidValue.
template <typename T, typename F>
cudaError_t with_dim(int d, F f) {
  switch (d) {
    case 8: return f(T{}, std::integral_constant<int, 8>{});
    case 16: return f(T{}, std::integral_constant<int, 16>{});
    case 32: return f(T{}, std::integral_constant<int, 32>{});
    case 64: return f(T{}, std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_types(int dtype, int d, int device, F f) {
  return mp::on_device(device, [&] {
    if (dtype == mp::kF32) return with_dim<float>(d, f);
    if (dtype == mp::kBF16) return with_dim<__nv_bfloat16>(d, f);
    return cudaErrorInvalidValue;
  });
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// ``lse`` may be null: the log-sum-exp is written only when a gradient is
// wanted.
extern "C" int mp_attention_dense(const void* q, const void* k, const void* v,
                                  void* out, float* lse, int dtype, int B,
                                  int H, int N, int D, long long sb,
                                  long long sh, long long sn, float scale,
                                  int device, void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    const size_t smem = dense_fwd_smem<T, d>();
    cudaError_t err = allow_smem(attention_dense_kernel<T, d>, smem);
    if (err != cudaSuccess) return err;
    using G = Dense<T, d>;
    const long long blocks =
        static_cast<long long>(B) * H * ((N + G::ROWS - 1) / G::ROWS);
    attention_dense_kernel<T, d><<<static_cast<unsigned>(blocks), G::THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, H, N, sb, sh, sn,
        scale);
    return cudaGetLastError();
  });
}

// ``delta`` is (B*H*N) fp32 scratch, written by the first pass and read by
// the second.
extern "C" int mp_attention_dense_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int N, int D, long long sb,
    long long sh, long long sn, long long ob, long long oh, long long on,
    long long gb, long long gh, long long gn, float scale, int device,
    void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    const size_t dq_smem = dense_dq_smem<T, d>(), dkv_smem = dense_dkv_smem<T, d>();
    cudaError_t err = allow_smem(attention_dense_bwd_dq_kernel<T, d>, dq_smem);
    if (err != cudaSuccess) return err;
    err = allow_smem(attention_dense_bwd_dkv_kernel<T, d>, dkv_smem);
    if (err != cudaSuccess) return err;
    using G = Dense<T, d>;
    const unsigned blocks = static_cast<unsigned>(
        static_cast<long long>(B) * H * ((N + G::ROWS - 1) / G::ROWS));
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* gt = static_cast<const T*>(dout);
    attention_dense_bwd_dq_kernel<T, d><<<blocks, G::THREADS, dq_smem, st>>>(
        qt, kt, vt, static_cast<const T*>(o), gt, lse, delta,
        static_cast<T*>(dq), H, N, sb, sh, sn, ob, oh, on, gb, gh, gn, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_dense_bwd_dkv_kernel<T, d><<<blocks, G::THREADS, dkv_smem, st>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        H, N, sb, sh, sn, ob, oh, on, gb, gh, gn, scale);
    return cudaGetLastError();
  });
}

extern "C" int mp_attention_packed(const void* q, const void* k,
                                   const void* v, void* out, int dtype, int B,
                                   int H, int N, int D, long long sb,
                                   long long sh, long long sn, float scale,
                                   int device, void* stream) {
  if (N < 1 || N > PACKED_MAX_N) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    const size_t smem = sizeof(float) * PACKED_WARPS * packed_warp_floats<d>(N);
    cudaError_t err = allow_smem(attention_packed_kernel<T, d>, smem);
    if (err != cudaSuccess) return err;
    const int bh = B * H;
    const int blocks = (bh + PACKED_WARPS - 1) / PACKED_WARPS;
    attention_packed_kernel<T, d><<<blocks, PACKED_WARPS * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), bh, H, N, sb, sh, sn,
        scale);
    return cudaGetLastError();
  });
}

extern "C" int mp_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int dtype, int B, int H, int N, int D, long long sb,
    long long sh, long long sn, long long ob, long long oh, long long on,
    long long gb, long long gh, long long gn, float scale, int device,
    void* stream) {
  if (N < 1 || N > PACKED_MAX_N) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    const size_t smem =
        sizeof(float) * PACKED_WARPS * packed_bwd_warp_floats<d>(N);
    cudaError_t err = allow_smem(attention_packed_bwd_kernel<T, d>, smem);
    if (err != cudaSuccess) return err;
    const int bh = B * H;
    const int blocks = (bh + PACKED_WARPS - 1) / PACKED_WARPS;
    attention_packed_bwd_kernel<T, d><<<blocks, PACKED_WARPS * 32, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), bh, H,
        N, sb, sh, sn, ob, oh, on, gb, gh, gn, scale);
    return cudaGetLastError();
  });
}
