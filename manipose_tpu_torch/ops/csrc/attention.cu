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
// The per-window kernels K3/K4 take a second batch extent L and its strides
// (sl, ol, gl) as well: the joint-major trunk's spatial windows are
// (b, l, h) views of a (B, J, L, 3, H, D) qkv projection, whose J rows sit a
// frame's qkv row (L * 3 * H * D elements) apart, and whose output and
// gradient are written in place in the (B, J, L, H, D) and (B, J, L, 3, H,
// D) layouts, with no transposing copy on either side.
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
// such tensors, at ~0.28 ms; padded to its tiles (32 queries, 24 keys)
// fp32 K4 still runs ~46 GFLOP of tf32 mma, ~0.14 ms at mma.sync's peak.
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
// m16n8k16 as they lie (FlashAttention-2's register reuse), each value in
// two bf16 parts (AccMma below), so that P and dS keep fp32 accuracy as
// the TPU kernel's do. tf32's
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
// P = exp(scale * S - lse) and use delta = rowsum(dP * P), the TPU
// kernel's (pallas_attention.py:75). The dQ pass takes a block of 64
// queries (Q and dO in shared memory), writes their delta, and streams K
// and V: S = Q K^T, dP = dO V^T, dS = P * (dP - delta), dQ += dS K. In
// fp32 delta is rowsum(dO * O), equal to rowsum(dP * P) at fp32 accuracy
// since K1 stored O in fp32. In bf16 O was rounded to bf16, which cost
// dQ 1.5-4.6 % of its error against fp64 over the plain version's, so
// the dQ pass first sweeps the key tiles once for P and dP alone and sums
// P * dP in fp32, two more products a key tile. The
// dK/dV pass takes a block of 64 keys (K and V in shared memory) and
// streams Q, dO and each query's lse and delta; it computes the transposed
// scores S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the
// accumulator layout with one row per key, and dV += P^T dO and
// dK += dS^T Q need no transpose through shared memory. K and V (or Q and
// dO) stay in shared memory rather than registers, where their split
// fragments would not fit beside the dK and dV sums.
//
// Packed design (K3, K4). The TPU packs G tiny windows into one
// block-diagonal (G*N)^2 tile to fill its 128 x 128 matrix unit; the mma
// tiles here are small enough that one warp takes one window, and nothing
// is masked but the keys past N. What each point of the design chose:
// - Copies in flight. The grid is persistent: as many blocks as the SMs
//   hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//   warp walking windows w, w + (grid warps), ... through a cp.async ring
//   of its own (only __syncwarp, no block barrier). Inputs stay in their
//   own type at the dense kernels' row stride. The ring holds SLOTS
//   windows: two (the next window's rows load while this one computes),
//   but one at fp32 d = 64, where K4 bounds the warps an SM by shared
//   memory and a second slot halves them; measured, more warps hide the
//   copies better than a second slot does (run_probes packed).
// - Padding without storage. Query rows fill one or two 16-row tiles and
//   keys 8-key tiles (24 at N = 17, 16 at N = 16), but a slot holds only
//   the N rows copied: fragment loads of rows at or past N read the
//   block's zero row instead, so padded queries score 0, padded keys are
//   set to -inf before the softmax and padded rows of V, K, dO and Q
//   weigh in as zeros.
// - Every lane on the tensor cores, as K1/K2: bf16 in one m16n8k16 pass,
//   fp32 as 3xTF32. Every reduction is at most 64 long (d or N), so each
//   product runs from one fresh accumulator. The softmax takes row max and
//   sum over the quad of lanes; P (and dS) feed P V (dS K) from registers
//   with K1's k permutation.
// - K4's transposed products. dV = P^T dO and dK = scale dS^T Q take P^T
//   and dS^T from a scratch of the warp's shared memory, written
//   transposed from the fragments (fp32 with each 8-query group permuted
//   to the k order load_b_staged_rows reads; bf16 in AccMma's two parts,
//   P^T's and then dS^T's in the same words) and read with ldmatrix.
//   Recomputing the transposed scores, as K2 does, saves the scratch but
//   measured 1.7x (bf16) to 2.6x (fp32) slower at the flagship's
//   rotations shape (run_probes packed, recompute).
// - Outputs leave from the fragments, each lane two adjacent elements of
//   a row, rows below N only.
// - One warp owns every output of a window and sums it in a fixed order:
//   no atomics, and repeated runs agree bit for bit.
//
// Not yet: wgmma and TMA with warp specialisation.

#include <atomic>
#include <climits>
#include <cmath>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int PACKED_MAX_N = 32;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
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

// The tensor-core operands of a product whose A operand is an fp32
// accumulator: P or dS, or their transposes (P V, dS K, P^T dO, dS^T Q).
// fp32 takes 3xTF32, as every product. bf16 keeps P and dS at fp32
// accuracy, as pallas_attention.py:52-53, 67-79 and 162-163, 181-194 keep
// probs and ds in fp32: each value x goes in as two bf16 parts, hi =
// bf16(x) and lo = bf16(x - hi) (x - hi is exact in fp32), which together
// carry 16 significant bits, and the two run as two passes against the
// one B fragment (V, K, dO or Q, exact in bf16 already) into the same
// fp32 accumulator. One bf16 part adds 30-45 % to the kernels' error
// against fp64 over the plain version's (run_probes bf16, on an H100).
template <typename T>
struct AccMma : mp::Mma<T> {};

template <>
struct AccMma<__nv_bfloat16> {
  static constexpr int PARTS = 2;
  // B as loaded; both passes read the same words
  template <int N>
  __device__ __forceinline__ static void split(const uint32_t (&w)[N],
                                               uint32_t (&p)[PARTS][N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[0][i] = p[1][i] = w[i];
  }
  static constexpr int PASSES = 2;
  __device__ __forceinline__ static void mma(float (&c)[4], const uint32_t (&a)[PARTS][4],
                                             const uint32_t (&b)[PARTS][2], int pass) {
    mp::mma_bf16(c, a[pass], b[0]);
  }
};

// x and y as a bf16 pair (x low), and what rounding left of each, as
// another pair.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A fragment (all parts) of k-step j of a product whose k runs over the
// 8 * NT columns of the accumulator c (16 rows: P, dS or their transposes):
// bf16 packs tiles 2j and 2j + 1 as they lie, in two parts; fp32 takes
// tile j with its k-index permuted (t <-> column 2t, t + 4 <-> column
// 2t + 1).
template <typename T, int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[AccMma<T>::PARTS][4],
                                         const float (&c)[NT][4], int j) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t w[4] = {__float_as_uint(c[j][0]), __float_as_uint(c[j][2]),
                           __float_as_uint(c[j][1]), __float_as_uint(c[j][3])};
    mp::Mma<float>::split(w, a);
  } else {
    split_bf16(c[2 * j][0], c[2 * j][1], a[0][0], a[1][0]);
    split_bf16(c[2 * j][2], c[2 * j][3], a[0][1], a[1][1]);
    split_bf16(c[2 * j + 1][0], c[2 * j + 1][1], a[0][2], a[1][2]);
    split_bf16(c[2 * j + 1][2], c[2 * j + 1][3], a[0][3], a[1][3]);
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

// acc[mi][ni] += A(mi) B(ni) over one k-step for every mi and ni < nt,
// every pass of the operand scheme M (mp::Mma<T> or AccMma<T>); A split
// already, ``load_b(ni, w)`` fetches B(ni)'s raw words. The passes run one
// after the other over all tiles, so consecutive mma are independent.
template <typename M, int MT, int NT, typename LB>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4],
                                          const uint32_t (&a)[MT][M::PARTS][4],
                                          int nt, LB load_b) {
  uint32_t b[NT][M::PARTS][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    if (ni < nt) {
      uint32_t w[2];
      load_b(ni, w);
      M::split(w, b[ni]);
    }
  }
#pragma unroll
  for (int pass = 0; pass < M::PASSES; ++pass)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      if (ni < nt) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) M::mma(acc[mi][ni], a[mi], b[ni], pass);
      }
}

// The same for one row tile and all NT column tiles.
template <typename M, int NT, typename LB>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const uint32_t (&a)[M::PARTS][4],
                                        LB load_b) {
  mma_tiles<M>(reinterpret_cast<float (&)[1][NT][4]>(acc),
               reinterpret_cast<const uint32_t (&)[1][M::PARTS][4]>(a), NT, load_b);
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
      mma_row<mp::Mma<T>>(sc, qa[kk], [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, ks, G::LD, 8 * ni, 8 * kk);
      });
    }
    float corr[2];
    online_softmax(sc, m, l, corr, c, N - s * TROWS);
    float pv[G::NO][4];  // P V over this tile's 64 keys
    zero_acc(pv);
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[AccMma<T>::PARTS][4];
      acc_to_a<T>(a, sc, j);
      mma_row<AccMma<T>>(pv, a, [&](int ni, uint32_t (&w)[2]) {
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
// (K, V) tiles, then the queries' delta (fp32; bf16 keeps it in
// registers). dQ = scale * sum_j dS_ij k_j.
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
  // bf16 sweeps the key tiles twice (delta, then dQ): stage s of the
  // ring's schedule holds key tile s % tiles
  constexpr bool DELTA_SWEEP = !std::is_same<T, float>::value;
  constexpr int SWEEPS = DELTA_SWEEP ? 2 : 1;
  auto ring = mp::start_ring<DSTAGES, 2 * G::TILE>(tiles_smem + 2 * G::OWN, [&](int s) {
    if (s < SWEEPS * tiles) {
      uint32_t* slot = tiles_smem + 2 * G::OWN + (s % DSTAGES) * 2 * G::TILE;
      const int r0 = (s % tiles) * TROWS;
      const long long off = base + static_cast<long long>(r0) * sn;
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot, G::LD, k + off, pitch, N - r0);
      mp::copy_tile<TROWS, G::DW, G::THREADS>(slot + G::TILE, G::LD, v + off, pitch, N - r0);
    }
    mp::cp_async_commit();
  });

  if constexpr (!DELTA_SWEEP) {  // delta = rowsum(dO * O), two threads a row
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
  const float c = scale * LOG2E;
  // P = exp2(c S - lse) (keys at or past kn at 0) and dP = dO V^T of the
  // warp's 16 query rows against one 64-key tile
  auto p_and_dp = [&](const uint32_t* ks, const uint32_t* vs, int kn, float (&sc)[8][4],
                      float (&dp)[8][4]) {
    zero_acc(sc);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, qs, G::LD, row0, 8 * kk);
      mma_row<mp::Mma<T>>(sc, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, ks, G::LD, 8 * ni, 8 * kk);
      });
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[ni][e] = 8 * ni + 2 * t + (e & 1) < kn
                        ? exp2f(fmaf(sc[ni][e], c, -lr[e >> 1]))
                        : 0.f;
      }
    zero_acc(dp);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[G::PARTS][4];
      load_a_split<T>(a, gs, G::LD, row0, 8 * kk);
      mma_row<mp::Mma<T>>(dp, a, [&](int ni, uint32_t (&w)[2]) {
        mp::load_b_nat(w, vs, G::LD, 8 * ni, 8 * kk);
      });
    }
  };
  if constexpr (DELTA_SWEEP) {  // delta = rowsum(dP * P) in fp32
    dr[0] = dr[1] = 0.f;
#pragma unroll 1
    for (int s = 0; s < tiles; ++s) {
      const uint32_t* ks = ring.next();
      float sc[8][4], dp[8][4];
      p_and_dp(ks, ks + G::TILE, N - s * TROWS, sc, dp);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) dr[e >> 1] = fmaf(sc[ni][e], dp[ni][e], dr[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the quad's lanes hold the row's other keys
      dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 1);
      dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 2);
      const int row = q0 + row0 + g + 8 * r;
      if (t == 0 && row < N) delta[static_cast<long long>(bh) * N + row] = dr[r];
    }
  }
  float acc[G::NO][4];
  zero_acc(acc);
#pragma unroll 1
  for (int s = 0; s < tiles; ++s) {
    const uint32_t* ks = ring.next();
    const uint32_t* vs = ks + G::TILE;
    if (!DELTA_SWEEP && s == 0) {  // delta is in shared memory now
      dr[0] = dls[row0 + g];
      dr[1] = dls[row0 + g + 8];
    }
    float sc[8][4], dp[8][4];  // P, and dP, then dS = P * (dP - delta)
    p_and_dp(ks, vs, N - s * TROWS, sc, dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[ni][e] = sc[ni][e] * (dp[ni][e] - dr[e >> 1]);
    float part[G::NO][4];  // dS K over this tile's 64 keys
    zero_acc(part);
#pragma unroll
    for (int j = 0; j < TROWS / G::KK; ++j) {
      uint32_t a[AccMma<T>::PARTS][4];
      acc_to_a<T>(a, dp, j);
      mma_row<AccMma<T>>(part, a, [&](int ni, uint32_t (&w)[2]) {
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
      mma_row<mp::Mma<T>>(st, a, [&](int ni, uint32_t (&w)[2]) {
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
      uint32_t a[AccMma<T>::PARTS][4];
      acc_to_a<T>(a, st, j);
      mma_row<AccMma<T>>(part, a, [&](int ni, uint32_t (&w)[2]) {
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
      mma_row<mp::Mma<T>>(dpt, a, [&](int ni, uint32_t (&w)[2]) {
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
      uint32_t a[AccMma<T>::PARTS][4];
      acc_to_a<T>(a, dpt, j);
      mma_row<AccMma<T>>(part, a, [&](int ni, uint32_t (&w)[2]) {
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

// ---- per-window kernels (K3, K4; N <= 32) on the tensor cores -------------

// Geometry of the per-window kernels for element type T and head dim D:
// rows staged at the dense kernels' stride, a block of WARPS warps, each
// walking windows of its own through a ring of SLOTS windows.
template <typename T, int D>
struct Packed {
  static constexpr int EW = Dense<T, D>::EW;
  static constexpr int DW = Dense<T, D>::DW;
  static constexpr int KS = Dense<T, D>::KS;
  static constexpr int LD = Dense<T, D>::LD;
  static constexpr int NO = Dense<T, D>::NO;
  static constexpr int KK = Dense<T, D>::KK;
  static constexpr int PAD = 8 * KS - DW;  // words past a row, zeroed once
  static constexpr int PARTS = mp::Mma<T>::PARTS;
  static constexpr int WARPS = 4;  // a block's warps (fewer where they do not fit)
  // Windows a warp stages: the one computed and SLOTS - 1 in flight. At
  // fp32 d = 64 a second slot costs K4 half its warps an SM (4 of 8) and
  // measured slower (probes/run_probes.py packed, slots1 and slots2);
  // elsewhere the two measured alike.
  static constexpr int SLOTS = std::is_same<T, float>::value && D == 64 ? 1 : 2;
};

// Row stride, in words, of K4's P^T and dS^T (16 * MT query columns of T).
template <typename T>
__host__ __device__ constexpr int transposed_ld(int mt) {
  return 16 * mt / (4 / int(sizeof(T))) + 4;
}

// Words of one warp's shared memory: its ring of SLOTS windows of ``tensors``
// staged tensors (n rows each), then, for K4, P^T and dS^T (fp32) or the
// two bf16 parts of one of them.
template <typename T, int D>
__host__ __device__ constexpr int packed_warp_words(int n, int tensors, bool transposes) {
  return Packed<T, D>::SLOTS * tensors * n * Packed<T, D>::LD +
         (transposes ? 2 * 16 * ((n + 15) / 16) * transposed_ld<T>((n + 15) / 16) : 0);
}

// Row r of a staged tensor (n rows, ld words apart), or the zero row for a
// row at or past n: rows past the window are read as zeros without being
// stored or copied.
__device__ __forceinline__ const uint32_t* staged_row(const uint32_t* s, int r, int n, int ld,
                                                      const uint32_t* zero) {
  return r < n ? s + r * ld : zero;
}

// A fragment (all parts) of rows row0.. row0 + 15, words kw.. kw + 7, of a
// staged tensor.
template <typename T>
__device__ __forceinline__ void load_a_staged(uint32_t (&a)[mp::Mma<T>::PARTS][4],
                                              const uint32_t* s, int n, int ld,
                                              const uint32_t* zero, int row0, int kw) {
  const int l = threadIdx.x & 31, j = l >> 3;
  uint32_t w[4];
  mp::ldsm_x4(w, staged_row(s, row0 + (j & 1) * 8 + (l & 7), n, ld, zero) + kw + (j >> 1) * 4);
  mp::Mma<T>::split(w, a);
}

// B fragment (raw words) of a product over d: rows n0.. n0 + 7 of a staged
// tensor as the columns, words kw.. kw + 7 (K in Q K^T, V in dO V^T).
__device__ __forceinline__ void load_b_staged(uint32_t (&w)[2], const uint32_t* s, int n,
                                              int ld, const uint32_t* zero, int n0, int kw) {
  const int l = threadIdx.x & 15;  // lanes 16..31 repeat 0..15's addresses
  mp::ldsm_x2(w, staged_row(s, n0 + (l & 7), n, ld, zero) + kw + (l >> 3) * 4);
}

// B fragment (raw words) of a product over rows: columns n0.. n0 + 7 of the
// k-step at row k0 of a staged tensor (V in P V, K in dS K, dO in P^T dO, Q
// in dS^T Q). fp32 reads rows in acc_to_a's k permutation (t from row 2t,
// t + 4 from 2t + 1), bf16 takes ldmatrix.trans, as load_b_rows does.
template <typename T>
__device__ __forceinline__ void load_b_staged_rows(uint32_t (&w)[2], const uint32_t* s, int n,
                                                   int ld, const uint32_t* zero, int n0,
                                                   int k0) {
  if constexpr (std::is_same<T, float>::value) {
    const int r = k0 + 2 * mp::lane_t(), c = n0 + mp::lane_g();
    w[0] = staged_row(s, r, n, ld, zero)[c];
    w[1] = staged_row(s, r + 1, n, ld, zero)[c];
  } else {
    const int l = threadIdx.x & 15;
    mp::ldsm_x2_trans(w, reinterpret_cast<const __nv_bfloat16*>(
                             staged_row(s, k0 + l, n, ld, zero)) + n0);
  }
}

// The scores of a window (rows g and g + 8 of each row tile in e = 0, 1
// and e = 2, 3; keys at or past n masked) to P = exp2(c * S - max),
// unnormalised; l gets each row's sum over the quad of lanes.
template <int MT, int NT>
__device__ __forceinline__ void window_softmax(float (&s)[MT][NT][4], float (&l)[MT][2],
                                               float c, int n) {
  const int t = mp::lane_t();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] = 8 * ni + 2 * t + (e & 1) < n ? s[mi][ni][e] * c : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[mi][ni][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // key 0 is valid, so the max is finite
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l[mi][r] = 0.f;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] = exp2f(s[mi][ni][e] - mx[e >> 1]);
        l[mi][e >> 1] += s[mi][ni][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 1);
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 2);
    }
  }
}

// acc (rows of a window, D columns) times scale, as T, to rows [0, n) of
// ``dst`` (``pitch`` elements apart), straight from the fragments.
template <typename T, int MT, int NO>
__device__ __forceinline__ void store_rows(T* dst, long long pitch, const float (&acc)[MT][NO][4],
                                           const float (&scale)[MT][2], int n) {
  const int g = mp::lane_g(), t = mp::lane_t();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * mi + g + 8 * r;
      if (row < n) {
        T* p = dst + row * pitch + 2 * t;
#pragma unroll
        for (int no = 0; no < NO; ++no) {
          mp::store2(p + 8 * no, acc[mi][no][2 * r] * scale[mi][r],
                     acc[mi][no][2 * r + 1] * scale[mi][r]);
        }
      }
    }
}

// Copies window w's rows [0, n) of ``tensors`` tensors (src[i] + the
// window's offset; rows ``pitch[i]`` bytes apart) to a warp's slot, one
// tensor after the other at LD words a row, 16 bytes a lane at a time.
template <typename T, int D, int TENSORS>
__device__ __forceinline__ void stage_window(uint32_t* slot, const T* const (&src)[TENSORS],
                                             const long long (&off)[TENSORS],
                                             const long long (&pitch)[TENSORS], int n) {
  using P = Packed<T, D>;
  constexpr int CH = P::DW / 4;  // 16-byte chunks of a row
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int e = lane; e < n * CH; e += 32) {
    const int r = e / CH, c = e % CH;
#pragma unroll
    for (int i = 0; i < TENSORS; ++i) {
      const char* s = reinterpret_cast<const char*>(src[i] + off[i]);
      mp::cp_async16(slot + (i * n + r) * P::LD + 4 * c, s + r * pitch[i] + 16 * c, true);
    }
  }
}

// Zeroes the block's zero row and the pad words of the warp's ring (rows
// of bf16 at D = 8, whose k-step is 16 elements); the copies never write
// either.
template <typename T, int D>
__device__ __forceinline__ void packed_prologue(uint32_t* zero, uint32_t* ring, int rows) {
  using P = Packed<T, D>;
  for (int i = threadIdx.x; i < P::LD; i += blockDim.x) zero[i] = 0u;
  if constexpr (P::PAD > 0) {
    for (int e = threadIdx.x & 31; e < rows * P::PAD; e += 32) {
      ring[(e / P::PAD) * P::LD + P::DW + e % P::PAD] = 0u;
    }
  }
  __syncthreads();
}

// The start of window w = (b, l, h) = (w / (H L), (w / H) % L, w % H) in a
// tensor of batch strides (sb, sl, sh), in elements.
__device__ __forceinline__ long long window_offset(int w, int L, int H, long long sb,
                                                   long long sl, long long sh) {
  const int bl = w / H;
  return static_cast<long long>(bl / L) * sb + static_cast<long long>(bl % L) * sl +
         static_cast<long long>(w % H) * sh;
}

// A warp's walk over windows first, first + stride, ... below ``count``
// (stride = the grid's warps; blocks of blockDim.x / 32 warps) through its
// ring of SLOTS slots:
// ``stage(w, slot)`` copies window w into a slot (nothing when w >= count)
// and commits a group; ``compute(w, slot)`` runs once the window landed,
// while the next SLOTS - 1 windows' copies are in flight.
template <int SLOTS, typename Stage, typename Compute>
__device__ __forceinline__ void packed_walk(int count, Stage stage, Compute compute) {
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) stage(first + s * stride, s);
#pragma unroll 1
  for (int i = 0, w = first; w < count; ++i, w += stride) {
    stage(w + (SLOTS - 1) * stride, (i + SLOTS - 1) % SLOTS);
    mp::cp_async_wait<SLOTS - 1>();
    __syncwarp();  // every lane's copies of window w have landed
    compute(w, i % SLOTS);
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  mp::cp_async_wait<0>();
}

// K3 on one staged window: S = Q K^T over MT row tiles and the key tiles
// below n, the softmax on the fragments, P V from registers, o / l.
template <typename T, int D, int MT>
__device__ __forceinline__ void packed_fwd_window(const uint32_t* qs, const uint32_t* ks,
                                                  const uint32_t* vs, const uint32_t* zero,
                                                  T* out, long long pitch, int n, float c) {
  using P = Packed<T, D>;
  constexpr int NT = 2 * MT;  // 8-key tiles
  const int nt = (n + 7) >> 3;
  float s[MT][NT][4];
  mp::zero(s);
#pragma unroll
  for (int kk = 0; kk < P::KS; ++kk) {
    uint32_t a[MT][P::PARTS][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], qs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(s, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, ks, n, P::LD, zero, 8 * ni, 8 * kk);
    });
  }
  float l[MT][2];
  window_softmax(s, l, c, n);
  float o[MT][P::NO][4];  // P V: keys past n have P = 0 and read V as zeros
  mp::zero(o);
  const int steps = (8 * nt + P::KK - 1) / P::KK;
#pragma unroll
  for (int j = 0; j < 8 * NT / P::KK; ++j) {
    if (j < steps) {
      uint32_t a[MT][AccMma<T>::PARTS][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) acc_to_a<T>(a[mi], s[mi], j);
      mma_tiles<AccMma<T>>(o, a, P::NO, [&](int no, uint32_t (&w)[2]) {
        load_b_staged_rows<T>(w, vs, n, P::LD, zero, 8 * no, P::KK * j);
      });
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) l[mi][r] = 1.f / l[mi][r];
  store_rows(out, pitch, o, l, n);
}

// K3: each warp walks windows through its ring. Shared memory: the zero
// row, then per warp SLOTS slots of (Q, K, V). Window w is (b, l, h) =
// (w / (H L), (w / H) % L, w % H): its rows start at b sb + l sl + h sh in
// Q, K and V and at b ob + l ol + h oh in the output, sn and on elements
// apart. The fold layout passes L = 1; joint-major passes the frames as L,
// so its windows' rows (the joints) sit a frame's whole qkv row apart.
template <typename T, int D, int MT>
__global__ void __launch_bounds__(32 * Packed<T, D>::WARPS)
attention_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int BH,
                        int L, int H, int N, long long sb, long long sl, long long sh,
                        long long sn, long long ob, long long ol, long long oh,
                        long long on, float scale) {
  using P = Packed<T, D>;
  extern __shared__ __align__(16) uint32_t packed_smem_words[];
  const uint32_t* zero = packed_smem_words;
  uint32_t* ring = packed_smem_words + P::LD +
                   (threadIdx.x >> 5) * packed_warp_words<T, D>(N, 3, false);
  const int tw = N * P::LD;  // words of a staged tensor
  packed_prologue<T, D>(packed_smem_words, ring, P::SLOTS * 3 * N);
  const T* const src[3] = {q, k, v};
  const long long pitch = sn * static_cast<long long>(sizeof(T));
  const long long pitches[3] = {pitch, pitch, pitch};
  packed_walk<P::SLOTS>(
      BH,
      [&](int w, int slot) {
        if (w < BH) {
          const long long off = window_offset(w, L, H, sb, sl, sh);
          const long long offs[3] = {off, off, off};
          stage_window<T, D, 3>(ring + slot * 3 * tw, src, offs, pitches, N);
        }
        mp::cp_async_commit();
      },
      [&](int w, int slot) {
        const uint32_t* s = ring + slot * 3 * tw;
        packed_fwd_window<T, D, MT>(s, s + tw, s + 2 * tw, zero,
                                    out + window_offset(w, L, H, ob, ol, oh), on, N,
                                    scale * LOG2E);
      });
}

// x (rows = queries, columns = keys, 16 * MT of each) as x^T ([key][query],
// ``ld`` words a row) in T: K4's A operands of dV = P^T dO and
// dK = dS^T Q. fp32 permutes each 8-query group (query 2i to word i,
// 2i + 1 to word i + 4), so that ldmatrix hands the A fragment the k order
// in which load_b_staged_rows reads dO and Q. bf16 stores AccMma's two
// parts: hi at ``dst``, lo in the 16 * MT rows after it.
template <typename T, int MT, int NT>
__device__ __forceinline__ void store_transposed(uint32_t* dst, int ld,
                                                 const float (&x)[MT][NT][4]) {
  const int g = mp::lane_g(), t = mp::lane_t();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * ni + 2 * t + (e & 1);
        const int q0 = 16 * mi + 8 * (e >> 1);  // the query's 8-group
        if constexpr (std::is_same<T, float>::value) {
          reinterpret_cast<float*>(dst)[key * ld + q0 + (g & 1) * 4 + (g >> 1)] = x[mi][ni][e];
        } else {
          const __nv_bfloat16 hi = __float2bfloat16_rn(x[mi][ni][e]);
          __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(dst) + key * 2 * ld + q0 + g;
          p[0] = hi;
          p[16 * MT * 2 * ld] = __float2bfloat16_rn(x[mi][ni][e] - __bfloat162float(hi));
        }
      }
}

// acc = A B^T-style product of K4's second half: rows = keys (MT tiles of
// x^T from the warp's scratch, as store_transposed wrote it), k = the
// queries below n, B = rows of a staged tensor (dO or Q).
template <typename T, int D, int MT>
__device__ __forceinline__ void transposed_product(float (&acc)[MT][Packed<T, D>::NO][4],
                                                   const uint32_t* xt, int xld,
                                                   const uint32_t* bs, const uint32_t* zero,
                                                   int n) {
  using P = Packed<T, D>;
  mp::zero(acc);
  const int steps = (n + P::KK - 1) / P::KK;
#pragma unroll
  for (int j = 0; j < 16 * MT / P::KK; ++j) {
    if (j < steps) {
      uint32_t a[MT][AccMma<T>::PARTS][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (std::is_same<T, float>::value) {
          uint32_t w[4];
          mp::load_a_nat(w, xt, xld, 16 * mi, 8 * j);
          mp::Mma<T>::split(w, a[mi]);
        } else {
          mp::load_a_nat(a[mi][0], xt, xld, 16 * mi, 8 * j);
          mp::load_a_nat(a[mi][1], xt + 16 * MT * xld, xld, 16 * mi, 8 * j);
        }
      }
      mma_tiles<AccMma<T>>(acc, a, P::NO, [&](int no, uint32_t (&w)[2]) {
        load_b_staged_rows<T>(w, bs, n, P::LD, zero, 8 * no, P::KK * j);
      });
    }
  }
}

// K4 on one staged window (Q, K, V, dO): S = Q K^T and dP = dO V^T, the
// softmax P, delta = rowsum(dP * P) and dS = P (dP - delta) on the
// fragments; dQ = scale dS K from registers; P^T and dS^T through the
// warp's scratch for dV = P^T dO and dK = scale dS^T Q. fp32 stages both
// at once; bf16 stages P^T's two parts, then dS^T's in the same words.
template <typename T, int D, int MT>
__device__ __forceinline__ void packed_bwd_window(const uint32_t* qs, const uint32_t* ks,
                                                  const uint32_t* vs, const uint32_t* gs,
                                                  uint32_t* xt, const uint32_t* zero,
                                                  T* dq, T* dk, T* dv, long long pitch,
                                                  int n, float scale) {
  using P = Packed<T, D>;
  constexpr int NT = 2 * MT;
  const int nt = (n + 7) >> 3;
  float s[MT][NT][4], dp[MT][NT][4];
  mp::zero(s);
  mp::zero(dp);
#pragma unroll
  for (int kk = 0; kk < P::KS; ++kk) {
    uint32_t a[MT][P::PARTS][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], qs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(s, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, ks, n, P::LD, zero, 8 * ni, 8 * kk);
    });
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], gs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(dp, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, vs, n, P::LD, zero, 8 * ni, 8 * kk);
    });
  }
  float l[MT][2];
  window_softmax(s, l, scale * LOG2E, n);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float inv[2] = {1.f / l[mi][0], 1.f / l[mi][1]}, delta[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] *= inv[e >> 1];
        delta[e >> 1] = fmaf(s[mi][ni][e], dp[mi][ni][e], delta[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[mi][ni][e] = s[mi][ni][e] * (dp[mi][ni][e] - delta[e >> 1]);
      }
  }
  constexpr bool fp32 = std::is_same<T, float>::value;
  const int xld = transposed_ld<T>(MT);
  uint32_t* dst = fp32 ? xt + 16 * MT * xld : xt;  // where dS^T goes
  store_transposed<T>(xt, xld, s);
  if constexpr (fp32) store_transposed<T>(dst, xld, dp);
  float scaled[MT][2], one[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) scaled[mi][r] = scale, one[mi][r] = 1.f;
  float acc[MT][P::NO][4];
  {  // dQ = scale dS K: keys past n have dS = 0 and read K as zeros
    mp::zero(acc);
    const int steps = (8 * nt + P::KK - 1) / P::KK;
#pragma unroll
    for (int j = 0; j < 8 * NT / P::KK; ++j) {
      if (j < steps) {
        uint32_t a[MT][AccMma<T>::PARTS][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) acc_to_a<T>(a[mi], dp[mi], j);
        mma_tiles<AccMma<T>>(acc, a, P::NO, [&](int no, uint32_t (&w)[2]) {
          load_b_staged_rows<T>(w, ks, n, P::LD, zero, 8 * no, P::KK * j);
        });
      }
    }
    store_rows(dq, pitch, acc, scaled, n);
  }
  __syncwarp();  // P^T (and in fp32 dS^T) are in the scratch
  transposed_product<T, D, MT>(acc, xt, xld, gs, zero, n);
  store_rows(dv, pitch, acc, one, n);
  if constexpr (!fp32) {
    __syncwarp();  // every lane is done with P^T
    store_transposed<T>(dst, xld, dp);
    __syncwarp();
  }
  transposed_product<T, D, MT>(acc, dst, xld, qs, zero, n);
  store_rows(dk, pitch, acc, scaled, n);
}

// K4: each warp walks windows through its ring. Shared memory: the zero
// row, then per warp SLOTS slots of (Q, K, V, dO) and the P^T, dS^T
// scratch. Windows as K3's: Q, K and V at (sb, sl, sh, sn), dO at (ob, ol,
// oh, on), dQ, dK and dV at (gb, gl, gh, gn), so that joint-major writes
// its gradient straight into the (B, J, L, 3, H, D) layout of qkv.
template <typename T, int D, int MT>
__global__ void __launch_bounds__(32 * Packed<T, D>::WARPS)
attention_packed_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int BH, int L, int H, int N, long long sb, long long sl,
    long long sh, long long sn, long long ob, long long ol, long long oh, long long on,
    long long gb, long long gl, long long gh, long long gn, float scale) {
  using P = Packed<T, D>;
  extern __shared__ __align__(16) uint32_t packed_smem_words[];
  const uint32_t* zero = packed_smem_words;
  uint32_t* ring = packed_smem_words + P::LD +
                   (threadIdx.x >> 5) * packed_warp_words<T, D>(N, 4, true);
  uint32_t* xt = ring + P::SLOTS * 4 * N * P::LD;
  const int tw = N * P::LD;
  packed_prologue<T, D>(packed_smem_words, ring, P::SLOTS * 4 * N);
  const T* const src[4] = {q, k, v, dout};
  const long long pitch = sn * static_cast<long long>(sizeof(T));
  const long long pitches[4] = {pitch, pitch, pitch, on * static_cast<long long>(sizeof(T))};
  packed_walk<P::SLOTS>(
      BH,
      [&](int w, int slot) {
        if (w < BH) {
          const long long off = window_offset(w, L, H, sb, sl, sh);
          const long long offs[4] = {off, off, off, window_offset(w, L, H, ob, ol, oh)};
          stage_window<T, D, 4>(ring + slot * 4 * tw, src, offs, pitches, N);
        }
        mp::cp_async_commit();
      },
      [&](int w, int slot) {
        const uint32_t* s = ring + slot * 4 * tw;
        const long long g = window_offset(w, L, H, gb, gl, gh);
        packed_bwd_window<T, D, MT>(s, s + tw, s + 2 * tw, s + 3 * tw, xt, zero, dq + g,
                                    dk + g, dv + g, gn, N, scale);
      });
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

using mp::allow_smem;

// Calls f(std::integral_constant<int, MT>{}) for the row tiles of a window
// of n rows (MT = 1 up to 16 rows, 2 up to 32).
template <typename F>
cudaError_t with_row_tiles(int n, F f) {
  if (n <= 16) return f(std::integral_constant<int, 1>{});
  return f(std::integral_constant<int, 2>{});
}

// A per-window kernel's launch shape at one N on one device, worked out
// at its first launch: warps a block, blocks an SM, SMs, shared bytes.
struct PackedLaunch {
  std::atomic<bool> ready{false};
  int warps = 0, per_sm = 0, sms = 0;
  size_t smem = 0;
};

// K3's or K4's launch shape for ``windows`` windows of n rows: WARPS warps
// a block, or as many as a block's shared memory holds; as many blocks as
// the SMs hold at once, fewer when the windows run out. The occupancy and
// attribute queries run once per kernel, device and n: they cost each
// launch host time that these short kernels would otherwise wait for.
template <typename T, int D, int MT>
cudaError_t packed_shape(bool bwd, int n, int windows, int device, int* warps, size_t* smem,
                         int* blocks, int* per_sm) {
  using P = Packed<T, D>;
  constexpr int DEVICES = 16;
  static PackedLaunch known[2][DEVICES][PACKED_MAX_N + 1];
  static std::mutex lock;
  PackedLaunch uncached;
  PackedLaunch& shape = device >= 0 && device < DEVICES ? known[bwd][device][n] : uncached;
  if (!shape.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> guard(lock);
    if (!shape.ready.load(std::memory_order_relaxed)) {
      int optin = 0, sms = 0, fit_sm = 0;
      cudaError_t err =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      }
      if (err != cudaSuccess) return err;
      const int per_warp = 4 * packed_warp_words<T, D>(n, bwd ? 4 : 3, bwd);
      const int fit = (optin - 4 * P::LD) / per_warp;
      const int w = fit < P::WARPS ? fit : P::WARPS;
      if (w < 1) return cudaErrorInvalidValue;
      const size_t bytes = 4u * P::LD + static_cast<size_t>(w) * per_warp;
      auto query = [&](auto kernel) {
        cudaError_t e = allow_smem(kernel, static_cast<size_t>(optin));
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit_sm, kernel, 32 * w, bytes);
      };
      err = bwd ? query(attention_packed_bwd_kernel<T, D, MT>)
                : query(attention_packed_kernel<T, D, MT>);
      if (err != cudaSuccess) return err;
      if (fit_sm < 1) return cudaErrorInvalidConfiguration;
      shape.warps = w;
      shape.per_sm = fit_sm;
      shape.sms = sms;
      shape.smem = bytes;
      shape.ready.store(true, std::memory_order_release);
    }
  }
  *warps = shape.warps;
  *smem = shape.smem;
  *per_sm = shape.per_sm;
  const int want = (windows + shape.warps - 1) / shape.warps;
  *blocks = want < shape.sms * shape.per_sm ? want : shape.sms * shape.per_sm;
  return cudaSuccess;
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

// Windows (b, l, h) of B x L x H (L = 1 for the fold layout; see K3).
extern "C" int mp_attention_packed(const void* q, const void* k,
                                   const void* v, void* out, int dtype, int B,
                                   int L, int H, int N, int D, long long sb,
                                   long long sl, long long sh, long long sn,
                                   long long ob, long long ol, long long oh,
                                   long long on, float scale, int device,
                                   void* stream) {
  if (N < 1 || N > PACKED_MAX_N || L < 1) return cudaErrorInvalidValue;
  const long long windows = static_cast<long long>(B) * L * H;
  if (windows < 1 || windows > INT_MAX) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    return with_row_tiles(N, [&](auto tiles) {
      constexpr int mt = decltype(tiles)::value;
      const int bh = static_cast<int>(windows);
      size_t smem = 0;
      int warps = 0, blocks = 0, per_sm = 0;
      cudaError_t err =
          packed_shape<T, d, mt>(false, N, bh, device, &warps, &smem, &blocks, &per_sm);
      if (err != cudaSuccess) return err;
      attention_packed_kernel<T, d, mt><<<blocks, 32 * warps, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), bh, L, H, N, sb, sl, sh, sn,
          ob, ol, oh, on, scale);
      return cudaGetLastError();
    });
  });
}

extern "C" int mp_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int dtype, int B, int L, int H, int N, int D, long long sb,
    long long sl, long long sh, long long sn, long long ob, long long ol, long long oh,
    long long on, long long gb, long long gl, long long gh, long long gn, float scale,
    int device, void* stream) {
  if (N < 1 || N > PACKED_MAX_N || L < 1) return cudaErrorInvalidValue;
  const long long windows = static_cast<long long>(B) * L * H;
  if (windows < 1 || windows > INT_MAX) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    return with_row_tiles(N, [&](auto tiles) {
      constexpr int mt = decltype(tiles)::value;
      const int bh = static_cast<int>(windows);
      size_t smem = 0;
      int warps = 0, blocks = 0, per_sm = 0;
      cudaError_t err =
          packed_shape<T, d, mt>(true, N, bh, device, &warps, &smem, &blocks, &per_sm);
      if (err != cudaSuccess) return err;
      attention_packed_bwd_kernel<T, d, mt><<<blocks, 32 * warps, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), bh, L, H,
          N, sb, sl, sh, sn, ob, ol, oh, on, gb, gl, gh, gn, scale);
      return cudaGetLastError();
    });
  });
}

// The launch shape of K3 (bwd = 0) or K4 (bwd = 1) at a window of N rows:
// shape = {warps a block, slots a warp, blocks an SM, shared bytes a
// block, blocks of a launch over ``windows`` windows}.
extern "C" int mp_attention_packed_shape(int dtype, int D, int N, int bwd, int windows,
                                         int device, int* shape) {
  if (N < 1 || N > PACKED_MAX_N || windows < 1) return cudaErrorInvalidValue;
  return with_types(dtype, D, device, [&](auto tag, auto dim) {
    using T = decltype(tag);
    constexpr int d = decltype(dim)::value;
    return with_row_tiles(N, [&](auto tiles) {
      size_t smem = 0;
      cudaError_t err = packed_shape<T, d, decltype(tiles)::value>(
          bwd != 0, N, windows, device, &shape[0], &smem, &shape[4], &shape[2]);
      shape[1] = Packed<T, d>::SLOTS;
      shape[3] = static_cast<int>(smem);
      return err;
    });
  });
}
