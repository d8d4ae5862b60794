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
// What bounds them on an H100. Dense, at the flagship's rotations trunk
// (2176 windows of 243 x 64): 4*N*N*D flop per window forward, 32.9 GFLOP
// in all against 0.54 GB moved in fp32, so fp32 arithmetic (67 TFLOP/s on
// the CUDA cores) bounds it at ~0.49 ms; the backward recomputes the scores
// and does 10*N*N*D flop per window, ~1.2 ms. Packed (31104 windows of
// 17 x 64): 2.3 GFLOP against 0.54 GB, so memory (3.35 TB/s) bounds it at
// ~0.16 ms, and its backward, which moves seven such tensors, at ~0.28 ms.
//
// What the design does about it. The TPU kernel holds the whole N x N fp32
// score matrix in VMEM; at N = 243 that is 236 KB, more than the 227 KB of
// shared memory a block may use. The dense kernel instead gives every query
// row its own thread, holding q and the output row in registers, and
// streams K and V through shared memory 64 keys at a time with an online
// softmax (running max and sum, rescaled every SUB keys). Each staged key
// row is read by all threads of the block at one address (a broadcast, so
// no bank conflicts), 16 bytes at a time. Two blocks of 128 query rows
// cover N = 243; the ragged edge is masked. No score matrix is ever stored.
// When a gradient is wanted it also writes each row's log-sum-exp.
//
// The dense backward is the two-pass scheme of FlashAttention-2, without
// atomics. Both passes rebuild P = exp(scale * q.k - lse) from the saved
// log-sum-exp and use delta = rowsum(dO * O), which equals the TPU kernel's
// rowsum(dP * P). The dQ pass gives a block 64 query rows and streams all
// keys through shared memory; the dK/dV pass gives a block 64 key rows and
// streams all queries. A row is split over TPR = D / 16 threads (each owns
// 16 of the D columns, interleaved 4 at a time so that the threads of a
// row read neighbouring addresses), which keeps three or four rows of
// state per thread in registers; the two dot products per pair are summed
// across the TPR threads with warp shuffles.
//
// The TPU packs G tiny windows into one block-diagonal (G*N)^2 tile to fill
// its 128 x 128 matrix unit. Here that trick has no use: one warp takes one
// window, each lane one query row, K, V and Q are staged with coalesced
// 16-byte loads, and the output is staged back through shared memory so it
// leaves with coalesced stores. No masking is needed. Four warps per block
// keep enough loads in flight across the 132 SMs for a memory-bound kernel.
// The packed backward stages Q, K, V and dO of its window and works as the
// TPU kernel does: each lane recomputes its row of P and dS in registers
// and leaves them in shared memory; then lane j sums column j for dK and dV
// and lane i row i for dQ, each result written over a staged input that is
// no longer read, and all three leave with coalesced stores.
//
// Simple first: fp32 CUDA-core arithmetic in both dtypes. wgmma / TMA and
// tensor-core bf16 are later work.

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int DENSE_ROWS = 128;  // query rows (threads) per block
constexpr int DENSE_KEYS = 64;   // keys staged in shared memory per step
constexpr int SUB = 8;           // keys scored in registers per rescale
constexpr int BWD_ROWS = 64;     // rows per block of the dense backward
constexpr int BWD_TILE = 64;     // rows staged in shared memory per step
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

template <typename T, int D>
__global__ void __launch_bounds__(DENSE_ROWS)
attention_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int N, long long sb,
                       long long sh, long long sn, float scale) {
  __shared__ __align__(16) float Ks[DENSE_KEYS * D];
  __shared__ __align__(16) float Vs[DENSE_KEYS * D];
  const int tiles = (N + DENSE_ROWS - 1) / DENSE_ROWS;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * DENSE_ROWS + threadIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const bool active = row < N;

  float qr[D], o[D];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 t = active ? mp::load4(q + base + row * sn + 4 * c) : zero4();
    qr[4 * c + 0] = t.x;
    qr[4 * c + 1] = t.y;
    qr[4 * c + 2] = t.z;
    qr[4 * c + 3] = t.w;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) o[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += DENSE_KEYS) {
    const int kn = min(DENSE_KEYS, N - k0);
    __syncthreads();  // the previous step's reads of Ks / Vs are done
    for (int e = threadIdx.x; e < kn * (D / 4); e += DENSE_ROWS) {
      const int j = e / (D / 4), c = e % (D / 4);
      const long long off = base + (k0 + j) * sn + 4 * c;
      mp::store4(Ks + j * D + 4 * c, mp::load4(k + off));
      mp::store4(Vs + j * D + 4 * c, mp::load4(v + off));
    }
    __syncthreads();
    if (active) attend_keys<D>(qr, Ks, Vs, kn, scale, o, m, l);
  }

  if (active) {
    const float inv = 1.f / l;
    T* dst = out + ((static_cast<long long>(b) * N + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      mp::store4(dst + 4 * c,
                 make_float4(o[4 * c] * inv, o[4 * c + 1] * inv,
                             o[4 * c + 2] * inv, o[4 * c + 3] * inv));
    }
    if (lse != nullptr) lse[static_cast<long long>(bh) * N + row] = m + logf(l);
  }
}

// ---- dense backward -------------------------------------------------------
// A row of D columns is held by TPR = D / R neighbouring threads, R columns
// each: thread t of a row owns the float4 chunks t, t + TPR, t + 2*TPR, ...
template <int D>
__host__ __device__ constexpr int row_slice() { return D < 16 ? D : 16; }
template <int D>
__host__ __device__ constexpr int row_threads() { return D / row_slice<D>(); }

// Sum over the TPR neighbouring lanes that hold one row. Every lane of the
// warp takes part (inactive rows run on zeros), so the full mask is right.
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// This thread's chunks of the row at ``src`` (zeros when inactive).
template <int D, typename T>
__device__ __forceinline__ void load_slice(const T* src, int t, bool active,
                                           float4 (&dst)[row_slice<D>() / 4]) {
  constexpr int TPR = row_threads<D>();
#pragma unroll
  for (int c = 0; c < row_slice<D>() / 4; ++c) {
    dst[c] = active ? mp::load4(src + 4 * (c * TPR + t)) : zero4();
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_slice(
    T* dst, int t, const float4 (&src)[row_slice<D>() / 4], float s) {
  constexpr int TPR = row_threads<D>();
#pragma unroll
  for (int c = 0; c < row_slice<D>() / 4; ++c) {
    mp::store4(dst + 4 * (c * TPR + t), scale4(src[c], s));
  }
}

// Stage rows [r0, r0 + rn) of a strided tensor (row stride rs, from
// ``base``) into shared memory with row stride D.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long base, long long rs,
                                           int r0, int rn) {
  for (int e = threadIdx.x; e < rn * (D / 4); e += blockDim.x) {
    const int j = e / (D / 4), c = e % (D / 4);
    mp::store4(dst + j * D + 4 * c,
               mp::load4(src + base + (r0 + j) * rs + 4 * c));
  }
}

// Partial dot product of this thread's chunks with staged row ``r``.
template <int D>
__device__ __forceinline__ float slice_dot(const float4 (&a)[row_slice<D>() / 4],
                                           const float* r, int t) {
  constexpr int TPR = row_threads<D>();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < row_slice<D>() / 4; ++c) {
    s += dot4(a[c], lds4(r + 4 * (c * TPR + t)));
  }
  return s;
}

template <int D>
__device__ __forceinline__ void slice_fma(float w, const float* r, int t,
                                          float4 (&acc)[row_slice<D>() / 4]) {
  constexpr int TPR = row_threads<D>();
#pragma unroll
  for (int c = 0; c < row_slice<D>() / 4; ++c) {
    fma4(w, lds4(r + 4 * (c * TPR + t)), acc[c]);
  }
}

// dQ pass: one block per (window, 64 query rows); every key streams
// through shared memory. Also writes delta = rowsum(dO * O) for the dK/dV
// pass. dQ = scale * sum_j P_ij (dP_ij - delta_i) k_j.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_ROWS * row_threads<D>())
attention_dense_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int H, int N, long long sb, long long sh, long long sn,
    long long ob, long long oh, long long on, long long gb, long long gh,
    long long gn, float scale) {
  constexpr int TPR = row_threads<D>(), C4 = row_slice<D>() / 4;
  __shared__ __align__(16) float Ks[BWD_TILE * D];
  __shared__ __align__(16) float Vs[BWD_TILE * D];
  const int tiles = (N + BWD_ROWS - 1) / BWD_ROWS;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * BWD_ROWS + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long obase = b * ob + h * oh;
  const bool active = row < N;  // inactive rows run on zeros, store nothing

  float4 qr[C4], gr[C4], orow[C4], acc[C4];
  load_slice<D>(q + base + row * sn, t, active, qr);
  load_slice<D>(dout + obase + row * on, t, active, gr);
  load_slice<D>(o + obase + row * on, t, active, orow);
  float di = 0.f;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    di += dot4(gr[c], orow[c]);
    acc[c] = zero4();
  }
  di = row_sum<TPR>(di);
  const long long ri = static_cast<long long>(bh) * N + row;
  const float li = active ? lse[ri] : 0.f;
  if (active && t == 0) delta[ri] = di;

  for (int k0 = 0; k0 < N; k0 += BWD_TILE) {
    const int kn = min(BWD_TILE, N - k0);
    __syncthreads();  // the previous step's reads of Ks / Vs are done
    stage_rows<D>(Ks, k, base, sn, k0, kn);
    stage_rows<D>(Vs, v, base, sn, k0, kn);
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      const float s = row_sum<TPR>(slice_dot<D>(qr, Ks + j * D, t));
      const float dp = row_sum<TPR>(slice_dot<D>(gr, Vs + j * D, t));
      const float p = __expf(s * scale - li);
      slice_fma<D>(p * (dp - di), Ks + j * D, t, acc);
    }
  }
  if (active) store_slice<D>(dq + b * gb + h * gh + row * gn, t, acc, scale);
}

// dK/dV pass: one block per (window, 64 key rows); every query streams
// through shared memory with its lse and delta.
// dV = sum_i P_ij dO_i, dK = scale * sum_i P_ij (dP_ij - delta_i) q_i.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_ROWS * row_threads<D>())
attention_dense_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int N, long long sb, long long sh, long long sn, long long ob,
    long long oh, long long on, long long gb, long long gh, long long gn,
    float scale) {
  constexpr int TPR = row_threads<D>(), C4 = row_slice<D>() / 4;
  __shared__ __align__(16) float Qs[BWD_TILE * D];
  __shared__ __align__(16) float Gs[BWD_TILE * D];
  __shared__ float Ls[BWD_TILE];
  __shared__ float Ds[BWD_TILE];
  const int tiles = (N + BWD_ROWS - 1) / BWD_ROWS;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * BWD_ROWS + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long obase = b * ob + h * oh;
  const bool active = row < N;

  float4 kr[C4], vr[C4], dka[C4], dva[C4];
  load_slice<D>(k + base + row * sn, t, active, kr);
  load_slice<D>(v + base + row * sn, t, active, vr);
#pragma unroll
  for (int c = 0; c < C4; ++c) dka[c] = dva[c] = zero4();

  for (int q0 = 0; q0 < N; q0 += BWD_TILE) {
    const int qn = min(BWD_TILE, N - q0);
    __syncthreads();
    stage_rows<D>(Qs, q, base, sn, q0, qn);
    stage_rows<D>(Gs, dout, obase, on, q0, qn);
    for (int i = threadIdx.x; i < qn; i += blockDim.x) {
      const long long ri = static_cast<long long>(bh) * N + q0 + i;
      Ls[i] = lse[ri];
      Ds[i] = delta[ri];
    }
    __syncthreads();
    for (int i = 0; i < qn; ++i) {
      const float s = row_sum<TPR>(slice_dot<D>(kr, Qs + i * D, t));
      const float dp = row_sum<TPR>(slice_dot<D>(vr, Gs + i * D, t));
      const float p = __expf(s * scale - Ls[i]);
      slice_fma<D>(p, Gs + i * D, t, dva);
      slice_fma<D>(p * (dp - Ds[i]), Qs + i * D, t, dka);
    }
  }
  if (active) {
    const long long g = b * gb + h * gh + row * gn;
    store_slice<D>(dk + g, t, dka, scale);
    store_slice<D>(dv + g, t, dva, 1.f);
  }
}

// ---- per-window kernels (N <= 32) -----------------------------------------
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
    const long long blocks =
        static_cast<long long>(B) * H * ((N + DENSE_ROWS - 1) / DENSE_ROWS);
    attention_dense_kernel<T, d><<<static_cast<unsigned>(blocks), DENSE_ROWS, 0, st>>>(
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
    const unsigned blocks = static_cast<unsigned>(
        static_cast<long long>(B) * H * ((N + BWD_ROWS - 1) / BWD_ROWS));
    const int threads = BWD_ROWS * row_threads<d>();
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* gt = static_cast<const T*>(dout);
    attention_dense_bwd_dq_kernel<T, d><<<blocks, threads, 0, st>>>(
        qt, kt, vt, static_cast<const T*>(o), gt, lse, delta,
        static_cast<T*>(dq), H, N, sb, sh, sn, ob, oh, on, gb, gh, gn, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_dense_bwd_dkv_kernel<T, d><<<blocks, threads, 0, st>>>(
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
