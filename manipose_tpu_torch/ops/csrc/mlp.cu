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
// What bounds them on an H100. At the flagship's rotations trunk (M = 66096
// rows, C = 512, H = 1024) the forward does 4*M*C*H = 138.6 GFLOP against
// 0.28 GB moved in fp32, so fp32 arithmetic on the CUDA cores (67 TFLOP/s)
// bounds it at ~2.1 ms. Two plain GEMMs would also write and re-read the
// (M, H) intermediate: 0.54 GB more. The backward does five such products
// (recomputed a, dh, dX, dW1, dW2): 10*M*C*H = 346 GFLOP, ~5.2 ms.
//
// What the forward's design does about it. The TPU kernel keeps W1 and W2
// whole in VMEM; at C = 512, H = 1024 each is 2 MB in fp32, far beyond the
// 227 KB of shared memory a block may use. Here one block owns a tile of 64
// rows and keeps that tile's whole (64, C) output accumulator in registers
// (C/16 floats per thread per row group). It walks H in chunks of 64 hidden
// units: fc1 for the chunk (the x tile and the W1 rows stream through
// shared memory 32 columns at a time, 4 x 4 register tiles per thread),
// bias and exact GELU (erff), the chunk parked in shared memory (rounded to
// bf16 first under bf16, as pallas_mlp.py:86 does), then the chunk's fc2
// partial product added into the accumulator (W2 columns streamed 16 at a
// time). The (M, H) intermediate never reaches device memory. Rows past M
// are masked, so any M is taken (the TPU's pick_tile restriction does not
// apply). All shared-memory reads are 16-byte and conflict-free.
//
// The backward. The TPU kernel sums dW and db over its sequential grid in
// one pass; blocks on Hopper run in no order, so the sums over all M rows
// take a second pass. Pass 1 (rows) is shaped like the forward: per chunk
// of 64 hidden units it recomputes a = x W1^T + b1 (one tile product),
// keeps gelu'(a) in shared memory, forms dh = g W2 (a second tile product,
// so a, dh and the dX accumulator are never live in registers together),
// da = dh * gelu'(a), and adds da W1[chunk] into its (64, C) dX
// accumulator. It writes gelu(a) and da to (M, H) scratch, 2 x 0.27 GB at
// the flagship in fp32, which the weight sums read back. Pass 2 (wgrad)
// computes dW1 = da^T x and dW2 = g^T gelu(a) as 64 x 64 output tiles over
// a fixed split of M into S slices, fp32 partials per slice, and sums the
// columns of da and g for db1 and db2 on the way. Pass 3 (reduce) adds the
// S partials in slice order. No atomics: repeated runs agree bit for bit.
// Under bf16 it rounds where _bwd_kernel rounds: gelu(a), g and da before
// the products; db1 sums the unrounded da in fp32.
//
// Simple first: fp32 CUDA-core arithmetic, no double buffering, one block
// per SM for the row passes. Tensor cores (wgmma, bf16) and TMA pipelining
// are later work.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BH = 64;        // hidden units per chunk
constexpr int BK = 32;        // reduction slice of the chunk's tile products
constexpr int BH2 = 16;       // reduction slice of the accumulating product
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr int XS = BM + 4;    // row stride of the transposed row slice / chunk
constexpr int WS = BH + 4;    // row stride of the weight slice
constexpr int WT = 64;        // weight-gradient output tile edge
constexpr int WK = 32;        // rows of M staged per weight-gradient step
constexpr int WTS = WT + 4;

template <int C>
__host__ __device__ constexpr int smem_floats() {
  return BK * XS + BK * WS + BH * XS + BH2 * (C + 4);
}

__device__ __forceinline__ float gelu_exact(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float a) {
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  return cdf + a * 0.3989422804014327f * expf(-0.5f * a * a);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// s[i][j] = sum_k A[row0 + ty*4 + i][k] * W[k][tx*4 + j] over k in [0, C):
// the A tile (rows past M read as zeros) goes to ``xs`` transposed, and
// ``stage_w(k0)`` fills ``ws`` with W[k0 : k0 + BK][0 : BH] (row stride WS),
// BK columns at a time.
template <int C, typename T, typename StageW>
__device__ __forceinline__ void tile_product(const T* __restrict__ a, int row0,
                                             int M, float* xs, const float* ws,
                                             StageW stage_w, float (&s)[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += BK) {
    __syncthreads();  // earlier reads of xs / ws (and of the chunk) are done
    for (int e = tid; e < BM * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
      const float4 t =
          row0 + r < M
              ? mp::load4(a + static_cast<long long>(row0 + r) * C + k0 + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[(c + 0) * XS + r] = t.x;
      xs[(c + 1) * XS + r] = t.y;
      xs[(c + 2) * XS + r] = t.z;
      xs[(c + 3) * XS + r] = t.w;
    }
    stage_w(k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = lds4(xs + kk * XS + ty * 4);
      const float4 wv = lds4(ws + kk * WS + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], wr[j], s[i][j]);
    }
  }
}

// W1[hc : hc + BH][k0 : k0 + BK] transposed into ws (column, unit).
template <int C, typename T>
__device__ __forceinline__ void stage_w1_rows(const T* __restrict__ w1, int hc,
                                              int k0, float* ws) {
  for (int e = threadIdx.x; e < BH * (BK / 4); e += THREADS) {
    const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
    const float4 t = mp::load4(w1 + static_cast<long long>(hc + r) * C + k0 + c);
    ws[(c + 0) * WS + r] = t.x;
    ws[(c + 1) * WS + r] = t.y;
    ws[(c + 2) * WS + r] = t.z;
    ws[(c + 3) * WS + r] = t.w;
  }
}

// acc[i][jq*4 + e] += sum_u cs[u][ty*4 + i] * Wr[u][jq*64 + tx*4 + e] over
// the chunk's BH units; ``stage(h0)`` fills w2s with rows
// [h0, h0 + BH2) of Wr (row stride C + 4), BH2 units at a time.
template <int NJ, typename Stage>
__device__ __forceinline__ void accumulate_chunk(const float* cs, float* w2s,
                                                 Stage stage,
                                                 float (&acc)[4][4 * NJ]) {
  constexpr int C = 64 * NJ;
  constexpr int W2S = C + 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int h0 = 0; h0 < BH; h0 += BH2) {
    __syncthreads();  // chunk written; earlier reads of w2s are done
    stage(h0);
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < BH2; ++hh) {
      const float4 a = lds4(cs + (h0 + hh) * XS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jq = 0; jq < NJ; ++jq) {
        const float4 w = lds4(w2s + hh * W2S + jq * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][jq * 4 + e] = fmaf(av[i], wv[e], acc[i][jq * 4 + e]);
      }
    }
  }
}

// Store the (64, C) accumulator (+ bias when given) to rows < M of out.
template <int NJ, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const T* __restrict__ bias,
                                           int row0, int M,
                                           const float (&acc)[4][4 * NJ]) {
  constexpr int C = 64 * NJ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int jq = 0; jq < NJ; ++jq) {
    const int col = jq * 64 + tx * 4;
    const float4 b = bias != nullptr ? mp::load4(bias + col)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < M) {
        mp::store4(out + static_cast<long long>(r) * C + col,
                   make_float4(acc[i][jq * 4 + 0] + b.x, acc[i][jq * 4 + 1] + b.y,
                               acc[i][jq * 4 + 2] + b.z, acc[i][jq * 4 + 3] + b.w));
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int M, int H) {
  constexpr int C = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [BK][XS]  x slice, transposed (col, row)
  float* w1s = xs + BK * XS;    // [BK][WS]  W1 slice, transposed (col, unit)
  float* hs = w1s + BK * WS;    // [BH][XS]  hidden chunk, transposed
  float* w2s = hs + BH * XS;    // [BH2][C+4] W2 slice, transposed (unit, col)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;

  for (int hc = 0; hc < H; hc += BH) {
    // ---- fc1: s = x[rows] . W1[hc : hc + BH]^T, rows ty*4.., units tx*4..
    float s[4][4];
    tile_product<C>(x, row0, M, xs, w1s,
                    [&](int k0) { stage_w1_rows<C>(w1, hc, k0, w1s); }, s);

    // ---- bias + exact GELU; the chunk goes to shared memory (the k-loop's
    // barriers above already ordered this after the last fc2 reads of hs)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = mp::to_float(b1[hc + tx * 4 + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hs[(tx * 4 + j) * XS + ty * 4 + i] =
            mp::round_to<T>(gelu_exact(s[i][j] + bias));
      }
    }

    // ---- fc2: acc += chunk . W2[:, hc : hc + BH]^T; W2's rows are read
    // 4 units at a time and transposed into w2s (unit, col)
    constexpr int W2S = C + 4;
    accumulate_chunk<NJ>(hs, w2s, [&](int h0) {
      for (int e = threadIdx.x; e < C * (BH2 / 4); e += THREADS) {
        const int c = e / (BH2 / 4), u = 4 * (e % (BH2 / 4));
        const float4 t =
            mp::load4(w2 + static_cast<long long>(c) * H + hc + h0 + u);
        w2s[(u + 0) * W2S + c] = t.x;
        w2s[(u + 1) * W2S + c] = t.y;
        w2s[(u + 2) * W2S + c] = t.z;
        w2s[(u + 3) * W2S + c] = t.w;
      }
    }, acc);
  }
  store_rows<NJ>(out, b2, row0, M, acc);
}

// Pass 1 of the backward: dX for 64 rows, and gelu(a) and da to scratch.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ w1, const T* __restrict__ b1,
                          const T* __restrict__ w2, T* __restrict__ dx,
                          float* __restrict__ da_out, T* __restrict__ h_out,
                          int M, int H) {
  constexpr int C = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // [BK][XS]  x or g slice, transposed (col, row)
  float* ws = xs + BK * XS;    // [BK][WS]  weight slice (col, unit)
  float* cs = ws + BK * WS;    // [BH][XS]  gelu'(a), then da, transposed
  float* w1s = cs + BH * XS;   // [BH2][C+4] W1 rows (unit, col)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;

  for (int hc = 0; hc < H; hc += BH) {
    // ---- a = x . W1[hc : hc + BH]^T + b1; gelu(a) to scratch, gelu'(a)
    // to cs (each thread later reads back only what it wrote)
    float s[4][4];
    tile_product<C>(x, row0, M, xs, ws,
                    [&](int k0) { stage_w1_rows<C>(w1, hc, k0, ws); }, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = s[i][j] + mp::to_float(b1[hc + tx * 4 + j]);
        hv[j] = gelu_exact(a);
        cs[(tx * 4 + j) * XS + ty * 4 + i] = gelu_grad(a);
      }
      const int r = row0 + ty * 4 + i;
      if (r < M) {
        mp::store4(h_out + static_cast<long long>(r) * H + hc + tx * 4,
                   make_float4(hv[0], hv[1], hv[2], hv[3]));
      }
    }

    // ---- dh = g . W2[:, hc : hc + BH]; da = dh * gelu'(a): fp32 to
    // scratch, rounded to T in cs
    tile_product<C>(g, row0, M, xs, ws, [&](int k0) {
      for (int e = threadIdx.x; e < BK * (BH / 4); e += THREADS) {
        const int kk = e / (BH / 4), u = 4 * (e % (BH / 4));
        sts4(ws + kk * WS + u,
             mp::load4(w2 + static_cast<long long>(k0 + kk) * H + hc + u));
      }
    }, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* ci = cs + (tx * 4 + j) * XS + ty * 4 + i;
        dv[j] = s[i][j] * *ci;
        *ci = mp::round_to<T>(dv[j]);
      }
      const int r = row0 + ty * 4 + i;
      if (r < M) {
        sts4(da_out + static_cast<long long>(r) * H + hc + tx * 4,
             make_float4(dv[0], dv[1], dv[2], dv[3]));
      }
    }

    // ---- dX += da . W1[hc : hc + BH, :]
    constexpr int W1S = C + 4;
    accumulate_chunk<NJ>(cs, w1s, [&](int h0) {
      for (int e = threadIdx.x; e < BH2 * (C / 4); e += THREADS) {
        const int u = e / (C / 4), c = 4 * (e % (C / 4));
        sts4(w1s + u * W1S + c,
             mp::load4(w1 + static_cast<long long>(hc + h0 + u) * C + c));
      }
    }, acc);
  }
  store_rows<NJ>(dx, static_cast<const T*>(nullptr), row0, M, acc);
}

template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(mp::round_to<T>(v.x), mp::round_to<T>(v.y),
                     mp::round_to<T>(v.z), mp::round_to<T>(v.w));
}

// Pass 2: part[r][c] = sum over this block's slice of M of
// round_T(A[m][r]) * B[m][c], one 64 x 64 tile; the blocks of column tile 0
// also write colsum[r] = sum_m A[m][r], unrounded. Split s writes at
// s * split_stride.
template <typename TA, typename T>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_wgrad_kernel(const TA* __restrict__ a, const T* __restrict__ bm,
                           float* __restrict__ part, float* __restrict__ colsum,
                           int M, int RA, int CB, int rows_per_split,
                           long long split_stride) {
  __shared__ __align__(16) float As[WK * WTS];
  __shared__ __align__(16) float Bs[WK * WTS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * WT, c0 = blockIdx.y * WT;
  const long long split = blockIdx.z;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int q = 4 * (tid % 16);  // the four columns this thread stages

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 csum = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int m0 = m_begin; m0 < m_end; m0 += WK) {
    __syncthreads();
    for (int kk = tid / 16; kk < WK; kk += THREADS / 16) {
      const int m = m0 + kk;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      if (m < m_end) {
        av = mp::load4(a + static_cast<long long>(m) * RA + r0 + q);
        bv = mp::load4(bm + static_cast<long long>(m) * CB + c0 + q);
      }
      csum.x += av.x;
      csum.y += av.y;
      csum.z += av.z;
      csum.w += av.w;
      sts4(As + kk * WTS + q, round4<T>(av));
      sts4(Bs + kk * WTS + q, bv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK; ++kk) {
      const float4 av = lds4(As + kk * WTS + ty * 4);
      const float4 bv = lds4(Bs + kk * WTS + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  float* dst = part + split * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sts4(dst + static_cast<long long>(r0 + ty * 4 + i) * CB + c0 + tx * 4,
         make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
  if (blockIdx.y == 0) {  // block-uniform
    __syncthreads();
    sts4(As + (tid / 16) * WTS + q, csum);  // 16 partial sums per column
    __syncthreads();
    if (tid < WT) {
      float t = 0.f;
      for (int w = 0; w < THREADS / 16; ++w) t += As[w * WTS + tid];
      colsum[split * split_stride + r0 + tid] = t;
    }
  }
}

// Pass 3: out[e] = sum over s in order of part[s * n + e], n = 4 * n4.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                            int S, long long n4) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n4) return;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const float4 p = lds4(part + (s * n4 + e) * 4);
    t.x += p.x;
    t.y += p.y;
    t.z += p.z;
    t.w += p.w;
  }
  mp::store4(out + 4 * e, t);
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
  const size_t smem = sizeof(float) * smem_floats<64 * NJ>();
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
                       const void* b1, const void* w2, void* dx, float* da,
                       void* h, float* part, void* grads, int M, int H, int S,
                       cudaStream_t stream) {
  constexpr int C = 64 * NJ;
  const size_t smem = sizeof(float) * smem_floats<C>();
  cudaError_t err = allow_smem(fused_mlp_bwd_rows_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ht = static_cast<T*>(h);
  fused_mlp_bwd_rows_kernel<T, NJ><<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      xt, gt, static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<T*>(dx), da, ht, M, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // partials per split: dW1 (H, C), db1 (H), dW2 (C, H), db2 (C)
  const long long hc = static_cast<long long>(H) * C;
  const long long n = 2 * hc + H + C;
  const int rows_per_split = (M + S - 1) / S;
  fused_mlp_bwd_wgrad_kernel<float, T><<<dim3(H / WT, C / WT, S), THREADS, 0, stream>>>(
      da, xt, part, part + hc, M, H, C, rows_per_split, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_wgrad_kernel<T, T><<<dim3(C / WT, H / WT, S), THREADS, 0, stream>>>(
      gt, ht, part + hc + H, part + 2 * hc + H, M, C, H, rows_per_split, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = n / 4;
  fused_mlp_bwd_reduce_kernel<T><<<static_cast<unsigned>((n4 + THREADS - 1) / THREADS),
                                   THREADS, 0, stream>>>(part, static_cast<T*>(grads),
                                                         S, n4);
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

// Scratch from the caller: da (M, H) fp32, h (M, H) of the element type,
// part (S, 2*H*C + H + C) fp32. ``grads`` (2*H*C + H + C, element type)
// receives dW1 (H, C), db1 (H), dW2 (C, H) and db2 (C) in that order.
extern "C" int mp_fused_mlp_bwd(const void* x, const void* g, const void* w1,
                                const void* b1, const void* w2, void* dx,
                                float* da, void* h, float* part, void* grads,
                                int dtype, int M, int C, int H, int S,
                                int device, void* stream) {
  if (M < 1 || H < BH || H % BH != 0 || S < 1 || S > M) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, C, device, [&](auto tag, auto nj) {
    using T = decltype(tag);
    return launch_bwd<T, decltype(nj)::value>(x, g, w1, b1, w2, dx, da, h,
                                              part, grads, M, H, S, st);
  });
}
