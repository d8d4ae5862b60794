// Fused MLP of the MixSTE trunk: y = gelu(x W1^T + b1) W2^T + b2 with the
// exact (erf) GELU, fp32 accumulation, fp32 or bf16 inputs. Weights come in
// torch Linear layout: W1 is (H, C), W2 is (C, H).
//
// Replaces the TPU kernel of manipose_tpu/ops/pallas_mlp.py: _forward /
// _fwd_kernel (pallas_mlp.py:83-88, 95-115).
//
// What bounds it on an H100. At the flagship's rotations trunk (M = 66096
// rows, C = 512, H = 1024) it does 4*M*C*H = 138.6 GFLOP against 0.28 GB
// moved in fp32, so fp32 arithmetic on the CUDA cores (67 TFLOP/s) bounds
// it at ~2.1 ms. Two plain GEMMs would also write and re-read the (M, H)
// intermediate: 0.54 GB more.
//
// What the design does about it. The TPU kernel keeps W1 and W2 whole in
// VMEM; at C = 512, H = 1024 each is 2 MB in fp32, far beyond the 227 KB of
// shared memory a block may use. Here one block owns a tile of 64 rows and
// keeps that tile's whole (64, C) output accumulator in registers (C/16
// floats per thread per row group). It walks H in chunks of 64 hidden units:
// fc1 for the chunk (the x tile and the W1 rows stream through shared
// memory 32 columns at a time, 4 x 4 register tiles per thread), bias and
// exact GELU (erff), the chunk parked in shared memory (rounded to bf16
// first under bf16, as pallas_mlp.py:86 does), then the chunk's fc2 partial
// product added into the accumulator (W2 columns streamed 16 at a time).
// The (M, H) intermediate never reaches device memory. Rows past M are
// masked, so any M is taken (the TPU's pick_tile restriction does not
// apply). All shared-memory reads are 16-byte and conflict-free.
//
// Simple first: fp32 CUDA-core arithmetic, no double buffering, one block
// per SM. Tensor cores (wgmma, bf16) and TMA pipelining are later work.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BH = 64;        // hidden units per chunk
constexpr int BK = 32;        // fc1 reduction slice
constexpr int BH2 = 16;       // fc2 reduction slice
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr int XS = BM + 4;    // row stride of the transposed x slice / chunk
constexpr int WS = BH + 4;    // row stride of the transposed W1 slice

template <int C>
__host__ __device__ constexpr int smem_floats() {
  return BK * XS + BK * WS + BH * XS + BH2 * (C + 4);
}

__device__ __forceinline__ float gelu_exact(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int M, int H) {
  constexpr int C = 64 * NJ;
  constexpr int W2S = C + 4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [BK][XS]  x slice, transposed (col, row)
  float* w1s = xs + BK * XS;    // [BK][WS]  W1 slice, transposed (col, unit)
  float* hs = w1s + BK * WS;    // [BH][XS]  hidden chunk, transposed
  float* w2s = hs + BH * XS;    // [BH2][W2S] W2 slice, transposed (unit, col)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;

  for (int hc = 0; hc < H; hc += BH) {
    // ---- fc1: s = x[rows] . W1[hc : hc + BH]^T, rows ty*4.., units tx*4..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += BK) {
      __syncthreads();  // earlier reads of xs / w1s / hs are done
      for (int e = tid; e < BM * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
        const float4 t =
            row0 + r < M
                ? mp::load4(x + static_cast<long long>(row0 + r) * C + k0 + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        xs[(c + 0) * XS + r] = t.x;
        xs[(c + 1) * XS + r] = t.y;
        xs[(c + 2) * XS + r] = t.z;
        xs[(c + 3) * XS + r] = t.w;
      }
      for (int e = tid; e < BH * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
        const float4 t = mp::load4(w1 + static_cast<long long>(hc + r) * C + k0 + c);
        w1s[(c + 0) * WS + r] = t.x;
        w1s[(c + 1) * WS + r] = t.y;
        w1s[(c + 2) * WS + r] = t.z;
        w1s[(c + 3) * WS + r] = t.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(xs + kk * XS + ty * 4);
        const float4 w = *reinterpret_cast<const float4*>(w1s + kk * WS + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], wv[j], s[i][j]);
      }
    }

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

    // ---- fc2: acc += chunk . W2[:, hc : hc + BH]^T
    for (int h0 = 0; h0 < BH; h0 += BH2) {
      __syncthreads();  // chunk written; earlier reads of w2s are done
      for (int e = tid; e < C * (BH2 / 4); e += THREADS) {
        const int c = e / (BH2 / 4), u = 4 * (e % (BH2 / 4));
        const float4 t = mp::load4(w2 + static_cast<long long>(c) * H + hc + h0 + u);
        w2s[(u + 0) * W2S + c] = t.x;
        w2s[(u + 1) * W2S + c] = t.y;
        w2s[(u + 2) * W2S + c] = t.z;
        w2s[(u + 3) * W2S + c] = t.w;
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < BH2; ++hh) {
        const float4 a =
            *reinterpret_cast<const float4*>(hs + (h0 + hh) * XS + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int jq = 0; jq < NJ; ++jq) {
          const float4 w = *reinterpret_cast<const float4*>(
              w2s + hh * W2S + jq * 64 + tx * 4);
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

  // ---- epilogue: + b2, masked rows, coalesced 4-wide stores
#pragma unroll
  for (int jq = 0; jq < NJ; ++jq) {
    const int col = jq * 64 + tx * 4;
    const float4 bias = mp::load4(b2 + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < M) {
        mp::store4(out + static_cast<long long>(r) * C + col,
                   make_float4(acc[i][jq * 4 + 0] + bias.x,
                               acc[i][jq * 4 + 1] + bias.y,
                               acc[i][jq * 4 + 2] + bias.z,
                               acc[i][jq * 4 + 3] + bias.w));
      }
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<64 * NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM;
  fused_mlp_kernel<T, NJ><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), M, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(int C, const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, int M, int H,
                     cudaStream_t stream) {
  switch (C) {
    case 64: return launch<T, 1>(x, w1, b1, w2, b2, out, M, H, stream);
    case 128: return launch<T, 2>(x, w1, b1, w2, b2, out, M, H, stream);
    case 256: return launch<T, 4>(x, w1, b1, w2, b2, out, M, H, stream);
    case 512: return launch<T, 8>(x, w1, b1, w2, b2, out, M, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mp_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int dtype, int M, int C, int H, int device,
                            void* stream) {
  if (M < 1 || H < BH || H % BH != 0) return cudaErrorInvalidValue;
  if (dtype != mp::kF32 && dtype != mp::kBF16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mp::on_device(device, [&] {
    return dtype == mp::kF32
               ? launch_c<float>(C, x, w1, b1, w2, b2, out, M, H, st)
               : launch_c<__nv_bfloat16>(C, x, w1, b1, w2, b2, out, M, H, st);
  });
}
