// Attention kernels of the MixSTE trunk: softmax(scale * Q K^T) V per
// (batch, head) window, accumulated in fp32 from fp32 or bf16 inputs.
//
// Replaces the TPU kernels of manipose_tpu/ops/pallas_attention.py:
//   attention_dense_kernel  <- _forward / _fwd_kernel (temporal layout,
//                              N = 243 frames; pallas_attention.py:45-54,
//                              97-112)
//   attention_packed_kernel <- _packed_forward / _packed_fwd_kernel
//                              (spatial layout, N = 16 bones or 17 joints;
//                              pallas_attention.py:149-164, 224-241)
//
// Layout. Q, K and V are strided views of the qkv projection
// (B, N, 3, H, D): element (b, h, n, i) sits at b*sb + h*sh + n*sn + i, and
// the three share the strides, so no copy is made before the launch. The
// output is written as (B, N, H, D), which is the merged-head (B, N, H*D)
// tensor the output projection reads, so no transpose follows either.
//
// What bounds them on an H100. Dense, at the flagship's rotations trunk
// (2176 windows of 243 x 64): 4*N*N*D flop per window, 32.9 GFLOP in all
// against 0.54 GB moved in fp32, so fp32 arithmetic (67 TFLOP/s on the CUDA
// cores) bounds it at ~0.49 ms. Packed (31104 windows of 17 x 64): 2.3 GFLOP
// against 0.54 GB, so memory (3.35 TB/s) bounds it at ~0.16 ms.
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
//
// The TPU packs G tiny windows into one block-diagonal (G*N)^2 tile to fill
// its 128 x 128 matrix unit. Here that trick has no use: one warp takes one
// window, each lane one query row, K, V and Q are staged with coalesced
// 16-byte loads, and the output is staged back through shared memory so it
// leaves with coalesced stores. No masking is needed. Four warps per block
// keep enough loads in flight across the 132 SMs for a memory-bound kernel.
//
// Simple first: fp32 CUDA-core arithmetic in both dtypes. wgmma / TMA and
// tensor-core bf16 are later work.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int DENSE_ROWS = 128;  // query rows (threads) per block
constexpr int DENSE_KEYS = 64;   // keys staged in shared memory per step
constexpr int SUB = 8;           // keys scored in registers per rescale
constexpr int PACKED_WARPS = 4;  // windows per block
constexpr int PACKED_MAX_N = 32;

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
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int N, long long sb, long long sh, long long sn,
                       float scale) {
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
    const float4 t = active ? mp::load4(q + base + row * sn + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
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
      const float4 t = *reinterpret_cast<const float4*>(Qs + lane * QS + 4 * c);
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
      *reinterpret_cast<float4*>(Qs + lane * QS + 4 * c) =
          make_float4(o[4 * c] * inv, o[4 * c + 1] * inv, o[4 * c + 2] * inv,
                      o[4 * c + 3] * inv);
    }
  }
  __syncwarp();

  for (int e = lane; e < N * (D / 4); e += 32) {
    const int j = e / (D / 4), c = e % (D / 4);
    T* dst = out + ((static_cast<long long>(b) * N + j) * H + h) * D + 4 * c;
    mp::store4(dst, *reinterpret_cast<const float4*>(Qs + j * QS + 4 * c));
  }
}

template <typename T, int D>
cudaError_t launch_dense(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int N, long long sb,
                         long long sh, long long sn, float scale,
                         cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(B) * H * ((N + DENSE_ROWS - 1) / DENSE_ROWS);
  attention_dense_kernel<T, D><<<static_cast<unsigned>(blocks), DENSE_ROWS, 0,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, N, sb, sh, sn, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_packed(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int N, long long sb,
                          long long sh, long long sn, float scale,
                          cudaStream_t stream) {
  const int bh = B * H;
  const size_t smem =
      sizeof(float) * PACKED_WARPS * packed_warp_floats<D>(N);
  cudaError_t err = cudaFuncSetAttribute(
      attention_packed_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (bh + PACKED_WARPS - 1) / PACKED_WARPS;
  attention_packed_kernel<T, D><<<blocks, PACKED_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, H, N, sb, sh, sn,
      scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 int, int, int, long long, long long,
                                 long long, float, cudaStream_t);

template <template <typename, int> class Pick>
Launcher pick(int dtype, int d) {
  if (dtype == mp::kF32) {
    if (d == 8) return Pick<float, 8>::fn;
    if (d == 16) return Pick<float, 16>::fn;
    if (d == 32) return Pick<float, 32>::fn;
    if (d == 64) return Pick<float, 64>::fn;
  } else if (dtype == mp::kBF16) {
    if (d == 8) return Pick<__nv_bfloat16, 8>::fn;
    if (d == 16) return Pick<__nv_bfloat16, 16>::fn;
    if (d == 32) return Pick<__nv_bfloat16, 32>::fn;
    if (d == 64) return Pick<__nv_bfloat16, 64>::fn;
  }
  return nullptr;
}

template <typename T, int D>
struct Dense {
  static constexpr Launcher fn = launch_dense<T, D>;
};
template <typename T, int D>
struct Packed {
  static constexpr Launcher fn = launch_packed<T, D>;
};

int run(Launcher fn, const void* q, const void* k, const void* v, void* out,
        int B, int H, int N, long long sb, long long sh, long long sn,
        float scale, int device, void* stream) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    return fn(q, k, v, out, B, H, N, sb, sh, sn, scale,
              static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" int mp_attention_dense(const void* q, const void* k, const void* v,
                                  void* out, int dtype, int B, int H, int N,
                                  int D, long long sb, long long sh,
                                  long long sn, float scale, int device,
                                  void* stream) {
  return run(pick<Dense>(dtype, D), q, k, v, out, B, H, N, sb, sh, sn, scale,
             device, stream);
}

extern "C" int mp_attention_packed(const void* q, const void* k,
                                   const void* v, void* out, int dtype, int B,
                                   int H, int N, int D, long long sb,
                                   long long sh, long long sn, float scale,
                                   int device, void* stream) {
  if (N < 1 || N > PACKED_MAX_N) return cudaErrorInvalidValue;
  return run(pick<Packed>(dtype, D), q, k, v, out, B, H, N, sb, sh, sn, scale,
             device, stream);
}
