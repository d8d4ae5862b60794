// Learned stream fusion of MotionBERT's DSTformer (Zhu et al., ICCV 2023,
// arXiv 2210.06551): at each depth the two streams x_st and x_ts, R rows of
// C channels each, are joined as
//   (a0, a1) = softmax(W [x_st, x_ts] + b),   x = a0 * x_st + a1 * x_ts,
// with W (2, 2C) and b (2,) the depth's ``ts_attn`` Linear. fp32 throughout.
//
// It replaces no TPU kernel: the JAX package has no DSTformer. It is here
// because no kernel of the port computes the fusion; as library operations
// it is a concatenation, an N = 2 product, a softmax and three elementwise
// passes, and as many again backward, each a trip through device memory.
//
// What bounds it on an H100: bytes. The forward reads x_st and x_ts once
// and writes x (3 R C fp32) and alpha (2 R); at the benchmark's R =
// 132,192 rows of C = 512 that is 0.81 GB, 0.24 ms at 3.35 TB/s, against
// 4 R C FLOPs of products. The backward reads dx, x_st, x_ts and alpha and
// writes dx_st and dx_ts (5 R C, 1.35 GB, 0.40 ms), and dW and db reduced
// over the rows.
//
// Design. One warp a row: lane l holds channels 4l..4l+3 of every 128-wide
// chunk of the row in registers (C <= 512, at most 4 chunks), so each
// stream is read from device memory once. The two logits (forward) or the
// two dot products with dx (backward) are summed over the lane's channels,
// then over the warp by an xor butterfly, which leaves every lane the same
// sum; the blend or the streams' gradients then use the values already in
// registers. W sits in shared memory. A grid of fixed size per R walks the
// rows (warp w of block k takes rows 8k + w, then 8 more every grid), so
// many 16-byte loads are in flight on every SM. The backward keeps each
// warp's share of dW and db in registers over its rows, sums the block's
// warps in shared memory in warp order into one partial row a block, and a
// second kernel sums the partials in block order: the gradient does not
// depend on the launch's timing. Since the softmax is over two, dl1 = -dl0
// (dl: the logits' gradient), so dW's second row and db's second entry are
// the negated first ones and the streams' gradients read W0 - W1.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 128;     // channels a warp covers with one float4 a lane
constexpr int MAX_CHUNKS = 4;  // C <= 512
constexpr int MAX_C = CHUNK * MAX_CHUNKS;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Forward: out (R, C) and alpha (R, 2) from x_st, x_ts (R, C), W (2, 2C)
// and b (2,).
__global__ void __launch_bounds__(THREADS, 4)
stream_fusion_kernel(const float* __restrict__ xs, const float* __restrict__ xt,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, float* __restrict__ alpha, int R, int C) {
  __shared__ __align__(16) float ws[4 * MAX_C];  // W0 (x_st half, x_ts half), W1 (both)
  for (int i = threadIdx.x; i < 4 * C; i += THREADS) ws[i] = w[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float b0 = b[0], b1 = b[1];
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5); row < R;
       row += static_cast<long long>(gridDim.x) * WARPS) {
    const float* ps = xs + row * C;
    const float* pt = xt + row * C;
    float4 s[MAX_CHUNKS], t[MAX_CHUNKS];
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      const int c = k * CHUNK + lane * 4;
      s[k] = zero4();
      t[k] = zero4();
      if (c < C) {
        s[k] = mp::load4(ps + c);
        t[k] = mp::load4(pt + c);
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      const int c = k * CHUNK + lane * 4;
      if (c < C) {
        l0 += dot4(s[k], *reinterpret_cast<const float4*>(ws + c)) +
              dot4(t[k], *reinterpret_cast<const float4*>(ws + C + c));
        l1 += dot4(s[k], *reinterpret_cast<const float4*>(ws + 2 * C + c)) +
              dot4(t[k], *reinterpret_cast<const float4*>(ws + 3 * C + c));
      }
    }
    l0 = warp_sum(l0) + b0;
    l1 = warp_sum(l1) + b1;
    const float m = fmaxf(l0, l1);
    const float e0 = expf(l0 - m), e1 = expf(l1 - m);
    const float a0 = e0 / (e0 + e1), a1 = e1 / (e0 + e1);
    float* po = out + row * C;
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      const int c = k * CHUNK + lane * 4;
      if (c < C) {
        mp::store4(po + c, make_float4(a0 * s[k].x + a1 * t[k].x, a0 * s[k].y + a1 * t[k].y,
                                       a0 * s[k].z + a1 * t[k].z, a0 * s[k].w + a1 * t[k].w));
      }
    }
    if (lane == 0) *reinterpret_cast<float2*>(alpha + 2 * row) = make_float2(a0, a1);
  }
}

// Backward over rows: dx_st, dx_ts (R, C), and the block's partial sums of
// dW0 (2C) and db0 into part[blockIdx.x] (2C + 1 floats).
__global__ void __launch_bounds__(THREADS, 2)
stream_fusion_bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ xs,
                              const float* __restrict__ xt, const float* __restrict__ alpha,
                              const float* __restrict__ w, float* __restrict__ dxs,
                              float* __restrict__ dxt, float* __restrict__ part, int R, int C) {
  __shared__ __align__(16) float wd[2 * MAX_C];             // W0 - W1
  __shared__ __align__(16) float red[WARPS][2 * MAX_C + 1];  // the warps' dW0, db0
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) wd[i] = w[i] - w[2 * C + i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 acc_s[MAX_CHUNKS], acc_t[MAX_CHUNKS];
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k) acc_s[k] = acc_t[k] = zero4();
  float acc_b = 0.f;
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS + warp; row < R;
       row += static_cast<long long>(gridDim.x) * WARPS) {
    const long long base = row * C;
    float4 gg[MAX_CHUNKS], s[MAX_CHUNKS], t[MAX_CHUNKS];
    float da0 = 0.f, da1 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      const int c = k * CHUNK + lane * 4;
      gg[k] = s[k] = t[k] = zero4();
      if (c < C) {
        gg[k] = mp::load4(g + base + c);
        s[k] = mp::load4(xs + base + c);
        t[k] = mp::load4(xt + base + c);
      }
    }
    const float2 a = *reinterpret_cast<const float2*>(alpha + 2 * row);
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      da0 += dot4(gg[k], s[k]);
      da1 += dot4(gg[k], t[k]);
    }
    da0 = warp_sum(da0);
    da1 = warp_sum(da1);
    const float dl0 = a.x * a.y * (da0 - da1);  // dl1 = -dl0
    acc_b += dl0;
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      const int c = k * CHUNK + lane * 4;
      if (c < C) {
        const float4 ws = *reinterpret_cast<const float4*>(wd + c);
        const float4 wt = *reinterpret_cast<const float4*>(wd + C + c);
        mp::store4(dxs + base + c,
                   make_float4(a.x * gg[k].x + dl0 * ws.x, a.x * gg[k].y + dl0 * ws.y,
                               a.x * gg[k].z + dl0 * ws.z, a.x * gg[k].w + dl0 * ws.w));
        mp::store4(dxt + base + c,
                   make_float4(a.y * gg[k].x + dl0 * wt.x, a.y * gg[k].y + dl0 * wt.y,
                               a.y * gg[k].z + dl0 * wt.z, a.y * gg[k].w + dl0 * wt.w));
        acc_s[k].x += dl0 * s[k].x;
        acc_s[k].y += dl0 * s[k].y;
        acc_s[k].z += dl0 * s[k].z;
        acc_s[k].w += dl0 * s[k].w;
        acc_t[k].x += dl0 * t[k].x;
        acc_t[k].y += dl0 * t[k].y;
        acc_t[k].z += dl0 * t[k].z;
        acc_t[k].w += dl0 * t[k].w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k) {
    const int c = k * CHUNK + lane * 4;
    if (c < C) {
      float* rs = &red[warp][c];
      float* rt = &red[warp][C + c];
      rs[0] = acc_s[k].x; rs[1] = acc_s[k].y; rs[2] = acc_s[k].z; rs[3] = acc_s[k].w;
      rt[0] = acc_t[k].x; rt[1] = acc_t[k].y; rt[2] = acc_t[k].z; rt[3] = acc_t[k].w;
    }
  }
  if (lane == 0) red[warp][2 * C] = acc_b;
  __syncthreads();
  const int n = 2 * C + 1;  // dW0's 2C entries, then db0
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) sum += red[v][i];
    part[static_cast<long long>(blockIdx.x) * n + i] = sum;
  }
}

// dW (2, 2C) and db (2,) from the blocks' partials, summed in block order.
__global__ void __launch_bounds__(THREADS)
stream_fusion_bwd_reduce_kernel(const float* __restrict__ part, int blocks, int C,
                                float* __restrict__ dw, float* __restrict__ db) {
  const int n = 2 * C + 1;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int k = 0; k < blocks; ++k) sum += part[static_cast<long long>(k) * n + i];
  if (i < 2 * C) {
    dw[i] = sum;
    dw[2 * C + i] = -sum;
  } else {
    db[0] = sum;
    db[1] = -sum;
  }
}

bool shape_ok(int R, int C, int blocks) {
  return R >= 1 && C >= 4 && C <= MAX_C && C % 4 == 0 && blocks >= 1;
}

}  // namespace

// x_st, x_ts, out (R, C), alpha (R, 2), W (2, 2C), b (2,): fp32, 16-byte
// aligned; ``blocks`` the grid (the wrapper's ``grid_blocks``).
extern "C" int mp_stream_fusion(const void* xs, const void* xt, const void* w, const void* b,
                                void* out, void* alpha, int R, int C, int blocks, int device,
                                void* stream) {
  if (!shape_ok(R, C, blocks)) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    stream_fusion_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xs), static_cast<const float*>(xt),
        static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out),
        static_cast<float*>(alpha), R, C);
    return cudaGetLastError();
  });
}

// dx (R, C) the output's gradient; x_st, x_ts, alpha, W as saved by the
// forward. Writes dx_st, dx_ts (R, C), dW (2, 2C), db (2,); ``part``
// (blocks, 2C + 1) fp32 scratch.
extern "C" int mp_stream_fusion_bwd(const void* g, const void* xs, const void* xt,
                                    const void* alpha, const void* w, void* dxs, void* dxt,
                                    void* dw, void* db, void* part, int R, int C, int blocks,
                                    int device, void* stream) {
  if (!shape_ok(R, C, blocks)) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    auto st = static_cast<cudaStream_t>(stream);
    stream_fusion_bwd_rows_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(xs),
        static_cast<const float*>(xt), static_cast<const float*>(alpha),
        static_cast<const float*>(w), static_cast<float*>(dxs), static_cast<float*>(dxt),
        static_cast<float*>(part), R, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n = 2 * C + 1;
    stream_fusion_bwd_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        static_cast<const float*>(part), blocks, C, static_cast<float*>(dw),
        static_cast<float*>(db));
    return cudaGetLastError();
  });
}
