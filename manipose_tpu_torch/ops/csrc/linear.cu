// fp32 linear of the MixSTE and DSTformer trunks' attention (qkv and proj)
// and its gradient, on the tensor cores: y = x W^T + b, dX = dY W, dW =
// dY^T x and db = the column sums of dY, for x (M, K), W (N, K) in torch
// Linear layout, K and N multiples of 128.
//
// Replaces no TPU kernel: the JAX package's Dense is XLA's dot
// (manipose_tpu/models/mix_ste.py), and the port's plain version is
// F.linear. It was added because with TF32 off the library runs these
// fp32 products on the FMA units (67 TFLOP/s at most on an H100), where
// they took 41-49 % of the training steps' device time.
//
// What bounds it. At the flagship's B = 16 step (M = 66,096 rows, K = 512)
// qkv's forward does 2 M N K = 104 GFLOP against 0.54 GB of device memory
// (x, y, W), so operations bound it: 0.63 ms at 3xTF32's 165 TFLOP/s (a
// third of TF32's 495). Every product runs as 3xTF32 (mma.cuh): the
// operands split into big and small tf32 parts, three tf32 passes, each
// stage of 32 of k in a fresh wgmma accumulator, small parts' products
// first, then added into fp32 sums, which keeps fp32 accuracy (8.6e-7 off
// fp64 over K = 1024, against 2.75e-6 for an fp32 fmaf loop;
// probes/accumulate.cu).
//
// Design: K6's tile products (wgmma.cuh's gemm), persistent blocks of a
// TMA producer warpgroup and two consumer warpgroups over 256 x 128 output
// tiles, each consumer 128 rows as two m64n128 halves that share the
// stage's B, full/empty mbarrier rings of 32-deep stages. wgmma reads a
// tf32 B from shared memory k-major only and takes A from registers in
// any layout, so:
//   linear_fwd_kernel   y = x . W^T + b: A = x from raw [r][k] boxes of
//                       256 rows, split in registers (as K5 splits x); B =
//                       W's big and small planes (2N, K), which
//                       linear_split_kernel writes once a launch.
//   linear_dx_kernel    dX = dY . W: A = dY the same way; B = W^T's planes
//                       (2K, N) from the same split kernel, transposing.
//   linear_dw_kernel    dW = dY^T . x over M, where both lie row-major: A =
//                       dY^T from [k][r] boxes of 32 x 32 (as K6's dW takes
//                       x), B = x^T's planes (2K, M), from the split kernel
//                       (x, not qkv's three times wider dY, is transposed).
//                       It sums over S fixed slices of M into fp32 partials,
//                       and its items of the first column tile also sum A's
//                       raw values row by row: db's partials.
//   linear_reduce_kernel adds the slices' partials in a fixed order.
// No atomics and no split that depends on the data: runs agree bit for
// bit. Rows past M read TMA's zeros and are masked on store; the tensor
// maps are encoded on the host and passed as __grid_constant__, the
// scratch is the caller's, nothing synchronizes, so a CUDA graph captures
// every launch.
//
// Measured on an H100 (700 W), qkv at M = 66096: forward 0.827 ms, dX
// 0.760, dW 0.771 (77-83 % of the 0.630 ms bound; the library's fp32
// GEMMs 2.1 ms each), the split passes 0.169 (x^T's at 73 % of the
// memory's rate). With one tf32 pass the products take 0.469, 0.412 and
// 0.384 ms, with no wgmma 0.440, 0.329 and 0.304 (run_probes linear): the
// tensor cores bound them. Below about 4096 rows at K = 512 (16384 at K =
// 128) the library is the faster; cuda_linear.takes_wgmma leaves those to
// it.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mp::wg;

constexpr int TILE_COLS = 128;

// out (M, n_out) = A (M, k) . B^T (+ bias): A from raw [r][k] boxes (the
// map ``ta``, 256-row boxes), B the weight's planes (2 n_out, k) (``tb``);
// item i is row tile i / (n_out / 128), column tile i % (n_out / 128), so
// the column tiles of a row tile run together and share its A in L2.
__device__ __forceinline__ void rows_product(const CUtensorMap* ta, const CUtensorMap* tb,
                                             const float* __restrict__ bias,
                                             float* __restrict__ out, int M, int n_out, int k) {
  const int nt = n_out / TILE_COLS;
  gemm<A_ROWS>(
      (M + TILE_ROWS - 1) / TILE_ROWS * nt,
      [&](int i) {
        return Work{ta, tb, TILE_ROWS * (i / nt), 0, TILE_COLS * (i % nt), n_out, 0, k};
      },
      [&](int i, const float(&sum)[64], int row0, int row1) {
        const int col = TILE_COLS * (i % nt) + 2 * (threadIdx.x & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = TILE_ROWS * (i / nt) + (h ? row1 : row0);
          if (row >= M) continue;
          float* o = out + static_cast<long long>(row) * n_out + col;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col + 8 * j)
                                  : make_float2(0.f, 0.f);
            mp::store2(o + 8 * j, sum[4 * j + 2 * h] + b.x, sum[4 * j + 2 * h + 1] + b.y);
          }
        }
      });
}

__global__ void __launch_bounds__(THREADS, 1)
linear_fwd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ b, float* __restrict__ y, int M, int N, int K) {
  rows_product(&tx, &tw, b, y, M, N, K);
}

__global__ void __launch_bounds__(THREADS, 1)
linear_dx_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap twt,
                 float* __restrict__ dx, int M, int N, int K) {
  rows_product(&tg, &twt, nullptr, dx, M, K, N);
}

// dW = dY^T x (N, K) over S slices of M (kps rows each, the last shorter,
// up to Mk, M rounded up to 32) into part (S, N, K), and db's partials,
// dY's column sums over each slice, into dbp (S, N). Item i: slice i /
// per, then the 256 x 128 tile, so the items running together share their
// rows of M.
__global__ void __launch_bounds__(THREADS, 1)
linear_dw_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap txt,
                 float* __restrict__ part, float* __restrict__ dbp, int Mk, int N, int K, int S,
                 int kps) {
  const int kt = K / TILE_COLS, per = (N + TILE_ROWS - 1) / TILE_ROWS * kt;
  const long long nk = static_cast<long long>(N) * K;
  gemm<A_RAW, true>(
      S * per,
      [&](int i) {
        const int z = i / per, tile = i % per;
        return Work{&tg, &txt, TILE_ROWS * (tile / kt), 0, TILE_COLS * (tile % kt), K,
                    z * kps, min(Mk, (z + 1) * kps), tile % kt == 0};
      },
      [&](int i, const float(&sum)[64], int row0, int row1, const float(&rs)[2]) {
        const int z = i / per, tile = i % per, t = threadIdx.x & 3;
        const int col = TILE_COLS * (tile % kt) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = TILE_ROWS * (tile / kt) + (h ? row1 : row0);  // an output feature
          if (row >= N) continue;
          float* o = part + z * nk + static_cast<long long>(row) * K + col;
#pragma unroll
          for (int j = 0; j < 16; ++j) mp::store2(o + 8 * j, sum[4 * j + 2 * h],
                                                   sum[4 * j + 2 * h + 1]);
          if (tile % kt == 0 && t == 0) dbp[static_cast<long long>(z) * N + row] = rs[h];
        }
      });
}

// dw (N, K) and db (N): the S slices' partials added in slice order.
__global__ void __launch_bounds__(256)
linear_reduce_kernel(const float* __restrict__ part, const float* __restrict__ dbp,
                     float* __restrict__ dw, float* __restrict__ db, int N, int K, int S) {
  const long long nk = static_cast<long long>(N) * K;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < nk + N;
       i += static_cast<long long>(gridDim.x) * 256) {
    float t = 0.f;
    if (i < nk) {
      for (int s = 0; s < S; ++s) t += part[s * nk + i];
      dw[i] = t;
    } else {
      for (int s = 0; s < S; ++s) t += dbp[static_cast<long long>(s) * N + (i - nk)];
      db[i - nk] = t;
    }
  }
}

// src (rows, cols) fp32, row-major, cols a multiple of 32, split into big
// and small tf32 planes: as it lies (transpose 0: dst (2 rows, cols), the
// small parts below the big) or transposed (transpose 1: dst (2 cols,
// pitch), pitch >= rows; columns past rows are left as they are), through
// 32 x 32 tiles in shared memory.
__global__ void __launch_bounds__(256)
linear_split_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows, int cols,
                    long long pitch, int transpose) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long ct = cols / 32, n = (rows + 31) / 32 * ct;
  const long long plane = transpose ? cols * pitch : static_cast<long long>(rows) * cols;
  for (long long tl = blockIdx.x; tl < n; tl += gridDim.x) {
    const int r0 = static_cast<int>(tl / ct) * 32, c0 = static_cast<int>(tl % ct) * 32;
    __syncthreads();  // the previous tile's reads are done
    for (int i = ty; i < 32; i += 8) {
      tile[i][tx] = r0 + i < rows ? src[static_cast<long long>(r0 + i) * cols + c0 + tx] : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + (transpose ? tx : i);
      if (r >= rows) continue;
      const float v = transpose ? tile[tx][i] : tile[i][tx];
      const long long at = transpose ? (c0 + i) * pitch + r
                                     : static_cast<long long>(r) * cols + c0 + tx;
      const uint32_t w[1] = {__float_as_uint(v)};
      uint32_t p[2][1];
      mp::Mma<float>::split(w, p);
      dst[at] = __uint_as_float(p[0][0]);
      dst[plane + at] = __uint_as_float(p[1][0]);
    }
  }
}

// blocks of the split kernel: up to 8 an SM (256 threads, 4 KB each)
int split_blocks(int rows, int cols, int n_sm) {
  const long long tiles = static_cast<long long>((rows + 31) / 32) * (cols / 32);
  return static_cast<int>(std::min<long long>(tiles, 8LL * n_sm));
}

int padded_rows(int M) { return (M + KB - 1) / KB * KB; }

cudaError_t launch(const float* x, const float* w, const float* b, float* y, float* wp, int M,
                   int N, int K, int device, cudaStream_t stream) {
  int n_sm;
  if (cudaError_t err = mp::sm_count(device, &n_sm); err != cudaSuccess) return err;
  CUtensorMap tx, tw;
  if (!mp::encode_map(&tx, x, M, K, TILE_ROWS) || !mp::encode_map(&tw, wp, 2 * N, K, 128)) {
    return cudaErrorNotSupported;
  }
  cudaError_t err;
  if ((err = mp::allow_smem(linear_fwd_kernel, Gemm<A_ROWS>::SMEM)) != cudaSuccess) return err;
  linear_split_kernel<<<split_blocks(N, K, n_sm), 256, 0, stream>>>(w, wp, N, K, K, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int items = (M + TILE_ROWS - 1) / TILE_ROWS * (N / TILE_COLS);
  linear_fwd_kernel<<<std::min(items, n_sm), THREADS, Gemm<A_ROWS>::SMEM, stream>>>(
      tx, tw, b, y, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* x, const float* w, const float* g, float* dx, float* dw,
                       float* db, float* wtp, float* xtp, float* part, float* dbp, int M, int N,
                       int K, int S, int device, cudaStream_t stream) {
  int n_sm;
  if (cudaError_t err = mp::sm_count(device, &n_sm); err != cudaSuccess) return err;
  const int Mk = padded_rows(M);
  CUtensorMap tg_rows, twt, tg_kr, txt;
  if (!mp::encode_map(&tg_rows, g, M, N, TILE_ROWS) ||
      !mp::encode_map(&twt, wtp, 2 * K, N, 128) || !mp::encode_map(&tg_kr, g, M, N, 32) ||
      !mp::encode_map(&txt, xtp, 2 * K, M, 128, Mk)) {
    return cudaErrorNotSupported;
  }
  cudaError_t err;
  if ((err = mp::allow_smem(linear_dx_kernel, Gemm<A_ROWS>::SMEM)) != cudaSuccess ||
      (err = mp::allow_smem(linear_dw_kernel, Gemm<A_RAW>::SMEM)) != cudaSuccess) {
    return err;
  }
  linear_split_kernel<<<split_blocks(N, K, n_sm), 256, 0, stream>>>(w, wtp, N, K, N, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  linear_split_kernel<<<split_blocks(M, K, n_sm), 256, 0, stream>>>(x, xtp, M, K, Mk, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dx_items = (M + TILE_ROWS - 1) / TILE_ROWS * (K / TILE_COLS);
  linear_dx_kernel<<<std::min(dx_items, n_sm), THREADS, Gemm<A_ROWS>::SMEM, stream>>>(
      tg_rows, twt, dx, M, N, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dw_items = S * ((N + TILE_ROWS - 1) / TILE_ROWS) * (K / TILE_COLS);
  const int kps = ((Mk + S - 1) / S + KB - 1) / KB * KB;
  linear_dw_kernel<<<std::min(dw_items, n_sm), THREADS, Gemm<A_RAW>::SMEM, stream>>>(
      tg_kr, txt, part, dbp, Mk, N, K, S, kps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = static_cast<long long>(N) * K + N;
  linear_reduce_kernel<<<static_cast<unsigned>(std::min<long long>((n + 255) / 256, 4LL * n_sm)),
                         256, 0, stream>>>(part, dbp, dw, db, N, K, S);
  return cudaGetLastError();
}

bool takes(int M, int N, int K) {
  return M >= 1 && N >= TILE_COLS && K >= TILE_COLS && N % TILE_COLS == 0 &&
         K % TILE_COLS == 0;
}

}  // namespace

// y (M, N) = x (M, K) W^T (+ b), fp32; b may be null. Scratch from the
// caller: wp (2N, K) fp32, which the launch fills with W's tf32 planes.
// Every pointer 16-byte aligned; K and N multiples of 128.
extern "C" int mp_linear(const void* x, const void* w, const void* b, void* y, void* wp, int M,
                         int N, int K, int device, void* stream) {
  if (!takes(M, N, K)) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(b), static_cast<float*>(y), static_cast<float*>(wp),
                  M, N, K, device, static_cast<cudaStream_t>(stream));
  });
}

// The gradient of mp_linear for dY = g (M, N): dx (M, K), dw (N, K), db
// (N). Scratch from the caller, 16-byte aligned, with Mk = M rounded up to
// 32: wtp (2K, N) and xtp (2K, Mk) fp32 (W^T's and x^T's tf32 planes),
// part (S, N, K) and dbp (S, N) fp32 (the partials over S slices of M).
extern "C" int mp_linear_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                             void* db, void* wtp, void* xtp, void* part, void* dbp, int M, int N,
                             int K, int S, int device, void* stream) {
  if (!takes(M, N, K) || S < 1) return cudaErrorInvalidValue;
  return mp::on_device(device, [&] {
    return launch_bwd(static_cast<const float*>(x), static_cast<const float*>(w),
                      static_cast<const float*>(g), static_cast<float*>(dx),
                      static_cast<float*>(dw), static_cast<float*>(db), static_cast<float*>(wtp),
                      static_cast<float*>(xtp), static_cast<float*>(part),
                      static_cast<float*>(dbp), M, N, K, S, device,
                      static_cast<cudaStream_t>(stream));
  });
}
