// Accuracy of fp32 products on the tensor cores against fp64 on the host:
// one warp per 16 x 8 output tile of A (M, K) . B (N, K)^T with the
// operands split as mlp.cu splits them (mma.cuh), accumulated four ways:
//   one_acc    - all of K in one mma accumulator (3xTF32)
//   promote_8  - an mma accumulator per 8 k-steps (64 of k), added into an
//                fp32 sum, as the kernels do per stage
//   promote_1  - a fresh mma accumulator per k-step, as mma_step_fresh
//   tf32       - one tf32 pass, one accumulator
//   simt       - an fmaf loop in fp32
// and on wgmma, accumulating as K5's wgmma kernel does (a warpgroup per
// 64 x 64 tile, 3xTF32 small parts first; here both operands' planes lie
// in shared memory, where the kernel keeps A in registers):
//   wgmma_one_acc     - all of K in one wgmma accumulator
//   wgmma_promote_32  - a fresh accumulator per 32 of k, added into an fp32 sum
//   wgmma_promote_64  - the same per 64 of k
// for K = 512, 1024, 4096, on inputs of both signs (x ~ N(0, 1), w ~
// U(+-1/sqrt(K))) and of one sign (U(0, 1) and U(0, 1/sqrt(K))). Built and
// run by run_probes.py.
#include <cmath>
#include <cstdio>
#include <vector>

#include "../csrc/mma.cuh"
#include "../csrc/wgmma.cuh"

enum Way { kOneAcc, kPromote8, kPromote1, kTf32, kSimt, kWgmmaOne, kWgmma32, kWgmma64, kWays };
static const char* kNames[] = {"one_acc", "promote_8", "promote_1", "tf32", "simt",
                               "wgmma_one_acc", "wgmma_promote_32", "wgmma_promote_64"};

// One warpgroup per 64 x 64 tile of A (M, K) . B (64, K)^T on wgmma: each
// 32 of k split into plain-layout planes (wgmma.cuh), 4 k-steps x 3
// products; the accumulator is added into an fp32 sum every ``every``
// k-steps (0: never).
__global__ void __launch_bounds__(128) wgmma_product(const float* A, const float* B,
                                                     float* out, int K, int every) {
  using namespace mp::wg;
  __shared__ __align__(1024) uint8_t planes[4][8192];  // A big, A small, B big, B small
  const int m0 = blockIdx.x * 64, lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float sum[32], d[32];
  for (int e = 0; e < 32; ++e) sum[e] = d[e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    for (int item = threadIdx.x; item < 2 * 512; item += 128) {
      const int op = item >> 9, r = (item >> 3) & 63, q = item & 7;
      const float* src = (op ? B : A + static_cast<long long>(m0) * K) + r * K + k0 + 4 * q;
      const uint32_t w[4] = {__float_as_uint(src[0]), __float_as_uint(src[1]),
                             __float_as_uint(src[2]), __float_as_uint(src[3])};
      uint32_t p[2][4];
      mp::Mma<float>::split(w, p);
      const int off = (q >> 1) * 2048 + (q & 1) * 1024 + (r >> 3) * 128 + (r & 7) * 16;
      for (int part = 0; part < 2; ++part) {
        *reinterpret_cast<uint4*>(planes[2 * op + part] + off) =
            make_uint4(p[part][0], p[part][1], p[part][2], p[part][3]);
      }
    }
    fence_async();
    __syncthreads();
    mma_fence();
    for (int s = 0; s < 4; ++s) {
      const int step = k0 / 8 + s;
      const bool fresh = every ? step % every == 0 : step == 0;
      const uint64_t ab = desc_plain(sa(planes[0]) + 2048 * s);
      const uint64_t as = desc_plain(sa(planes[1]) + 2048 * s);
      const uint64_t bb = desc_plain(sa(planes[2]) + 2048 * s);
      const uint64_t bs = desc_plain(sa(planes[3]) + 2048 * s);
      mma(d, as, bb, fresh ? 0 : 1);
      mma(d, ab, bs, 1);
      mma(d, ab, bb, 1);
    }
    mma_commit();
    mma_wait<0>();
    pin(d);
    const int steps = k0 / 8 + 4;
    if (every && (steps % every == 0 || k0 + 32 >= K)) {
      for (int e = 0; e < 32; ++e) sum[e] += d[e];
    }
    __syncthreads();  // every thread's wgmma done before the planes are rewritten
  }
  for (int e = 0; e < 32; ++e) {
    const int r = m0 + 16 * wi + g + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * t + (e & 1);
    out[r * 64 + c] = every ? sum[e] : d[e];
  }
}

__global__ void product(const float* A, const float* B, float* out, int N, int K,
                        int way) {
  const int m0 = (blockIdx.x / (N / 8)) * 16, n0 = (blockIdx.x % (N / 8)) * 8;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, part[4] = {0.f, 0.f, 0.f, 0.f};
  if (way == kSimt) {
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + (e >> 1) * 8, c = n0 + 2 * t + (e & 1);
      for (int k = 0; k < K; ++k) acc[e] = fmaf(A[r * K + k], B[c * K + k], acc[e]);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) {
      const uint32_t aw[4] = {
          __float_as_uint(A[(m0 + g) * K + k0 + t]),
          __float_as_uint(A[(m0 + g + 8) * K + k0 + t]),
          __float_as_uint(A[(m0 + g) * K + k0 + t + 4]),
          __float_as_uint(A[(m0 + g + 8) * K + k0 + t + 4])};
      const uint32_t bw[2] = {__float_as_uint(B[(n0 + g) * K + k0 + t]),
                              __float_as_uint(B[(n0 + g) * K + k0 + t + 4])};
      uint32_t a[2][4], b[2][2];
      mp::Mma<float>::split(aw, a);
      mp::Mma<float>::split(bw, b);
      if (way == kTf32) {
        mp::mma_tf32(acc, a[0], b[0]);
        continue;
      }
      float (&d)[4] = way == kOneAcc ? acc : part;
      for (int pass = 0; pass < 3; ++pass) mp::Mma<float>::mma(d, a, b, pass);
      const int every = way == kPromote8 ? 8 : 1;
      if (way != kOneAcc && ((k0 / 8 + 1) % every == 0 || k0 + 8 >= K)) {
        for (int e = 0; e < 4; ++e) {
          acc[e] += part[e];
          part[e] = 0.f;
        }
      }
    }
  }
  for (int e = 0; e < 4; ++e) {
    out[(m0 + g + (e >> 1) * 8) * N + n0 + 2 * t + (e & 1)] = acc[e];
  }
}

static unsigned long long state = 88172645463325252ull;
static double uniform() {
  state ^= state << 13;
  state ^= state >> 7;
  state ^= state << 17;
  return (state >> 11) * (1.0 / 9007199254740992.0);
}
static double normal() {
  return sqrt(-2.0 * log(uniform() + 1e-300)) * cos(6.283185307179586 * uniform());
}

int main() {
  const int M = 1024, N = 64;
  for (int K : {512, 1024, 4096}) {
    for (int signs = 2; signs >= 1; --signs) {
      std::vector<float> A(M * K), B(N * K);
      for (auto& a : A) a = signs == 2 ? (float)normal() : (float)uniform();
      for (auto& b : B) {
        const double u = signs == 2 ? 2.0 * uniform() - 1.0 : uniform();
        b = (float)(u / sqrt((double)K));
      }
      std::vector<double> ref(M * N);
      double mag = 0.0;
      for (int r = 0; r < M; ++r)
        for (int c = 0; c < N; ++c) {
          double s = 0.0;
          for (int k = 0; k < K; ++k) s += (double)A[r * K + k] * B[c * K + k];
          ref[r * N + c] = s;
          mag = fmax(mag, fabs(s));
        }
      float *dA, *dB, *dO;
      cudaMalloc(&dA, sizeof(float) * M * K);
      cudaMalloc(&dB, sizeof(float) * N * K);
      cudaMalloc(&dO, sizeof(float) * M * N);
      cudaMemcpy(dA, A.data(), sizeof(float) * M * K, cudaMemcpyHostToDevice);
      cudaMemcpy(dB, B.data(), sizeof(float) * N * K, cudaMemcpyHostToDevice);
      for (int way = 0; way < kWays; ++way) {
        if (way >= kWgmmaOne) {
          const int every = way == kWgmmaOne ? 0 : way == kWgmma32 ? 4 : 8;
          wgmma_product<<<M / 64, 128>>>(dA, dB, dO, K, every);
        } else {
          product<<<(M / 16) * (N / 8), 32>>>(dA, dB, dO, N, K, way);
        }
        std::vector<float> o(M * N);
        cudaMemcpy(o.data(), dO, sizeof(float) * M * N, cudaMemcpyDeviceToHost);
        double err = 0.0, bias = 0.0;
        for (int i = 0; i < M * N; ++i) {
          err = fmax(err, fabs(o[i] - ref[i]));
          bias += o[i] - ref[i];
        }
        printf("accumulate K %4d %s signs %-16s: max err %.3g (%.3g of |ref|max %.3g), "
               "mean err %.3g\n", K, signs == 2 ? "both" : "one ", kNames[way], err,
               err / mag, mag, bias / (M * N));
      }
      cudaFree(dA);
      cudaFree(dB);
      cudaFree(dO);
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("accumulate: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
