// Peak rate of mma.sync on the card: every warp issues 16 independent
// m16n8k8 tf32 (or m16n8k16 bf16) products per iteration on register
// operands, nothing else. Prints TFLOP/s for 4, 8 and 16 warps a block, 4
// blocks per SM. Built and run by run_probes.py.
#include <cstdint>
#include <cstdio>

template <int KIND>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i);
  float c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (KIND == 0) {
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int t = 0; t < 16; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * 4 * sms * 16 * 32);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  const int iters = 4096;
  for (int kind = 0; kind < 2; ++kind) {
    for (int warps : {4, 8, 16}) {
      const int blocks = 4 * sms;
      auto kernel = kind == 0 ? mma_loop<0> : mma_loop<1>;
      kernel<<<blocks, 32 * warps>>>(out, 16);  // warm-up
      cudaEventRecord(start);
      kernel<<<blocks, 32 * warps>>>(out, iters);
      cudaEventRecord(end);
      cudaEventSynchronize(end);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, start, end);
      const double per_mma = kind == 0 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16;
      const double flops = per_mma * 16.0 * iters * warps * blocks;
      printf("mma_rate %s, %2d warps a block: %.1f TFLOP/s\n",
             kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps, flops / ms * 1e-9);
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("mma_rate: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
