// Helpers shared by the port's CUDA kernels: 4-element vector loads and
// stores for fp32 and bf16 (every kernel computes in fp32), the device
// guard around a launch, and the C entry point that names a CUDA error
// code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mp {

enum DType : int { kF32 = 0, kBF16 = 1 };

// Four consecutive elements widened to fp32. The pointer is 16-byte
// (fp32) or 8-byte (bf16) aligned; the Python wrappers check it.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four fp32 values rounded (to nearest even) to the element type.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Runs ``launch`` with ``device`` current, then makes the caller's device
// current again, so a launch never moves the runtime's current device
// from under PyTorch. Returns the launch's error, else the guard's.
template <typename F>
cudaError_t on_device(int device, F launch) {
  cudaGetLastError();  // clear an error left by an earlier call
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaError_t launched = launch();
  err = cudaSetDevice(prev);
  return launched != cudaSuccess ? launched : err;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace mp

extern "C" const char* mp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
