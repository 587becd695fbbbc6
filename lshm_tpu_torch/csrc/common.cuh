// Shared device helpers for the lshm_tpu_torch CUDA kernels.
//
// Every kernel library exposes plain C entry points (extern "C") that take raw
// device pointers, sizes and a cudaStream_t, launch on that stream and return
// cudaGetLastError() as an int; the Python wrappers (ctypes) raise when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace lshm {

// Storage types: float, or __nv_bfloat16 (the bfloat16 compute modes).  Kernels compute
// in float32 whatever the storage; conversions go through the intrinsics only.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// v rounded to T's precision, kept as float (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float ipow(float x, int n) {  // n >= 0, small
  float acc = 1.0f;
  for (int i = 0; i < n; ++i) acc *= x;
  return acc;
}

__device__ __forceinline__ float elu(float a) { return a > 0.0f ? a : expm1f(a); }

// d elu / d a, written with exp(min(a, 0)) so the untaken branch stays finite.
__device__ __forceinline__ float elu_grad(float a) {
  return a > 0.0f ? 1.0f : expf(fminf(a, 0.0f));
}

// out[j] = (sum_{b = 0 .. nparts-1} part[b * len + j]) / divisor, summed in
// increasing b.  A fixed order (no atomics), so repeated runs are bit-identical.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nparts,
                                       int len, float divisor, float* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float acc = 0.0f;
  for (int b = 0; b < nparts; ++b) acc += part[(size_t)b * len + j];
  out[j] = acc / divisor;
}

inline void launch_reduce_partials(const float* part, int nparts, int len, float divisor,
                                   float* out, cudaStream_t stream) {
  const int threads = 256;
  reduce_partials_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      part, nparts, len, divisor, out);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace lshm
