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

// v[0 .. N) rounded to T and stored at dst, N % 4 == 0: 16-byte float4 stores for
// float, 8-byte stores of four packed bf16 otherwise (dst aligned to match).
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
  static_assert(N % 4 == 0, "whole groups of four");
  if constexpr (std::is_same<T, float>::value) {
    float4* o = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    uint2* o = reinterpret_cast<uint2*>(dst);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[4 * q], v[4 * q + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[4 * q + 2], v[4 * q + 3]);
      o[q] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                        *reinterpret_cast<const unsigned*>(&hi));
    }
  }
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

// ---- the 2D AE's first stage: a k=4, s=2, p=1 convolution of C -> F channels ----
// The standalone stage on the CUDA cores (conv0.cu: K6); the fused head (conv_head.cu)
// runs its stage 0 on the tensor cores instead.

// w [F, C, 4, 4] (OIHW) -> ws [tap][c][f], tap = ky * 4 + kx; b [F] -> bs (float).
template <int C, int F, typename T>
__device__ void load_conv_s2_weights(const T* __restrict__ w, const T* __restrict__ b,
                                     float* ws, float* bs) {
  for (int i = threadIdx.x; i < 16 * C * F; i += blockDim.x) {   // i = OIHW index
    const int tap = i % 16, c = (i / 16) % C, f = i / (16 * C);
    ws[(tap * C + c) * F + f] = to_f32(w[i]);
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) bs[i] = to_f32(b[i]);
}

// Input window [XW, XW, C] of sample n with rows [iy0, iy0 + XW) and columns
// [ix0, ix0 + XW) of the image x [B, P, P, C] (NHWC), widened to float in shared
// memory; zero outside the image.  A pixel is one load: 16 or 32 bytes of float,
// 8 or 16 bytes of bfloat16 (C = 4 or 8).
template <int C, int XW, typename T>
__device__ void load_window(const T* __restrict__ x, int P, int n, int iy0, int ix0,
                            float* xw) {
  static_assert(C % 4 == 0, "whole float4 pixels");
  for (int i = threadIdx.x; i < XW * XW; i += blockDim.x) {
    const int iy = iy0 + i / XW, ix = ix0 + i % XW;
    float4* dst = reinterpret_cast<float4*>(xw + i * C);
    if (iy >= 0 && iy < P && ix >= 0 && ix < P) {
      const T* px = x + (((size_t)n * P + iy) * P + ix) * C;
      if constexpr (std::is_same<T, float>::value) {
        const float4* src = reinterpret_cast<const float4*>(px);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) dst[q] = src[q];
      } else {
        using Vec = typename std::conditional<C == 4, uint2, uint4>::type;
        const Vec v = *reinterpret_cast<const Vec*>(px);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float2 lo = __bfloat1622float2(h[2 * q]);
          const float2 hi = __bfloat1622float2(h[2 * q + 1]);
          dst[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < C / 4; ++q) dst[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[f] = sum_{ky, kx, c} xw[2 py + ky, 2 px + kx, c] * ws[tap][c][f]: the
// pre-activation (without bias) of the output whose 4 x 4 input patch starts at
// window position (2 py, 2 px).
template <int C, int F, int XW>
__device__ __forceinline__ void conv_s2_taps(const float* xw, const float* ws, int py,
                                             int px, float acc[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) {
      const float* xp = xw + ((2 * py + ky) * XW + 2 * px + kx) * C;
      const float* wp = ws + (ky * 4 + kx) * C * F;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float xv = xp[c];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += xv * wp[c * F + f];
      }
    }
  }
}

}  // namespace lshm
