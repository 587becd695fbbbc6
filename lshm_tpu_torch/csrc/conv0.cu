// The 2D AE's first stage alone for sm_90a: elu(conv0(x) + b), k=4, s=2, p=1,
// C -> 8 channels (K6).
//
// Replaces benchmarks/pallas_conv_probe.py::_kernel (called through conv0_pallas), the
// calibration probe that timed one stage of the head against the compiler's own
// convolution.
//
// Layouts: x NHWC [B, P, P, C] (C = 4 or 8, template), w OIHW [8, C, 4, 4], b [8],
// out NHWC [B, P/2, P/2, 8].
//
// Storage type T (template) of x, w, b and the output: float, or __nv_bfloat16 (the
// probe's default dtype, as in JAX).  Everything inside is float32: the window and the
// weights are widened in shared memory, so bf16 products are exact, the taps are summed
// in float32 in the float kernel's order, the bias is added and the ELU taken in
// float32, and only the store rounds to bf16 — the TPU kernel's function (its dot sums
// in float32, `preferred_element_type`, and the ELU's result is cast once).
//
// Design: staged as the fused head's stage 0 is (conv_head.cu), with the same helpers
// from common.cuh.  One block per sample x 16 x 16 output tile stages a 34 x 34 input
// window (18.5 KB for C = 4) and the weights in shared memory; each of its 256
// threads computes the 8 channels of one output from registers and writes them as
// two 16-byte stores (float) or one 16-byte store (bf16).  The TPU kernel's
// space-to-depth packing (one matmul over the packed grid, then four shifted adds) fed
// Mosaic's matrix unit and is not needed on CUDA cores: a thread reads the strided taps
// directly.
//
// Bound on the H100 at B=420, P=128, C=4: float32 reads 110.1 MB and writes 55.1 MB
// (49 us at 3.35 TB/s) and does 1.76 GFLOP (26 us at 67 TFLOP/s FP32), so it is bound
// by bytes: the window is read from device memory about once (34^2 / 32^2 = 1.13x).
// bf16 moves half the bytes, 82.6 MB (24.6 us), and its operations take 1.8 us on the
// bf16 tensor cores, so it is bound by bytes too.  This kernel uses the CUDA cores.

#include "common.cuh"

namespace {

constexpr int kF = 8;
constexpr int kT = 16;                 // output tile edge
constexpr int kXW = 2 * kT + 2;        // input window edge: 34
constexpr int kThreads = kT * kT;

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kXW * kXW * C + 16 * C * kF + kF);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
conv0_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
             int P, int tps, T* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* xw = reinterpret_cast<float*>(smem4);
  float* ws = xw + kXW * kXW * C;
  float* bs = ws + 16 * C * kF;
  const int n = blockIdx.x / (tps * tps);
  const int ty = (blockIdx.x / tps) % tps, tx = blockIdx.x % tps;
  const int H = P / 2;
  lshm::load_conv_s2_weights<C, kF>(w, b, ws, bs);
  lshm::load_window<C, kXW>(x, P, n, 2 * kT * ty - 1, 2 * kT * tx - 1, xw);
  __syncthreads();
  const int py = threadIdx.x / kT, px = threadIdx.x % kT;
  const int oy = kT * ty + py, ox = kT * tx + px;
  if (oy >= H || ox >= H) return;
  float acc[kF];
  lshm::conv_s2_taps<C, kF, kXW>(xw, ws, py, px, acc);
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = lshm::elu(acc[f] + bs[f]);
  lshm::store_vec<kF>(out + (((size_t)n * H + oy) * H + ox) * kF, acc);
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* b, int B, int P, void* out,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>();
  cudaError_t err = lshm::allow_smem(conv0_kernel<T, C>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = (P / 2 + kT - 1) / kT;
  conv0_kernel<T, C><<<B * tps * tps, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), P, tps,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* x, const void* w, const void* b, int B, int P, int C, void* out,
             cudaStream_t stream) {
  if (C == 4) return launch<T, 4>(x, w, b, B, P, out, stream);
  if (C == 8) return launch<T, 8>(x, w, b, B, P, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [B, P, P, C] NHWC, P % 2 == 0, C in {4, 8}; out [B, P/2, P/2, 8] NHWC.  Every
// tensor is float (bf16 = 0) or __nv_bfloat16 (bf16 = 1).
int conv0_fwd(const void* x, const void* w, const void* b, int B, int P, int C, int bf16,
              void* out, cudaStream_t stream) {
  return bf16 ? launch_c<__nv_bfloat16>(x, w, b, B, P, C, out, stream)
              : launch_c<float>(x, w, b, B, P, C, out, stream);
}

}  // extern "C"
