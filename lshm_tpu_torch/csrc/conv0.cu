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
// Design: staged as the fused head's stage 0 is (conv_head.cu), with the same helpers
// from common.cuh.  One block per sample x 16 x 16 output tile stages a 34 x 34 input
// window (18.5 KB for C = 4) and the weights in shared memory; each of its 256
// threads computes the 8 channels of one output from registers and writes them as
// two 16-byte stores.  The TPU kernel's space-to-depth packing (one matmul over the
// packed grid, then four shifted adds) fed Mosaic's matrix unit and is not needed on
// CUDA cores: a thread reads the strided taps directly.
//
// Bound on the H100 at B=420, P=128, C=4: it reads 110.1 MB and writes 55.1 MB
// (49 us at 3.35 TB/s) and does 1.76 GFLOP (26 us at 67 TFLOP/s FP32), so it is bound
// by bytes: the window is read from device memory about once (34^2 / 32^2 = 1.13x).

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

template <int C>
__global__ void __launch_bounds__(kThreads)
conv0_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, int P, int tps, float* __restrict__ out) {
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
  float4* o = reinterpret_cast<float4*>(out + (((size_t)n * H + oy) * H + ox) * kF);
  o[0] = make_float4(lshm::elu(acc[0] + bs[0]), lshm::elu(acc[1] + bs[1]),
                     lshm::elu(acc[2] + bs[2]), lshm::elu(acc[3] + bs[3]));
  o[1] = make_float4(lshm::elu(acc[4] + bs[4]), lshm::elu(acc[5] + bs[5]),
                     lshm::elu(acc[6] + bs[6]), lshm::elu(acc[7] + bs[7]));
}

template <int C>
int launch(const float* x, const float* w, const float* b, int B, int P, float* out,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>();
  cudaError_t err = lshm::allow_smem(conv0_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = (P / 2 + kT - 1) / kT;
  conv0_kernel<C><<<B * tps * tps, kThreads, bytes, stream>>>(x, w, b, P, tps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, P, P, C] NHWC, P % 2 == 0, C in {4, 8}; out [B, P/2, P/2, 8] NHWC.
int conv0_fwd(const float* x, const float* w, const float* b, int B, int P, int C,
              float* out, cudaStream_t stream) {
  if (C == 4) return launch<4>(x, w, b, B, P, out, stream);
  if (C == 8) return launch<8>(x, w, b, B, P, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
