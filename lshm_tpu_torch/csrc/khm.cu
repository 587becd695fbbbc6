// K-harmonic-means loss, forward (K1) and analytic backward (K2), for sm_90a.
//
// Replaces lshm_tpu/kernels/khm_pallas.py::_fwd_kernel and ::_bwd_kernel.
//
//   d2[i,k] = max(|x_i|^2 + |m_k|^2 - 2 x_i.m_k, 0),  t = d2^(p/2) + eps
//   e_i     = sum_k 1/t_ik                                  (saved for the backward)
//   L       = sum_i K/(e_i + eps) / (N K D)
//   c_ik    = g p d2^(p/2-1) / ((N D) (e_i + eps)^2 t_ik^2)
//   dX_i    = (sum_k c_ik) x_i - sum_k c_ik m_k
//   dM_k    = (sum_i c_ik) m_k - sum_i c_ik x_i
//
// Even p only (the Python wrapper sends odd p to the plain expression, as the JAX
// dispatcher does).  Design: M (K x D f32, 10 KB on the main path) sits in shared
// memory; one warp per row of X, eight rows per block; the grid covers N exactly and
// the tail rows of the last block are masked.  The TPU kernel accumulated the loss
// and dM with += across its sequential grid; blocks here run in parallel in no
// order, so each block writes a partial and a second pass sums the partials in a
// fixed order (common.cuh), with no float atomics: two runs are bit-identical.
//
// Bound on the H100: at the main path's shapes (N=420, D=256, K=10) both passes
// move under 1 MB and do ~2 MFLOP, so they are bound by launch latency, not by
// bytes or operations.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kEps = 1e-9f;

// Loads M into shared memory and |m_k|^2 into mm; returns after a block barrier.
__device__ void load_centroids(const float* __restrict__ M, int K, int D, float* Ms,
                               float* mm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < K * D; i += blockDim.x) Ms[i] = M[i];
  __syncthreads();
  for (int k = warp; k < K; k += kWarps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += Ms[k * D + d] * Ms[k * D + d];
    s = lshm::warp_sum(s);
    if (lane == 0) mm[k] = s;
  }
  __syncthreads();
}

// Copies row x into xr (this warp's slice of shared memory); returns |x|^2.
__device__ float load_row(const float* __restrict__ x, int D, float* xr) {
  const int lane = threadIdx.x % 32;
  float xx = 0.0f;
  for (int d = lane; d < D; d += 32) {
    float v = x[d];
    xr[d] = v;
    xx += v * v;
  }
  __syncwarp();
  return lshm::warp_sum(xx);
}

// d2 between the row in xr and centroid k (all lanes get the value).
__device__ float sq_dist(const float* xr, float xx, const float* Ms, const float* mm,
                         int k, int D) {
  const int lane = threadIdx.x % 32;
  float dot = 0.0f;
  for (int d = lane; d < D; d += 32) dot += xr[d] * Ms[k * D + d];
  dot = lshm::warp_sum(dot);
  return fmaxf(xx + mm[k] - 2.0f * dot, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
khm_fwd_kernel(const float* __restrict__ X, const float* __restrict__ M, int N, int K,
               int D, int p, float* __restrict__ e_out, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* Ms = smem;                 // [K, D]
  float* mm = Ms + K * D;           // [K]
  float* xs = mm + K;               // [kWarps, D]
  float* part = xs + kWarps * D;    // [kWarps]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_centroids(M, K, D, Ms, mm);

  const int row = blockIdx.x * kWarps + warp;
  float contrib = 0.0f;
  if (row < N) {
    float* xr = xs + warp * D;
    const float xx = load_row(X + (size_t)row * D, D, xr);
    float e = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float d2 = sq_dist(xr, xx, Ms, mm, k, D);
      e += 1.0f / (lshm::ipow(d2, p / 2) + kEps);
    }
    if (lane == 0) e_out[row] = e;
    contrib = (float)K / (e + kEps);
  }
  if (lane == 0) part[warp] = contrib;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[w];
    partial[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
khm_bwd_kernel(const float* __restrict__ X, const float* __restrict__ M,
               const float* __restrict__ e_in, const float* __restrict__ g_in, int N,
               int K, int D, int p, float* __restrict__ dX, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* Ms = smem;                 // [K, D]
  float* mm = Ms + K * D;           // [K]
  float* xs = mm + K;               // [kWarps, D]
  float* cs = xs + kWarps * D;      // [kWarps, K]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_centroids(M, K, D, Ms, mm);

  const int row = blockIdx.x * kWarps + warp;
  float* xr = xs + warp * D;
  float* cr = cs + warp * K;
  if (row < N) {
    const float g = *g_in;
    const float xx = load_row(X + (size_t)row * D, D, xr);
    const float ee = e_in[row] + kEps;
    const float denom_e = ((float)N * (float)D) * (ee * ee);
    float crow = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float d2 = sq_dist(xr, xx, Ms, mm, k, D);
      const float t = lshm::ipow(d2, p / 2) + kEps;
      const float c = ((float)p * lshm::ipow(d2, p / 2 - 1)) / (denom_e * t * t) * g;
      if (lane == 0) cr[k] = c;
      crow += c;
    }
    __syncwarp();
    float* dx = dX + (size_t)row * D;
    for (int d = lane; d < D; d += 32) {
      float cm = 0.0f;
      for (int k = 0; k < K; ++k) cm += cr[k] * Ms[k * D + d];
      dx[d] = crow * xr[d] - cm;
    }
  } else {                          // masked tail row: contributes nothing to dM
    for (int d = lane; d < D; d += 32) xr[d] = 0.0f;
    for (int k = lane; k < K; k += 32) cr[k] = 0.0f;
  }
  __syncthreads();
  // this block's share of dM, rows summed in a fixed order
  float* out = partial + (size_t)blockIdx.x * K * D;
  for (int idx = threadIdx.x; idx < K * D; idx += blockDim.x) {
    const int k = idx / D, d = idx % D;
    float cc = 0.0f, cx = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = cs[w * K + k];
      cc += c;
      cx += c * xs[w * D + d];
    }
    out[idx] = cc * Ms[idx] - cx;
  }
}

size_t fwd_smem(int K, int D) { return sizeof(float) * (K * D + K + kWarps * D + kWarps); }
size_t bwd_smem(int K, int D) { return sizeof(float) * (K * D + K + kWarps * D + kWarps * K); }

}  // namespace

extern "C" {

int khm_num_blocks(int N) { return (N + kWarps - 1) / kWarps; }

size_t khm_smem_bytes(int K, int D) {
  const size_t a = fwd_smem(K, D), b = bwd_smem(K, D);
  return a > b ? a : b;
}

// partial: [khm_num_blocks(N)] scratch.  loss: one float.  e: [N].
int khm_fwd(const float* X, const float* M, int N, int K, int D, int p, float* e,
            float* partial, float* loss, cudaStream_t stream) {
  const int nb = khm_num_blocks(N);
  const size_t smem = fwd_smem(K, D);
  cudaError_t err = lshm::allow_smem(khm_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  khm_fwd_kernel<<<nb, kThreads, smem, stream>>>(X, M, N, K, D, p, e, partial);
  lshm::launch_reduce_partials(partial, nb, 1, (float)N * (float)K * (float)D, loss,
                               stream);
  return (int)cudaGetLastError();
}

// g: one float on the device (the loss cotangent).  partial: [nb, K, D] scratch.
int khm_bwd(const float* X, const float* M, const float* e, const float* g, int N, int K,
            int D, int p, float* dX, float* partial, float* dM, cudaStream_t stream) {
  const int nb = khm_num_blocks(N);
  const size_t smem = bwd_smem(K, D);
  cudaError_t err = lshm::allow_smem(khm_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  khm_bwd_kernel<<<nb, kThreads, smem, stream>>>(X, M, e, g, N, K, D, p, dX, partial);
  lshm::launch_reduce_partials(partial, nb, K * D, 1.0f, dM, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
