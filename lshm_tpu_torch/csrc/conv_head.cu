// Fused 2D-AE encoder head for sm_90a: elu(conv1(elu(conv0(x) + b0)) + b1), both
// convolutions k=4, s=2, p=1 — forward (K3) and weight-gradient backward (K4).
//
// Replaces lshm_tpu/kernels/conv2d_outer.py::_fwd_kernel and ::_bwd_kernel.
//
// Layouts: x NHWC [B, P, P, C] (the data layout, read 16 B a pixel), weights in
// PyTorch's OIHW (w0 [F0, C, 4, 4], w1 [F1, F0, 4, 4]), output NHWC [B, P/4, P/4, F1].
// C is 4 or 8 (template), F0 = 8 and F1 = 12 (the ladder's first two widths).
//
// Tiling: one tile = one sample's 8 x 8 block of stage-1 outputs.  It needs an 18 x 18
// block of stage-0 outputs (the tile plus a 1-pixel halo at stride 2), which needs a
// 38 x 38 input window.  A block stages the window (23 KB for C = 4) and the weights
// (2,048 floats) in shared memory, computes the 18 x 18 x F0 stage-0 tile into
// shared memory, and then the 8 x 8 x F1 outputs: the stage-0 activation never goes
// to device memory.  Stage-0 positions outside the image are conv1's zero padding and
// are stored as 0, not elu(b0) — the TPU kernel zeroes the same borders.  The TPU
// kernel's double space-to-depth packing only worked around Mosaic's missing strided
// slices and is not needed here: the block reads the strided taps directly.
//
// Backward (weights only): a fixed grid of blocks walks the tiles in a fixed order.
// Per tile it recomputes both stages, forms dpre1 = g1 * elu'(a1), accumulates dW1
// and db1, back-propagates to the 18 x 18 stage-0 tile through w1, multiplies by
// elu'(a0) (zero on the padding ring) and accumulates dW0 and db0.  Partitioning over
// stage-1 outputs is exact: a block adds only its own outputs' share of each halo
// position's gradient, so nothing is counted twice.  Each block keeps its sums in
// shared memory (each entry owned by one thread) and writes one row of partials
// [nblocks, 2068 for C = 4]; a second pass adds the rows in a fixed order, so two
// runs are bit-identical.  The input gradient (K5) is not computed here.
//
// Bound on the H100 at the main path's shapes (B=420, P=128, C=4): the forward reads
// 110.1 MB and writes 20.6 MB (39 us at 3.35 TB/s) and does 3.08 GFLOP (46 us at
// 67 TFLOP/s FP32 without tensor cores), so it is bound by operations; the backward
// reads 130.7 MB and does 7.5 GFLOP (112 us), also bound by operations.

#include "common.cuh"

namespace {

constexpr int kF0 = 8;
constexpr int kF1 = 12;
constexpr int kT1 = 8;                 // stage-1 tile edge
constexpr int kT0 = 2 * kT1 + 2;       // stage-0 tile edge incl. halo: 18
constexpr int kXW = 2 * kT0 + 2;       // input window edge: 38
constexpr int kThreads = 256;
constexpr int kBwdBlocks = 264;        // fixed, so the summation order never changes
constexpr int kGroups = kThreads / (kT1 * kT1);   // 4 channel groups in stage 1
constexpr int kPerGroup = kF1 / kGroups;          // 3 stage-1 channels per thread
static_assert(kF1 % kGroups == 0, "stage-1 channel split");

template <int C>
struct Layout {
  static constexpr int xw = kXW * kXW * C;          // input window
  static constexpr int w0 = 16 * C * kF0;           // [tap][c][f0]
  static constexpr int w1 = 16 * kF0 * kF1;         // [tap][f0][f1]
  static constexpr int s0 = kT0 * kT0 * kF0;        // stage-0 tile
  static constexpr int nacc = 16 * C * kF0 + kF0 + 16 * kF0 * kF1 + kF1;
  // offsets of the gradient vector [dW0 (OIHW) | db0 | dW1 (OIHW) | db1]
  static constexpr int oW0 = 0, oB0 = 16 * C * kF0, oW1 = oB0 + kF0,
                       oB1 = oW1 + 16 * kF0 * kF1;
  static constexpr size_t fwd_bytes = sizeof(float) * (xw + w0 + kF0 + w1 + kF1 + s0);
  static constexpr size_t bwd_bytes =
      sizeof(float) * (xw + w0 + kF0 + w1 + kF1 + 2 * s0 + kT1 * kT1 * kF1 + nacc);
};

struct Tile {
  int n, ty, tx;
};

__device__ __forceinline__ Tile decode_tile(int t, int tps) {
  Tile r;
  r.n = t / (tps * tps);
  const int rem = t % (tps * tps);
  r.ty = rem / tps;
  r.tx = rem % tps;
  return r;
}

template <int C>
__device__ void load_weights(const float* __restrict__ w0, const float* __restrict__ b0,
                             const float* __restrict__ w1, const float* __restrict__ b1,
                             float* w0s, float* b0s, float* w1s, float* b1s) {
  for (int i = threadIdx.x; i < 16 * C * kF0; i += blockDim.x) {   // i = OIHW index
    const int tap = i % 16, c = (i / 16) % C, f = i / (16 * C);
    w0s[(tap * C + c) * kF0 + f] = w0[i];
  }
  for (int i = threadIdx.x; i < 16 * kF0 * kF1; i += blockDim.x) {
    const int tap = i % 16, f0 = (i / 16) % kF0, f1 = i / (16 * kF0);
    w1s[(tap * kF0 + f0) * kF1 + f1] = w1[i];
  }
  if (threadIdx.x < kF0) b0s[threadIdx.x] = b0[threadIdx.x];
  if (threadIdx.x < kF1) b1s[threadIdx.x] = b1[threadIdx.x];
}

// Input window rows/cols [32 ty - 3, 32 ty + 35) of sample n; zero outside the image.
template <int C>
__device__ void load_window(const float* __restrict__ x, int P, Tile t, float* xw) {
  const int iy0 = 32 * t.ty - 3, ix0 = 32 * t.tx - 3;
  for (int i = threadIdx.x; i < kXW * kXW; i += blockDim.x) {
    const int iy = iy0 + i / kXW, ix = ix0 + i % kXW;
    float4* dst = reinterpret_cast<float4*>(xw + i * C);
    if (iy >= 0 && iy < P && ix >= 0 && ix < P) {
      const float4* src =
          reinterpret_cast<const float4*>(x + (((size_t)t.n * P + iy) * P + ix) * C);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) dst[q] = src[q];
    } else {
#pragma unroll
      for (int q = 0; q < C / 4; ++q) dst[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Stage 0 on the 18 x 18 tile: e0 = elu(a0) inside the image, 0 on the padding ring;
// if d0 is given it receives elu'(a0) inside and 0 outside.
template <int C>
__device__ void stage0(const float* xw, const float* w0s, const float* b0s, int H0, Tile t,
                       float* e0, float* d0) {
  for (int pos = threadIdx.x; pos < kT0 * kT0; pos += blockDim.x) {
    const int py = pos / kT0, px = pos % kT0;
    const int y0 = 16 * t.ty - 1 + py, x0 = 16 * t.tx - 1 + px;
    float* e = e0 + pos * kF0;
    if (y0 < 0 || y0 >= H0 || x0 < 0 || x0 >= H0) {
#pragma unroll
      for (int f = 0; f < kF0; ++f) {
        e[f] = 0.0f;
        if (d0) d0[pos * kF0 + f] = 0.0f;
      }
      continue;
    }
    float acc[kF0];
#pragma unroll
    for (int f = 0; f < kF0; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const float* xp = xw + ((2 * py + ky) * kXW + 2 * px + kx) * C;
        const float* wp = w0s + (ky * 4 + kx) * C * kF0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float xv = xp[c];
#pragma unroll
          for (int f = 0; f < kF0; ++f) acc[f] += xv * wp[c * kF0 + f];
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kF0; ++f) {
      const float a = acc[f] + b0s[f];
      e[f] = lshm::elu(a);
      if (d0) d0[pos * kF0 + f] = lshm::elu_grad(a);
    }
  }
}

// Stage-1 pre-activations for this thread's output position and channel group.
// Returns false when the position lies outside the image.
__device__ __forceinline__ bool stage1(const float* e0, const float* w1s, const float* b1s,
                                       int H1, Tile t, float a1[kPerGroup]) {
  const int p = threadIdx.x % (kT1 * kT1), grp = threadIdx.x / (kT1 * kT1);
  const int oyl = p / kT1, oxl = p % kT1;
  if (kT1 * t.ty + oyl >= H1 || kT1 * t.tx + oxl >= H1) return false;
#pragma unroll
  for (int j = 0; j < kPerGroup; ++j) a1[j] = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) {
      const float* sp = e0 + ((2 * oyl + ky) * kT0 + 2 * oxl + kx) * kF0;
      const float* wp = w1s + (ky * 4 + kx) * kF0 * kF1 + grp * kPerGroup;
#pragma unroll
      for (int f0 = 0; f0 < kF0; ++f0) {
        const float v = sp[f0];
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) a1[j] += v * wp[f0 * kF1 + j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerGroup; ++j) a1[j] += b1s[grp * kPerGroup + j];
  return true;
}

__device__ __forceinline__ size_t out_index(Tile t, int H1) {
  const int p = threadIdx.x % (kT1 * kT1), grp = threadIdx.x / (kT1 * kT1);
  const int oy = kT1 * t.ty + p / kT1, ox = kT1 * t.tx + p % kT1;
  return (((size_t)t.n * H1 + oy) * H1 + ox) * kF1 + grp * kPerGroup;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, int P, int tps, float* __restrict__ out) {
  using L = Layout<C>;
  extern __shared__ float4 smem4[];
  float* xw = reinterpret_cast<float*>(smem4);
  float* w0s = xw + L::xw;
  float* b0s = w0s + L::w0;
  float* w1s = b0s + kF0;
  float* b1s = w1s + L::w1;
  float* e0 = b1s + kF1;
  const Tile t = decode_tile(blockIdx.x, tps);
  load_weights<C>(w0, b0, w1, b1, w0s, b0s, w1s, b1s);
  load_window<C>(x, P, t, xw);
  __syncthreads();
  stage0<C>(xw, w0s, b0s, P / 2, t, e0, nullptr);
  __syncthreads();
  float a1[kPerGroup];
  if (stage1(e0, w1s, b1s, P / 4, t, a1)) {
    float* o = out + out_index(t, P / 4);
#pragma unroll
    for (int j = 0; j < kPerGroup; ++j) o[j] = lshm::elu(a1[j]);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ g1, int P, int tps,
                int ntiles, float* __restrict__ partial) {
  using L = Layout<C>;
  extern __shared__ float4 smem4[];
  float* xw = reinterpret_cast<float*>(smem4);
  float* w0s = xw + L::xw;
  float* b0s = w0s + L::w0;
  float* w1s = b0s + kF0;
  float* b1s = w1s + L::w1;
  float* e0 = b1s + kF1;                  // elu(a0), 0 on the padding ring
  float* d0 = e0 + L::s0;                 // elu'(a0), then dpre0 in place
  float* dp1 = d0 + L::s0;                // [64, F1] dpre1
  float* acc = dp1 + kT1 * kT1 * kF1;     // [nacc] this block's gradient sums
  const int H0 = P / 2, H1 = P / 4;
  const int tid = threadIdx.x;

  load_weights<C>(w0, b0, w1, b1, w0s, b0s, w1s, b1s);
  for (int i = tid; i < L::nacc; i += blockDim.x) acc[i] = 0.0f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = decode_tile(tile, tps);
    load_window<C>(x, P, t, xw);
    __syncthreads();
    stage0<C>(xw, w0s, b0s, H0, t, e0, d0);
    __syncthreads();

    // dpre1 = g1 * elu'(a1); 0 outside the image
    {
      float a1[kPerGroup];
      const int p = tid % (kT1 * kT1), grp = tid / (kT1 * kT1);
      float* dp = dp1 + p * kF1 + grp * kPerGroup;
      if (stage1(e0, w1s, b1s, H1, t, a1)) {
        const float* g = g1 + out_index(t, H1);
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) dp[j] = g[j] * lshm::elu_grad(a1[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) dp[j] = 0.0f;
      }
    }
    __syncthreads();

    // dW1 (OIHW index) and db1
    for (int i = tid; i < 16 * kF0 * kF1; i += blockDim.x) {
      const int kx = i % 4, ky = (i / 4) % 4, f0 = (i / 16) % kF0, f1 = i / (16 * kF0);
      float s = 0.0f;
      for (int p = 0; p < kT1 * kT1; ++p) {
        const int oyl = p / kT1, oxl = p % kT1;
        s += dp1[p * kF1 + f1] * e0[((2 * oyl + ky) * kT0 + 2 * oxl + kx) * kF0 + f0];
      }
      acc[L::oW1 + i] += s;
    }
    if (tid < kF1) {
      float s = 0.0f;
      for (int p = 0; p < kT1 * kT1; ++p) s += dp1[p * kF1 + tid];
      acc[L::oB1 + tid] += s;
    }
    // dpre0 = (this tile's share of d e0) * elu'(a0), written over d0
    for (int i = tid; i < L::s0; i += blockDim.x) {
      const int f0 = i % kF0, pos = i / kF0;
      const int py = pos / kT0, px = pos % kT0;
      float s = 0.0f;
      for (int ky = py & 1; ky < 4; ky += 2) {
        const int oyl = (py - ky) / 2;
        if (oyl < 0 || oyl >= kT1) continue;
        for (int kx = px & 1; kx < 4; kx += 2) {
          const int oxl = (px - kx) / 2;
          if (oxl < 0 || oxl >= kT1) continue;
          const float* dp = dp1 + (oyl * kT1 + oxl) * kF1;
          const float* wp = w1s + ((ky * 4 + kx) * kF0 + f0) * kF1;
#pragma unroll
          for (int f1 = 0; f1 < kF1; ++f1) s += dp[f1] * wp[f1];
        }
      }
      d0[i] = s * d0[i];
    }
    __syncthreads();

    // dW0 (OIHW index) and db0
    for (int i = tid; i < 16 * C * kF0; i += blockDim.x) {
      const int kx = i % 4, ky = (i / 4) % 4, c = (i / 16) % C, f0 = i / (16 * C);
      float s = 0.0f;
      for (int pos = 0; pos < kT0 * kT0; ++pos) {
        const int py = pos / kT0, px = pos % kT0;
        s += d0[pos * kF0 + f0] * xw[((2 * py + ky) * kXW + 2 * px + kx) * C + c];
      }
      acc[L::oW0 + i] += s;
    }
    if (tid < kF0) {
      float s = 0.0f;
      for (int pos = 0; pos < kT0 * kT0; ++pos) s += d0[pos * kF0 + tid];
      acc[L::oB0 + tid] += s;
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * L::nacc;
  for (int i = tid; i < L::nacc; i += blockDim.x) out[i] = acc[i];
}

int tiles_per_side(int P) { return (P / 4 + kT1 - 1) / kT1; }

template <int C>
int fwd(const float* x, const float* w0, const float* b0, const float* w1, const float* b1,
        int B, int P, float* out, cudaStream_t stream) {
  using L = Layout<C>;
  cudaError_t err = lshm::allow_smem(head_fwd_kernel<C>, L::fwd_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = tiles_per_side(P);
  head_fwd_kernel<C><<<B * tps * tps, kThreads, L::fwd_bytes, stream>>>(x, w0, b0, w1, b1,
                                                                        P, tps, out);
  return (int)cudaGetLastError();
}

template <int C>
int bwd(const float* x, const float* w0, const float* b0, const float* w1, const float* b1,
        const float* g1, int B, int P, float* partial, float* grads, cudaStream_t stream) {
  using L = Layout<C>;
  cudaError_t err = lshm::allow_smem(head_bwd_kernel<C>, L::bwd_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = tiles_per_side(P);
  const int ntiles = B * tps * tps;
  const int nblk = ntiles < kBwdBlocks ? ntiles : kBwdBlocks;
  head_bwd_kernel<C><<<nblk, kThreads, L::bwd_bytes, stream>>>(x, w0, b0, w1, b1, g1, P,
                                                              tps, ntiles, partial);
  lshm::launch_reduce_partials(partial, nblk, L::nacc, 1.0f, grads, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Length of the gradient vector [dW0 | db0 | dW1 | db1] and rows of backward scratch.
int head_grad_len(int C) { return C == 4 ? Layout<4>::nacc : Layout<8>::nacc; }

int head_bwd_blocks(int B, int P) {
  const int n = B * tiles_per_side(P) * tiles_per_side(P);
  return n < kBwdBlocks ? n : kBwdBlocks;
}

// x [B, P, P, C] NHWC, P % 4 == 0, C in {4, 8}; out [B, P/4, P/4, 12] NHWC.
int head_fwd(const float* x, const float* w0, const float* b0, const float* w1,
             const float* b1, int B, int P, int C, float* out, cudaStream_t stream) {
  if (C == 4) return fwd<4>(x, w0, b0, w1, b1, B, P, out, stream);
  if (C == 8) return fwd<8>(x, w0, b0, w1, b1, B, P, out, stream);
  return (int)cudaErrorInvalidValue;
}

// g1 [B, P/4, P/4, 12] NHWC; partial [head_bwd_blocks, head_grad_len] scratch;
// grads [head_grad_len] = dW0 (OIHW) | db0 | dW1 (OIHW) | db1.
int head_bwd(const float* x, const float* w0, const float* b0, const float* w1,
             const float* b1, const float* g1, int B, int P, int C, float* partial,
             float* grads, cudaStream_t stream) {
  if (C == 4) return bwd<4>(x, w0, b0, w1, b1, g1, B, P, partial, grads, stream);
  if (C == 8) return bwd<8>(x, w0, b0, w1, b1, g1, B, P, partial, grads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
