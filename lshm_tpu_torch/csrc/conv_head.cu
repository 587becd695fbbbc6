// Fused 2D-AE encoder head for sm_90a: elu(conv1(elu(conv0(x) + b0)) + b1), both
// convolutions k=4, s=2, p=1 — forward (K3), weight-gradient backward (K4) and
// input-gradient backward (K5).
//
// Replaces lshm_tpu/kernels/conv2d_outer.py::_fwd_kernel, ::_bwd_kernel and
// ::_dx_kernel.
//
// Layouts: x NHWC [B, P, P, C] (the data layout, one load a pixel), weights in
// PyTorch's OIHW (w0 [F0, C, 4, 4], w1 [F1, F0, 4, 4]), output NHWC [B, P/4, P/4, F1].
// C is 4 or 8 (template), F0 = 8 and F1 = 12 (the ladder's first two widths).
//
// Storage type T (template) of x, the weights, the biases, g1 and the output (dx for
// K5): float, or __nv_bfloat16 for the bfloat16 compute modes.  Everything inside is
// float32: the window and the weights are widened in shared memory, so bf16 products
// are exact and every sum is a float32 sum in the same (ky, kx, c) order as the float
// kernel.  In bf16, as in the TPU kernel, the stage-0 activation e0 is rounded to bf16
// (the TPU kernel stores it in x's dtype), stage 1 sums over the rounded e0, and the
// output is rounded to bf16; K4 and K5 take elu' of the unrounded float a0, K4 sums dW1
// over the rounded e0 and dW0 over x's bf16 values and returns float32 sums (the
// wrapper casts them to the weights' dtype); K5 keeps dpre1 in float32 (the TPU
// kernel's z1 scratch is float32) and rounds only dx to bf16.
//
// Tiling: one tile = one sample's 8 x 8 block of stage-1 outputs.  It needs an 18 x 18
// block of stage-0 outputs (the tile plus a 1-pixel halo at stride 2), which needs a
// 38 x 38 input window.  A block stages the window (23 KB for C = 4) and the weights
// (2,048 floats) in shared memory, computes the 18 x 18 x F0 stage-0 tile into
// shared memory, and then the 8 x 8 x F1 outputs: the stage-0 activation never goes
// to device memory.  Stage-0 positions outside the image are conv1's zero padding and
// are stored as 0, not elu(b0) — the TPU kernel zeroes the same borders.  The TPU
// kernel's double space-to-depth packing only worked around Mosaic's missing strided
// slices and is not needed here: the block reads the strided taps directly.  The
// stage-0 helpers are in common.cuh, shared with the standalone stage (conv0.cu).
//
// Backward, weights (K4): a fixed grid of blocks walks the tiles in a fixed order.
// Per tile it recomputes both stages, forms dpre1 = g1 * elu'(a1), accumulates dW1
// and db1, back-propagates to the 18 x 18 stage-0 tile through w1, multiplies by
// elu'(a0) (zero on the padding ring) and accumulates dW0 and db0.  Partitioning over
// stage-1 outputs is exact: a block adds only its own outputs' share of each halo
// position's gradient, so nothing is counted twice.  Each block keeps its sums in
// shared memory (each entry owned by one thread) and writes one row of partials
// [nblocks, 2068 for C = 4]; a second pass adds the rows in a fixed order, so two
// runs are bit-identical.
//
// Backward, input (K5), in two passes, each element a gather with no float atomics
// (the TPU kernel's packed dY4 @ W0big^T scatters through the packing instead), so
// two runs are bit-identical:
//   1. dpre1 = g1 * elu'(a1) [B, P/4, P/4, F1] to device memory, float32 in either
//      storage type (20.6 MB at B = 420): the forward kernel with another epilogue.
//   2. One block per 32 x 32 input tile.  Its inputs reach stage-0 positions of the
//      same 18 x 18 halo tile as the forward's, which reach a 10 x 10 tile of dpre1.
//      The block stages the 38 x 38 window, recomputes elu'(a0) on the halo tile,
//      gathers dpre0 = elu'(a0) * conv1^T(dpre1) there (zero on the padding ring) and
//      gathers dx = conv0^T(dpre0) for its 32 x 32 x C inputs.
//
// Bound on the H100 at the main path's shapes (B=420, P=128, C=4), float32: the
// forward reads 110.1 MB and writes 20.6 MB (39 us at 3.35 TB/s) and does 3.08 GFLOP
// (46 us at 67 TFLOP/s FP32 without tensor cores), so it is bound by operations; the
// weight backward reads 130.7 MB and does 7.5 GFLOP (112 us), also bound by operations;
// the input backward moves 240.8 MB (72 us) and does 6.17 GFLOP (92 us), bound by
// operations.  bfloat16: the forward and the weight backward each move 65.4 MB (x
// 55.05 MB plus the output or g1, 10.32 MB: 19.5 us), and their 3.08 and 7.5 GFLOP
// take 3.1 and 7.6 us on the bf16 tensor cores (989 TFLOP/s; bf16 products are exact
// in a float32 sum), so both are bound by bytes; the input backward must move 120.4 MB
// (x and dx 55.05 MB each, g1: 35.9 us) against 6.2 us of operations, bound by bytes,
// and its two passes move 216.8 MB (x twice, the float32 dpre1 written and read).
// These kernels use the CUDA cores.

#include "common.cuh"

namespace {

constexpr int kF0 = 8;
constexpr int kF1 = 12;
constexpr int kT1 = 8;                 // stage-1 tile edge
constexpr int kT0 = 2 * kT1 + 2;       // stage-0 tile edge incl. halo: 18
constexpr int kXW = 2 * kT0 + 2;       // input window edge: 38
constexpr int kTD = kT1 + 2;           // dpre1 tile edge of the input backward: 10
constexpr int kTX = 4 * kT1;           // input tile edge of the input backward: 32
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
  static constexpr int dp = kTD * kTD * kF1;        // dpre1 tile of the input backward
  static constexpr int nacc = 16 * C * kF0 + kF0 + 16 * kF0 * kF1 + kF1;
  // offsets of the gradient vector [dW0 (OIHW) | db0 | dW1 (OIHW) | db1]
  static constexpr int oW0 = 0, oB0 = 16 * C * kF0, oW1 = oB0 + kF0,
                       oB1 = oW1 + 16 * kF0 * kF1;
  static constexpr size_t fwd_bytes = sizeof(float) * (xw + w0 + kF0 + w1 + kF1 + s0);
  static constexpr size_t bwd_bytes =
      sizeof(float) * (xw + w0 + kF0 + w1 + kF1 + 2 * s0 + kT1 * kT1 * kF1 + nacc);
  static constexpr size_t dx_bytes =
      sizeof(float) * (xw + w0 + kF0 + w1 + kF1 + 2 * s0 + dp);
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

template <int C, typename T>
__device__ void load_weights(const T* __restrict__ w0, const T* __restrict__ b0,
                             const T* __restrict__ w1, const T* __restrict__ b1,
                             float* w0s, float* b0s, float* w1s, float* b1s) {
  lshm::load_conv_s2_weights<C, kF0>(w0, b0, w0s, b0s);
  for (int i = threadIdx.x; i < 16 * kF0 * kF1; i += blockDim.x) {
    const int tap = i % 16, f0 = (i / 16) % kF0, f1 = i / (16 * kF0);
    w1s[(tap * kF0 + f0) * kF1 + f1] = lshm::to_f32(w1[i]);
  }
  if (threadIdx.x < kF1) b1s[threadIdx.x] = lshm::to_f32(b1[threadIdx.x]);
}

// Input window rows/cols [32 ty - 3, 32 ty + 35) of sample n; zero outside the image.
template <int C, typename T>
__device__ void load_window(const T* __restrict__ x, int P, Tile t, float* xw) {
  lshm::load_window<C, kXW>(x, P, t.n, 32 * t.ty - 3, 32 * t.tx - 3, xw);
}

// Stage 0 on the 18 x 18 tile: e0 = elu(a0) rounded to T inside the image, 0 on the
// padding ring; if d0 is given it receives elu'(a0) of the unrounded a0 inside and 0
// outside.
template <int C, typename T>
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
    lshm::conv_s2_taps<C, kF0, kXW>(xw, w0s, py, px, acc);
#pragma unroll
    for (int f = 0; f < kF0; ++f) {
      const float a = acc[f] + b0s[f];
      e[f] = lshm::round_to<T>(lshm::elu(a));
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

// The forward kernel's output type: T for K3, float for the dpre1 pass of K5.
template <typename T, bool kDpre1>
using OutT = typename std::conditional<kDpre1, float, T>::type;

// kDpre1 = false: out = elu(a1) rounded to T (K3).  kDpre1 = true: out = g1 * elu'(a1)
// in float32, the first pass of the input backward (K5).
template <typename T, int C, bool kDpre1>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ g1, int P, int tps, OutT<T, kDpre1>* __restrict__ out) {
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
  stage0<C, T>(xw, w0s, b0s, P / 2, t, e0, nullptr);
  __syncthreads();
  float a1[kPerGroup];
  if (stage1(e0, w1s, b1s, P / 4, t, a1)) {
    const size_t o = out_index(t, P / 4);
#pragma unroll
    for (int j = 0; j < kPerGroup; ++j) {
      if constexpr (kDpre1) {
        out[o + j] = lshm::to_f32(g1[o + j]) * lshm::elu_grad(a1[j]);
      } else {
        out[o + j] = lshm::from_f32<T>(lshm::elu(a1[j]));
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ g1, int P, int tps, int ntiles,
                float* __restrict__ partial) {
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
    stage0<C, T>(xw, w0s, b0s, H0, t, e0, d0);
    __syncthreads();

    // dpre1 = g1 * elu'(a1); 0 outside the image
    {
      float a1[kPerGroup];
      const int p = tid % (kT1 * kT1), grp = tid / (kT1 * kT1);
      float* dp = dp1 + p * kF1 + grp * kPerGroup;
      if (stage1(e0, w1s, b1s, H1, t, a1)) {
        const T* g = g1 + out_index(t, H1);
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) dp[j] = lshm::to_f32(g[j]) * lshm::elu_grad(a1[j]);
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

// Second pass of the input backward: one block per 32 x 32 input tile (tile (ty, tx)
// covers the inputs of stage-1 tile (ty, tx)).  Halo coordinates: stage-0 position
// py <-> row 16 ty - 1 + py, dpre1 position qy <-> row 8 ty - 1 + qy.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
head_dx_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const float* __restrict__ dpre1, int P, int tps, T* __restrict__ dx) {
  using L = Layout<C>;
  extern __shared__ float4 smem4[];
  float* xw = reinterpret_cast<float*>(smem4);
  float* w0s = xw + L::xw;
  float* b0s = w0s + L::w0;
  float* w1s = b0s + kF0;
  float* b1s = w1s + L::w1;
  float* e0 = b1s + kF1;                  // elu(a0): computed, not used
  float* d0 = e0 + L::s0;                 // elu'(a0), then dpre0 in place
  float* dp1 = d0 + L::s0;                // [10, 10, F1] dpre1, 0 outside the image
  const int H1 = P / 4;
  const int tid = threadIdx.x;
  const Tile t = decode_tile(blockIdx.x, tps);

  load_weights<C>(w0, b0, w1, b1, w0s, b0s, w1s, b1s);
  load_window<C>(x, P, t, xw);
  for (int i = tid; i < L::dp; i += blockDim.x) {
    const int f1 = i % kF1, q = i / kF1;
    const int oy = kT1 * t.ty - 1 + q / kTD, ox = kT1 * t.tx - 1 + q % kTD;
    dp1[i] = (oy >= 0 && oy < H1 && ox >= 0 && ox < H1)
                 ? dpre1[(((size_t)t.n * H1 + oy) * H1 + ox) * kF1 + f1]
                 : 0.0f;
  }
  __syncthreads();
  stage0<C, T>(xw, w0s, b0s, P / 2, t, e0, d0);
  __syncthreads();

  // dpre0[py, px, f0] = elu'(a0) * sum over the taps that reach it (ky = py mod 2)
  for (int i = tid; i < L::s0; i += blockDim.x) {
    const int f0 = i % kF0, pos = i / kF0;
    const int py = pos / kT0, px = pos % kT0;
    float s = 0.0f;
    for (int ky = py & 1; ky < 4; ky += 2) {
      const int qy = (py + 2 - ky) / 2;
      for (int kx = px & 1; kx < 4; kx += 2) {
        const int qx = (px + 2 - kx) / 2;
        const float* dp = dp1 + (qy * kTD + qx) * kF1;
        const float* wp = w1s + ((ky * 4 + kx) * kF0 + f0) * kF1;
#pragma unroll
        for (int f1 = 0; f1 < kF1; ++f1) s += dp[f1] * wp[f1];
      }
    }
    d0[i] = s * d0[i];
  }
  __syncthreads();

  // dx[ry, rx, c] = sum over the taps that reach it (ky = ry + 1 mod 2) and f0
  for (int i = tid; i < kTX * kTX; i += blockDim.x) {
    const int ry = i / kTX, rx = i % kTX;
    const int iy = kTX * t.ty + ry, ix = kTX * t.tx + rx;
    if (iy >= P || ix >= P) continue;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int ky = (ry + 1) & 1; ky < 4; ky += 2) {
      const int py = (ry + 3 - ky) / 2;
      for (int kx = (rx + 1) & 1; kx < 4; kx += 2) {
        const int px = (rx + 3 - kx) / 2;
        const float* dp = d0 + (py * kT0 + px) * kF0;
        const float* wp = w0s + (ky * 4 + kx) * C * kF0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int f0 = 0; f0 < kF0; ++f0) acc[c] += dp[f0] * wp[c * kF0 + f0];
        }
      }
    }
    lshm::store_vec<C>(dx + (((size_t)t.n * P + iy) * P + ix) * C, acc);
  }
}

int tiles_per_side(int P) { return (P / 4 + kT1 - 1) / kT1; }

template <typename T, int C, bool kDpre1>
int fwd(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, const T* g1, int B,
        int P, OutT<T, kDpre1>* out, cudaStream_t stream) {
  using L = Layout<C>;
  cudaError_t err = lshm::allow_smem(head_fwd_kernel<T, C, kDpre1>, L::fwd_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = tiles_per_side(P);
  head_fwd_kernel<T, C, kDpre1><<<B * tps * tps, kThreads, L::fwd_bytes, stream>>>(
      x, w0, b0, w1, b1, g1, P, tps, out);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int bwd(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, const T* g1, int B,
        int P, float* partial, float* grads, cudaStream_t stream) {
  using L = Layout<C>;
  cudaError_t err = lshm::allow_smem(head_bwd_kernel<T, C>, L::bwd_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = tiles_per_side(P);
  const int ntiles = B * tps * tps;
  const int nblk = ntiles < kBwdBlocks ? ntiles : kBwdBlocks;
  head_bwd_kernel<T, C><<<nblk, kThreads, L::bwd_bytes, stream>>>(x, w0, b0, w1, b1, g1, P,
                                                                 tps, ntiles, partial);
  lshm::launch_reduce_partials(partial, nblk, L::nacc, 1.0f, grads, stream);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int dx_pass(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, const T* g1,
            int B, int P, float* dpre1, T* dx, cudaStream_t stream) {
  using L = Layout<C>;
  const int first = fwd<T, C, true>(x, w0, b0, w1, b1, g1, B, P, dpre1, stream);
  if (first != 0) return first;
  cudaError_t err = lshm::allow_smem(head_dx_kernel<T, C>, L::dx_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tps = tiles_per_side(P);
  head_dx_kernel<T, C><<<B * tps * tps, kThreads, L::dx_bytes, stream>>>(
      x, w0, b0, w1, b1, dpre1, P, tps, dx);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_c(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
          int B, int P, int C, void* out, cudaStream_t stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  T* o = static_cast<T*>(out);
  if (C == 4)
    return fwd<T, 4, false>(p(x), p(w0), p(b0), p(w1), p(b1), nullptr, B, P, o, stream);
  if (C == 8)
    return fwd<T, 8, false>(p(x), p(w0), p(b0), p(w1), p(b1), nullptr, B, P, o, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_c(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
          const void* g1, int B, int P, int C, float* partial, float* grads,
          cudaStream_t stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  if (C == 4)
    return bwd<T, 4>(p(x), p(w0), p(b0), p(w1), p(b1), p(g1), B, P, partial, grads, stream);
  if (C == 8)
    return bwd<T, 8>(p(x), p(w0), p(b0), p(w1), p(b1), p(g1), B, P, partial, grads, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dx_c(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
         const void* g1, int B, int P, int C, float* dpre1, void* dx, cudaStream_t stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  T* d = static_cast<T*>(dx);
  if (C == 4)
    return dx_pass<T, 4>(p(x), p(w0), p(b0), p(w1), p(b1), p(g1), B, P, dpre1, d, stream);
  if (C == 8)
    return dx_pass<T, 8>(p(x), p(w0), p(b0), p(w1), p(b1), p(g1), B, P, dpre1, d, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Length of the gradient vector [dW0 | db0 | dW1 | db1] and rows of backward scratch.
int head_grad_len(int C) { return C == 4 ? Layout<4>::nacc : Layout<8>::nacc; }

int head_bwd_blocks(int B, int P) {
  const int n = B * tiles_per_side(P) * tiles_per_side(P);
  return n < kBwdBlocks ? n : kBwdBlocks;
}

// x [B, P, P, C] NHWC, P % 4 == 0, C in {4, 8}; out [B, P/4, P/4, 12] NHWC.  Every
// tensor is float (bf16 = 0) or __nv_bfloat16 (bf16 = 1).
int head_fwd(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
             int B, int P, int C, int bf16, void* out, cudaStream_t stream) {
  return bf16 ? fwd_c<__nv_bfloat16>(x, w0, b0, w1, b1, B, P, C, out, stream)
              : fwd_c<float>(x, w0, b0, w1, b1, B, P, C, out, stream);
}

// g1 [B, P/4, P/4, 12] NHWC, typed like x; partial [head_bwd_blocks, head_grad_len]
// float scratch; grads [head_grad_len] float = dW0 (OIHW) | db0 | dW1 (OIHW) | db1.
int head_bwd(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
             const void* g1, int B, int P, int C, int bf16, float* partial, float* grads,
             cudaStream_t stream) {
  return bf16 ? bwd_c<__nv_bfloat16>(x, w0, b0, w1, b1, g1, B, P, C, partial, grads, stream)
              : bwd_c<float>(x, w0, b0, w1, b1, g1, B, P, C, partial, grads, stream);
}

// g1 [B, P/4, P/4, 12] NHWC, typed like x; dpre1 float scratch shaped like g1; dx
// [B, P, P, C] like x.
int head_dx(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
            const void* g1, int B, int P, int C, int bf16, float* dpre1, void* dx,
            cudaStream_t stream) {
  return bf16 ? dx_c<__nv_bfloat16>(x, w0, b0, w1, b1, g1, B, P, C, dpre1, dx, stream)
              : dx_c<float>(x, w0, b0, w1, b1, g1, B, P, C, dpre1, dx, stream);
}

}  // extern "C"
