// The 2D AE's first stage alone for sm_90a: elu(conv0(x) + b), k=4, s=2, p=1,
// C -> 8 channels (K6), on the tensor cores.
//
// Replaces benchmarks/pallas_conv_probe.py::_kernel (called through conv0_pallas), the
// calibration probe that timed one stage of the head against the compiler's own
// convolution.
//
// Layouts: x NHWC [B, P, P, C] (C = 4 or 8, template), w OIHW [8, C, 4, 4], b [8],
// out NHWC [B, P/2, P/2, 8]; any even P, any B.
//
// Storage type T (template) of x, w, b and the output: float, or __nv_bfloat16 (the
// probe's default dtype, as in JAX).  The TPU kernel's function: its dot sums in
// float32 (`preferred_element_type`) and the ELU's result is cast once.  Here the sums
// are float32 on the tensor cores, the bias is added and the ELU taken in float32
// (elu_fast: expm1 within 0.9 ulp), and only the store rounds to T.
//
// GEMM form.  An m-tile is 16 consecutive output pixels of one output row; N = 8 = F,
// one n-tile; K = 16 C in the order (ky, kx, c), in k-steps of 16: one per ky at C = 4
// (k = (kx, c)), two per ky at C = 8 (kx 0-1, then kx 2-3).  Each k-step's product
// starts from zero and is added to the float32 sum in k-step order, since the tensor
// cores' own accumulation truncates.  The B fragments (w as [(ky, kx, c)][f]) are
// built once per block in registers, in lane order.
//
// Window layout.  A tile is R output rows (R = 8 at C = 4, 4 at C = 8) by 64 output
// columns of one sample.  Its window is the 2R + 2 input rows from image row 2R ty - 1
// and the 130 input columns from image column 128 tx - 1, zeros outside the image,
// each window row contiguous in shared memory.  So the four taps (kx = 0 .. 3) of the
// tile's output column j in one input row are window pixels 2j .. 2j + 3: the pixel
// pairs j and j + 1.  At C = 4 a bf16 pair is 16 bytes, one ldmatrix row: row j of the
// ky k-step's A is pairs j and j + 1 (k 0-7, k 8-15), and the 8 rows of one 8 x 8
// matrix are 8 consecutive pairs, 128 contiguous bytes, free of bank conflicts.  (The
// TPU kernel's space-to-depth packing, come back as an address pattern with no
// relayout.)  At C = 8 a bf16 pixel is one 16-byte chunk, and the rows of a matrix lie
// 32 bytes apart; window pixel p sits at chunk p ^ ((p >> 3) & 1), which puts them in 8
// distinct bank groups.  A window row starts at an odd image column, so its pairs
// straddle the 16-byte chunks of device memory: a bf16 copy is one pixel (cp.async of
// 8 bytes at C = 4, 16 at C = 8), as in conv_head.cu's load_window_async; a thread
// copies a pixel pair per iteration (two copies, one address).
//
// float32: float32 K3/K4/K5's recipe.  The window arrives as float32 (cp.async of 16
// bytes) in a raw buffer; each thread splits the chunks it copied itself into three
// exact bf16 pieces laid out as above; w is split once per block; each k-step runs the
// six piece pairs of mma_pairs.
//
// Work.  Warp w takes the m-tile column w % 4 and R / 2 consecutive output rows, and
// sums kGroup of them together (all four in float32; two in bf16, 68 registers against
// 94 for four and no slower on an H100), so that the fragments of each input row are
// loaded once for the output rows of the group that reach that row (as ky and ky + 2).
// Stores go straight from the accumulator fragments: a warp's store covers 8 pixels x 8
// channels, 128 contiguous bytes in bf16, 256 in float32.  The ELU is elu_fast below,
// not expm1f.
//
// Feeding device memory.  A fixed grid of two blocks on each of the 132 SMs walks the
// tiles in order, with the windows of the block's next kDepth tiles in flight while
// one computes: three in bf16 (four window buffers, 74,880 bytes at C = 4), one in
// float32 (its raw window is free once split; 93,600 bytes).  Little's law: 3.35 TB/s
// x ~1 us / 132 SMs is ~25 KB outstanding per SM; a window is 18.7 KB in bf16 and
// 37.4 KB raw in float32 at C = 4.  Tiles next to each other, in flight on neighbouring
// blocks at once, share two input rows: the second read comes from L2.  The edges (any
// even P) are masked: zeros in, no store out.
//
// Where the time goes (variants of this kernel timed on an H100 80GB HBM3 at 700 W,
// bf16 at C = 4, B = 420): the loads alone take 20 us (2.8 TB/s), loads, products and
// stores without the ELU 32 to 36 us, the whole kernel 45 to 49 us; float32: the loads
// and splits alone 46 us, the splits 18 of the whole 85 to 87 us, the ELU 13.  So the
// kernel is bound by its instruction issue on the SMs (per output: the ELU's ~20
// instructions, and in float32 the split), not by the tensor cores (products left out:
// 43 of 48 us in bf16, 84 of 85 in float32) nor, in bf16, by the bytes.
//
// Bound on the H100 at B=420, P=128, C=4: float32 reads 110.1 MB and writes 55.1 MB
// (49 us at 3.35 TB/s); its 1.76 GFLOP take 10.7 us on the tensor cores as six bf16
// piece pairs each (10.6 GFLOP at 989 TFLOP/s; 26 us on the FP32 units), so it is
// bound by bytes.  bf16 moves half the bytes, 82.6 MB (24.6 us), and its operations
// take 1.8 us on the tensor cores: bound by bytes too.

#include "mma.cuh"

namespace {

using namespace lshm::tc;

constexpr int kF = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMCols = 4;                  // m-tiles across a tile
constexpr int kTW = 16 * kMCols;           // output columns of a tile: 64
constexpr int kWW = 2 * kTW + 2;           // window pixels of a row: 130
constexpr int kSMs = 132;                  // the H100's: the fixed grid fills every SM

template <int C, typename T>
struct Cfg {
  static constexpr int kPc = kPiecesOf<T>;
  static constexpr int R = C == 4 ? 8 : 4;               // output rows of a tile
  static constexpr int kRows = 2 * R + 2;                // window rows
  static constexpr int kRowB = kWW * C * 2;              // bytes of a bf16 window row
  static constexpr int kWinB = kRows * kRowB;            // of a bf16 window (or piece)
  static constexpr int kRpw = R * kMCols / kWarps;       // output rows of a warp
  static constexpr int kGroup = kPc == 1 ? 2 : kRpw;     // of them summed at once
  static constexpr int kSteps = C / 4;                   // k-steps of one ky
  // tiles whose windows are in flight while one computes, and the buffers they take:
  // bf16 kDepth + 1 windows [kRows][130][C] (the one computing and those arriving);
  // float32 kDepth raw float32 windows, freed as soon as each is split, and the
  // pieces [3][kRows][130][C] of the one computing
  static constexpr int kDepth = kPc == 1 ? 3 : 1;
  static constexpr int kSlots = kPc == 1 ? kDepth + 1 : kDepth;
  static constexpr int kSlotB = kPc == 1 ? kWinB : 2 * kWinB;
  static constexpr int oSlot = kPc == 1 ? 0 : kPieces * kWinB;
  static constexpr int bytes = oSlot + kSlots * kSlotB;
  static constexpr int per_sm = 2;                       // resident blocks per SM
  static_assert(per_sm * (bytes + 1024) <= 228 * 1024, "blocks per SM fit");
  static_assert(kRowB % 16 == 0 && oSlot % 16 == 0, "16-byte aligned ldmatrix rows");
  static_assert(kRpw * kWarps == R * kMCols && kRpw % kGroup == 0, "whole rows per warp");
};

struct Tile {
  int n, ty, tx;
};

__device__ __forceinline__ Tile decode_tile(int t, int tpc, int tpr) {
  Tile r;
  r.n = t / (tpc * tpr);
  const int rem = t % (tpc * tpr);
  r.ty = rem / tpr;
  r.tx = rem % tpr;
  return r;
}

// Byte offset of window pixel p in a bf16 window row: 8-byte pixels in order at C = 4;
// 16-byte pixels at C = 8, pixel p in chunk p ^ ((p >> 3) & 1).
template <int C>
__device__ __forceinline__ int pix_off(int p) {
  return C == 4 ? 8 * p : 16 * (p ^ ((p >> 3) & 1));
}

// Window of tile t, asynchronously, zeros outside the image, a pair of pixels (p, p +
// 1) at a time, pair i of the window (row i / 65, p = 2 (i mod 65)) by thread i mod
// blockDim.x: bf16 one pixel a copy into win; float32 16 bytes a copy into raw
// [kRows][130][C], where pair i is chunks [i C / 2, (i + 1) C / 2).  Offsets inside one
// sample fit an int (P^2 C < 2^31).
template <int C, typename T>
__device__ void load_window(const T* __restrict__ x, int P, Tile t, unsigned char* dst) {
  using S = Cfg<C, T>;
  const int iy0 = 2 * S::R * t.ty - 1, ix0 = 2 * kTW * t.tx - 1;
  const T* xs = x + (size_t)t.n * P * P * C;
  for (int i = threadIdx.x; i < S::kRows * kWW / 2; i += kThreads) {
    const int r = i / (kWW / 2), p = 2 * (i - r * (kWW / 2)), iy = iy0 + r, ix = ix0 + p;
    const bool row = (unsigned)iy < (unsigned)P;
    const bool in0 = row && (unsigned)ix < (unsigned)P;
    const bool in1 = row && (unsigned)(ix + 1) < (unsigned)P;
    const T* src = xs + (iy * P + ix) * C;
    if constexpr (S::kPc == 1) {
      const unsigned d = saddr(dst + r * S::kRowB);
      cp_async<2 * C>(d + pix_off<C>(p), in0 ? src : x, in0 ? 2 * C : 0);
      cp_async<2 * C>(d + pix_off<C>(p + 1), in1 ? src + C : x, in1 ? 2 * C : 0);
    } else {
      const unsigned d = saddr(dst + 8 * C * i);
#pragma unroll
      for (int c = 0; c < C / 4; ++c) {
        cp_async<16>(d + 16 * c, in0 ? src + 4 * c : x, in0 ? 16 : 0);
        cp_async<16>(d + 4 * C + 16 * c, in1 ? src + C + 4 * c : x, in1 ? 16 : 0);
      }
    }
  }
}

// elu(a) = a for a > 0, else expm1(a), within 0.9 ulp of expm1 in float32
// (tests/test_torch_conv0_tc.py transliterates it): a = t ln2 + z with |z| <= ln2 / 2
// (Cody and Waite's two-part ln2), expm1(a) = 2^t expm1(z) + (2^t - 1), expm1(z) by
// its Taylor polynomial to z^8.  t = rint(a log2 e) comes from adding 1.5 * 2^23, whose
// low bits then hold t, and 2^t from t's bits: some 20 instructions on the FP32 and
// integer units, none on the conversion unit.  (expm1f's general form, with special
// values and ldexpf, took 24 of the bf16 kernel's 56 us; with rintf and a float-to-int
// conversion in place of the additions, 49.)  Below a = -87, expm1(a) rounds to -1, as
// it does at -87.
__device__ __forceinline__ float elu_fast(float a) {
  const float b = fmaxf(fminf(a, 0.0f), -87.0f);
  const float r = fmaf(b, 1.44269504f, 12582912.0f);        // 1.5 * 2^23 + t
  const float t = r - 12582912.0f;
  float z = fmaf(t, -0.693145752f, b);       // t ln2_hi exact: |t| < 2^7, 15-bit ln2_hi
  z = fmaf(t, -1.42860677e-6f, z);
  float p = 2.48015873e-5f;                  // 1/8!, 1/7!, ..., 1/2
  p = fmaf(p, z, 1.98412698e-4f);
  p = fmaf(p, z, 1.38888889e-3f);
  p = fmaf(p, z, 8.33333333e-3f);
  p = fmaf(p, z, 4.16666667e-2f);
  p = fmaf(p, z, 1.66666667e-1f);
  p = fmaf(p, z, 0.5f);
  p = fmaf(p * z, z, z);                     // expm1(z)
  // 2^t: r's bits are 0x4B400000 + t, so (t + 127) << 23 is (bits(r) + 127) << 23
  const float s = __int_as_float((__float_as_int(r) + 127) << 23);
  return a <= 0.0f ? fmaf(s, p, s - 1.0f) : a;    // a NaN stays NaN
}

// The pixel pairs of raw that this thread copied (its own cp.async writes are visible
// to it after the wait; load_window's assignment) into three exact bf16 pieces
// (split3), kWinB bytes apart, in the window layout.
template <int C>
__device__ void split_window(const float* raw, unsigned char* win) {
  using S = Cfg<C, float>;
  for (int i = threadIdx.x; i < S::kRows * kWW / 2; i += kThreads) {
    const int r = i / (kWW / 2), p = 2 * (i - r * (kWW / 2));
#pragma unroll
    for (int h = 0; h < C / 2; ++h) {      // the pair's 16-byte chunks
      const float4 v = reinterpret_cast<const float4*>(raw)[i * (C / 2) + h];
      const int off = r * S::kRowB + pix_off<C>(p + h / (C / 4)) + 8 * (h % (C / 4));
      float pc[4][kPieces];
      split3(v.x, pc[0]);
      split3(v.y, pc[1]);
      split3(v.z, pc[2]);
      split3(v.w, pc[3]);
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        *reinterpret_cast<uint2*>(win + k * S::kWinB + off) =
            make_uint2(pack(pc[0][k], pc[1][k]), pack(pc[2][k], pc[3][k]));
    }
  }
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads, Cfg<C, T>::per_sm)
conv0_tc_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                int P, int tpc, int tpr, int ntiles, T* __restrict__ out) {
  using S = Cfg<C, T>;
  constexpr int kPc = S::kPc, kRpw = S::kRpw, kGroup = S::kGroup, kSteps = S::kSteps;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const int H = P / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int mcol = warp % kMCols, row0 = warp / kMCols * kRpw;   // of the tile

  // the window of the block's it-th tile into its slot, if that tile exists; one
  // commit group per tile either way
  auto load = [&](int it) {
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile < ntiles)
      load_window<C, T>(x, P, decode_tile(tile, tpc, tpr),
                        sm + S::oSlot + it % S::kSlots * S::kSlotB);
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < S::kDepth; ++it) load(it);

  // B fragments of k-step s (k = 16 s + .., k = (ky * 4 + kx) * C + c, n = f) in the
  // pieces of T, and this lane's two biases
  uint2 bw[C][kPc];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    auto W = [&](int k) { return lshm::to_f32(w[(g * C + k % C) * 16 + k / C]); };
    const int k = 16 * s + 2 * q;
    const float v[4] = {W(k), W(k + 1), W(k + 8), W(k + 9)};
    float pc[4][kPc];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<kPc>(v[e], pc[e]);
#pragma unroll
    for (int p = 0; p < kPc; ++p)
      bw[s][p] = make_uint2(pack(pc[0][p], pc[1][p]), pack(pc[2][p], pc[3][p]));
  }
  const float bias0 = lshm::to_f32(b[2 * q]), bias1 = lshm::to_f32(b[2 * q + 1]);

  // this lane's ldmatrix row in a window row, per k-step of a ky: A row lane % 16 (the
  // tile's output column j), k half lane / 16; at C = 4 the pair j + k half, at C = 8
  // pixel 2 j + 2 s + k half
  const int j = 16 * mcol + lane % 16, kh = lane / 16;
  int lane_off[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    lane_off[s] = C == 4 ? pix_off<C>(2 * j + 2 * kh) : pix_off<C>(2 * j + 2 * s + kh);

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const Tile t = decode_tile(tile, tpc, tpr);
    cp_async_wait<S::kDepth - 1>();
    __syncthreads();                       // window it in; tile it - 1 done computing
    unsigned char* win = sm + S::oSlot + it % S::kSlots * S::kSlotB;
    if constexpr (kPc > 1) {
      split_window<C>(reinterpret_cast<const float*>(win), sm);
      win = sm;
      __syncthreads();                     // the window's pieces in; its raw slot free
    }
    load(it + S::kDepth);

    T* os = out + (size_t)t.n * H * H * kF;
#pragma unroll
    for (int r0 = row0; r0 < row0 + kRpw; r0 += kGroup) {   // the warp's rows in groups
      const int oy0 = S::R * t.ty + r0, ox0 = kTW * t.tx + 16 * mcol;
      if (oy0 >= H || ox0 >= H) continue;  // the group's m-tiles all outside the image
      const unsigned base = saddr(win + 2 * r0 * S::kRowB);
      float acc[kGroup][4] = {};
#pragma unroll
      for (int r = 0; r < 2 * kGroup + 2; ++r) {   // the group's input rows
        unsigned a[kSteps][kPc][4];
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
          for (int k = 0; k < kPc; ++k)
            ldsm_x4(base + k * S::kWinB + r * S::kRowB + lane_off[s], a[s][k]);
#pragma unroll
        for (int o = 0; o < kGroup; ++o) {         // the output rows that reach it
          const int ky = r - 2 * o;
          if (ky < 0 || ky > 3) continue;
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            if constexpr (kPc == 1) {
              float part[4] = {};                  // each k-step alone, added in float32
              mma(part, a[s][0], bw[ky * kSteps + s][0].x, bw[ky * kSteps + s][0].y);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[o][i] += part[i];
            } else {
              mma_pairs(acc[o], a[s], bw[ky * kSteps + s]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kGroup; ++o) {
        const int oy = oy0 + o;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = ox0 + g + 8 * h;
          if (oy < H && ox < H)
            store_pair(os + (oy * H + ox) * kF + 2 * q, elu_fast(acc[o][2 * h] + bias0),
                       elu_fast(acc[o][2 * h + 1] + bias1));
        }
      }
    }
  }
  cp_async_wait_all();
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* b, int B, int P, void* out,
           cudaStream_t stream) {
  using S = Cfg<C, T>;
  const int H = P / 2;
  const int tpc = (H + S::R - 1) / S::R, tpr = (H + kTW - 1) / kTW;
  const int ntiles = B * tpc * tpr;
  if (ntiles == 0) return (int)cudaSuccess;
  cudaError_t err = lshm::allow_smem(conv0_tc_kernel<C, T>, S::bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = ntiles < S::per_sm * kSMs ? ntiles : S::per_sm * kSMs;
  conv0_tc_kernel<C, T><<<grid, kThreads, S::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), P, tpc,
      tpr, ntiles, static_cast<T*>(out));
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
