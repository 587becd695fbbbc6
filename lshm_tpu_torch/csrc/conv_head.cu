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
// K5): float, or __nv_bfloat16 for the bfloat16 compute modes.  K3, K4 and K5 sum on
// the tensor cores in both dtypes: bf16 operands stay bf16 (their products are exact in
// a float32 sum), and float32 operands go in as three bf16 pieces each (below).  In
// bf16, as in the TPU kernel, the stage-0 activation e0 is rounded to bf16
// (the TPU kernel stores it in x's dtype), stage 1 sums over the rounded e0, and the
// output is rounded to bf16; K4 and K5 take elu' of the unrounded float a0, K4 sums dW1
// over the rounded e0 and dW0 over x's bf16 values and returns float32 sums (the
// wrapper casts them to the weights' dtype); K5 keeps dpre1 in float32 (the TPU
// kernel's z1 scratch is float32) and rounds only dx to bf16.
//
// Tiling: one tile = one sample's 8 x 8 block of stage-1 outputs.  It needs an 18 x 18
// block of stage-0 outputs (the tile plus a 1-pixel halo at stride 2), which needs a
// 38 x 38 input window.  A block stages the window and the weights in shared memory,
// computes the 18 x 18 x F0 stage-0 tile into shared memory, and then the 8 x 8 x F1
// outputs: the stage-0 activation never goes to device memory.  Stage-0 positions
// outside the image are conv1's zero padding and are stored as 0, not elu(b0) — the
// TPU kernel zeroes the same borders.  The TPU
// kernel's double space-to-depth packing only worked around Mosaic's missing strided
// slices and is not needed here: the block reads the strided taps directly.
//
// Forward (K3, tc::head_fwd_tc_kernel, its body tc::fwd_tiles): K4's stage 0 (e0
// only) and stage 1, the tensor-core products described below, on a fixed grid of
// blocks walking the tiles with the next tile's window in flight (cp.async).  Per tile:
// stage 0 writes e0 to shared memory (rounded to bf16 in bf16, in three pieces in
// float32), one block-wide sync, stage 1 leaves a1 in registers, and out = elu(a1 +
// b1) is rounded to T and stored where the output lies inside the image (F1 is padded
// to 16; channels 12 .. 15 are never stored).  The weight fragments are loaded once
// per block.  bf16: two bf16 windows (one per buffer), 160 products a tile at C = 4; shared memory 33,504 bytes at
// C = 4 and 57,632 at C = 8, three blocks of 256 threads per SM (ptxas: 71 and 80
// registers, no spills; a fourth block at C = 4 would cap them at 64 and, tried on the
// card, ran no faster).  float32: every operand in three pieces and six piece pairs
// per product, 960 products a tile; the window arrives as float32 in one raw buffer
// that each thread splits, as in float32 K4, so a tile takes three block-wide syncs;
// shared memory 88,768 bytes at C = 4 (pieces 34,656, raw window 23,104, e0 15,552,
// fragments 15,360) and 149,600 at C = 8, two and one blocks per SM (64 and 67
// registers, no spills; unrolling its k-step loops, tried on the card, gained nothing).
// The tensor cores sum a0 in another order than the plain version, so in bf16 an e0
// near a bf16 tie may round the other way and move an output by one ulp: about 1e-4 to
// 2e-4 of the outputs differ (tests/test_torch_head_fwd_tc.py emulates it; chip_smoke.py
// gates the share at 5e-4 and the distance from the head in float64).
//
// Backward, weights (K4): a fixed grid of blocks walks the tiles in a fixed order.
// Per tile it recomputes both stages, forms dpre1 = g1 * elu'(a1), accumulates dW1
// and db1, back-propagates to the 18 x 18 stage-0 tile through w1, multiplies by
// elu'(a0) (zero on the padding ring) and accumulates dW0 and db0.  Partitioning over
// stage-1 outputs is exact: a block adds only its own outputs' share of each halo
// position's gradient, so nothing is counted twice.  Each block writes one row of
// partials [nblocks, 2068 for C = 4]; a second pass adds the rows in a fixed order, so
// two runs are bit-identical.  Both dtypes sum on the tensor cores (below).
//
// Backward, weights, bfloat16 (tc::head_bwd_tc_kernel): the same tiles, grid and rows of
// partials, with every per-tile sum a tensor-core product (mma.sync m16n8k16, bf16
// operands through ldmatrix, float32 accumulators):
//   stage 0  a0 = A0 [384 x 16C] W0, A0 the implicit im2col of the bf16 window: a row's
//            16 (kx, c) values of one ky are 32 contiguous bytes, and since the window
//            starts at image pixel 32 tx - 3 every row starts 16-byte aligned.  The 324
//            halo positions go in four parity classes (py, px mod 2) of 81, each padded
//            to 96 rows (6 m-tiles);
//   stage 1  a1 = A1 [64 x 128] W1 [128 x 16] (F1 padded to 16), A1 e0's taps;
//   dW1     += A1^T dpre1;
//   d e0     per class m-tile, four tap slots: the rows of dpre1 at the stage-1 outputs
//            that reach each position (a zero row where none does) times that tap's w1
//            [16 x 8].  A gather with no atomics; the positions of an m-tile share their
//            taps because they share their class.  dpre0 = d e0 * elu'(a0), with
//            elu'(a0) kept in registers since stage 0 (the same warp, rows and class);
//   dW0     += A0^T dpre0, K = the 384 class rows (the padding rows are zero).
// x, the weights and e0 are exact bf16 operands.  dpre1 and dpre0 are float32 and go in
// as three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = v - hi - mid (exact), one
// product per piece into the same float32 sum: the sums keep float32 accuracy (TF32 or a
// single bf16 rounding would not).  The window stays bf16 in shared memory (11.3 KB at
// C = 4), and the next tile's loads with cp.async while this one computes (two buffers).
// Each warp owns fixed m-tiles of dW0 (over its own positions) and of dW1 (taps 2w, 2w+1)
// in registers across the whole loop; each product's partial starts from zero and is
// added to them in float32, since the tensor cores' own accumulation truncates.  The
// warps' dW0 and bias sums are added in a fixed order at the end.  The tensor cores sum
// a0 in another order than the CUDA cores, so an e0 near a bf16 tie may round the other
// way than in the plain version; chip_smoke.py shows the kernel as far from the float64
// head as the plain float32 version is.
//
// Backward, weights, float32 (tc::head_bwd_f32_tc_kernel): bf16 K4's tiles, grid, class
// order and products, with every float32 operand in three exact bf16 pieces: the window
// x, w0 and w1 (split once per block into the lane-order fragments), e0 (not rounded;
// [3][324][8] bf16) and, as in bf16, dpre1 and dpre0.  Each product of two split
// operands runs, per k-step, the six piece pairs of order 2^-16 and above (mma_pairs):
// hi.hi into a partial from zero, hi.mid, hi.lo, mid.hi, mid.mid and lo.hi chained into
// a second, their sum added in float32.  mid.lo, lo.mid and lo.lo lie below float32's
// rounding: six pairs come as close to the float64 head as all nine, and closer than a
// float32 sum (tests/test_torch_head_bwd_f32_tc.py emulates the decomposition).  The
// next tile's window arrives as float32 by cp.async into one raw buffer; each thread
// splits the chunks it copied itself into the window's pieces, once per tile, so a tile
// takes four block-wide syncs.  Shared memory at C = 4: window pieces 34.7 KB, raw
// window 23.1, e0 15.6, dpre1 6.2, dpre0 staging 6.1, weight fragments 27.6 (w0 3.1, w1
// for stage 1 and for the gather 12.3 each): 113,440 bytes, two blocks of 256 threads
// per SM; at C = 8 174,272 bytes, one block.  To fit two blocks' 128 registers a thread,
// the float32 stage 0, stage 1 and gather keep their k-step loops rolled and dW1 loads
// its B fragments one n-tile at a time.
//
// Backward, input (K5), in two passes, each element a gather with no float atomics
// (the TPU kernel's packed dY4 @ W0big^T scatters through the packing instead), so
// two runs are bit-identical; both passes on the tensor cores in both dtypes, each a
// fixed grid walking the tiles with the next tile's loads in flight (cp.async).
//   1. tc::dpre1_tc_kernel: K3's kernel (tc::fwd_tiles, its grid, shared memory and
//      blocks per SM) with the other epilogue, dpre1 = g1 * elu'(a1 + b1) stored in
//      float32 in either storage type [B, P/4, P/4, F1] (20.6 MB at B = 420; the TPU
//      kernel's z1 scratch is float32).
//   2. tc::head_dx_tc_kernel, per 32 x 32 input tile: the window and dpre1's 10 x 10
//      halo (zeros outside the image) arrive by cp.async; the halo goes to shared memory
//      as three exact bf16 pieces, F1 padded to 16.  Stage 0 runs in K4's class order,
//      elu'(a0) kept in registers (0 on the ring).  d e0 is K4's gather per class
//      m-tile, four tap slots, except that a position (cls_y + 2 qy, cls_x + 2 qx) takes
//      halo row (qy + 1 - s / 2, qx + 1 - s % 2), always inside the halo.  dpre0 = d e0
//      * elu'(a0) goes in three pieces to shared memory for all 324 positions
//      ([3][324][8] bf16), since dx needs positions across classes.  dx is a product
//      too: the 32 x 32 pixels go in four parity classes (ry, rx mod 2) of 16 x 16,
//      one m-tile per class row; every pixel of a class takes the same four taps, ky =
//      1 - ry % 2 + 2 ty at stage-0 row ry / 2 + 1 + ry % 2 - ty, and likewise in x, so
//      the A rows are dpre0 rows picked by address.  A k-step pairs two taps (K = 2 x
//      8 f0), B is w0 for that pair [16 x C padded to 8]: 2 k-steps per m-tile, each
//      product from zero and added in float32, the sum rounded once to T and staged so
//      that whole pixels leave in 16-byte stores.
//      bf16: two bf16 windows (one per buffer); the d e0 gather and the dx product run
//      one product per piece of dpre1 and dpre0 against the exact bf16 weights.
//      float32: as float32 K4, the window arrives as float32 in one raw buffer that each
//      thread splits into three pieces, and every operand is in three pieces (x, w0 and
//      w1 split once per block into the lane-order fragments, dpre1, dpre0); stage 0,
//      the gather and the dx product run the six pairs of mma_pairs, and dx leaves
//      unrounded.  The dx staging tile (16 KB at C = 4) takes the window pieces' space,
//      free after stage 0, so that two blocks fit on an SM.  Five block-wide syncs a tile.
//   Budgets (ptxas_report, no spills): pass 1 is K3's kernel, with 72 / 80 registers
//   in bf16 and 75 / 75 in float32 (C = 4 / 8).  Pass 2, bf16: 73,312 / 105,632 bytes
//   of shared memory, 124 / 128 registers, two blocks per SM.  Pass 2, float32: 114,112
//   bytes at C = 4 (window pieces 34,656, raw window 23,104, two raw dpre1 halos 9,600,
//   dpre1 pieces 9,600, dpre0 pieces 15,552, fragments 21,504: w0 3,072, w1 for the
//   gather 12,288, w0 for dx 6,144; biases 96; stage 1's unused fragments in dpre0's
//   space), 118 registers, two blocks per SM; 174,944 bytes and 125 registers at C = 8,
//   one block.  Tried on the card at C = 4 and dropped: one block per SM (slower), the
//   gather's slot loop unrolled (spills, slower), dx stored from the accumulators
//   without the staging tile (no faster).
//
// Bound on the H100 at the main path's shapes (B=420, P=128, C=4), float32: the
// forward reads 110.1 MB and writes 20.6 MB (39 us at 3.35 TB/s) and does 3.08 GFLOP,
// which take 19 us on the tensor cores at float32's accuracy (six bf16 piece pairs
// each, 18.5 GFLOP at 989 TFLOP/s; 46 us on the FP32 units), so it is bound by bytes;
// the weight backward reads 130.7 MB and does 7.5 GFLOP, which take 45 us on the tensor
// cores at float32's accuracy (six bf16 piece pairs each, 44.9 GFLOP at 989 TFLOP/s;
// 112 us on the FP32 units), bound by operations; the input backward moves 240.8 MB
// (72 us) and does 6.17 GFLOP, which take 37 us on the tensor cores at float32's
// accuracy (six bf16 piece pairs each, 37 GFLOP; 92 us on the FP32 units), bound by
// bytes, and its two passes move 392.2 MB (x twice, g1, the float32 dpre1 written and
// read, dx; 117 us).  bfloat16: the forward and
// the weight backward each move 65.4 MB (x 55.05 MB plus the output or g1, 10.32 MB:
// 19.5 us), and their 3.08 and 7.5 GFLOP take 3.1 and 7.6 us on the bf16 tensor cores
// (989 TFLOP/s; bf16 products are exact in a float32 sum), so both are bound by bytes;
// the input backward must move 120.4 MB (x and dx 55.05 MB each, g1: 35.9 us) against
// 6.2 us of operations, bound by bytes, and its two passes move 216.8 MB (x twice, the
// float32 dpre1 written and read; 65 us).
// K3 runs 160 tensor-core products a tile in bf16 and 960 in float32 at C = 4 (with the
// padding 4.4 and 26.4 GFLOP: 4.5 and 27 us at 989 TFLOP/s), so what binds it lies
// elsewhere.  Its tiles move 140 KB (bf16) and 465 KB (float32) through shared memory
// (the windows' copies and splits, the ldmatrix and fragment loads, e0): at 128 bytes a
// clock and 1.98 GHz, with 51 tiles per SM, 28 and 94 us before bank conflicts, which
// stage 0's and stage 1's ldmatrix rows (32 bytes apart) make two-way; an estimate, not
// a measurement.  float32 K5 runs 2,880 tensor-core products a tile at C = 4 (pass 1
// K3's 960, pass 2 1,920: stage 0 and the gather 576 each, dx 768; with the six pairs
// and the padding 79.3 GFLOP, 80 us at 989 TFLOP/s), more than its byte bound.
// float32 K4 runs 2,496 tensor-core products a tile at C = 4 (with the six pairs and the
// padding 68.7 GFLOP, 69 us at 989 TFLOP/s) and moves its 130.7 MB once (39 us); like
// bf16 K4 it is bound by what is left on the CUDA cores, and has more of it: four
// block-wide syncs a tile, 8,368 float32 values split a tile (the window's 5,776, e0's
// 2,592), about twice bf16 K4's ldmatrix traffic.  bf16 K4 runs 928 tensor-core products a
// tile at C = 4 (with the pieces and the padding 25.5 GFLOP, 26 us at 989 TFLOP/s) and
// moves its 65.4 MB once (19.5 us); what is left on the CUDA cores binds it: three
// block-wide syncs a tile, the exps of elu(a0), elu'(a0) and elu'(a1), the piece splits
// and the fragment addressing.  bf16 K5 runs 928 products a tile too (pass 1 160,
// pass 2 768: 25.5 GFLOP, 26 us) and is bound the same way: six block-wide syncs a tile
// over both passes, 5,952 exps, 3,792 float32 values split into pieces, with 16 to 24
// warps per SM to hide the ldmatrix -> mma chains.

#include "mma.cuh"

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

template <int C>
struct Layout {   // the gradient vector [dW0 (OIHW) | db0 | dW1 (OIHW) | db1]
  static constexpr int nacc = 16 * C * kF0 + kF0 + 16 * kF0 * kF1 + kF1;
  static constexpr int oW0 = 0, oB0 = 16 * C * kF0, oW1 = oB0 + kF0,
                       oB1 = oW1 + 16 * kF0 * kF1;
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

// ---- Backward, weights, bfloat16 (K4 bf16) on the tensor cores ----
//
// Every per-tile sum is an mma.sync m16n8k16 product (bf16 operands, float32
// accumulators) fed by ldmatrix from shared memory; the header gives the design, and
// mma.cuh the primitives and their fragment layouts (g = lane / 4, q = lane % 4).

namespace tc {

using namespace lshm::tc;   // the primitives of mma.cuh
constexpr int kWarps = kThreads / 32;       // 8
constexpr int kHalf = kT0 / 2;              // 9: a parity class's positions along an edge
constexpr int kClassPos = kHalf * kHalf;    // 81 stage-0 positions of a parity class
constexpr int kClassTiles = (kClassPos + 15) / 16;   // in 6 m-tiles (96 rows)
constexpr int kMt0 = 4 * kClassTiles;       // 24 stage-0 m-tiles
constexpr int kMtPerWarp = kMt0 / kWarps;   // 3
constexpr int kP1 = kT1 * kT1;              // 64 stage-1 outputs of a tile
constexpr int kDpRows = kP1 + 1;            // dpre1 rows of a piece, the last one zero
constexpr int kF1P = 16;                    // F1 padded to two n-tiles
constexpr int kPos0 = kT0 * kT0;           // 324 stage-0 positions
static_assert(kMt0 % kWarps == 0, "stage-0 m-tiles per warp");
static_assert(kWarps == 2 * (kP1 / 16), "one stage-1 (m, n) tile per warp");
static_assert(kWarps == 16 * kF0 / 16, "one dW1 m-tile per warp");

template <int C>
struct Smem {   // byte offsets; every array 16-byte aligned
  static constexpr int win = kXW * kXW * C;                          // bf16, one buffer
  static constexpr int oWin = 0;                                     // [2][38][38][C]
  static constexpr int oE0 = oWin + 2 * 2 * win;                     // [324][8] bf16
  static constexpr int oDp1 = oE0 + 2 * kT0 * kT0 * kF0;             // [3][65][16] bf16
  static constexpr int oStg = oDp1 + 2 * kPieces * kDpRows * kF1P;   // [8][3][16][8] bf16
  static constexpr int oW0f = oStg + 2 * kWarps * kPieces * 16 * kF0;   // [C][32] uint2
  static constexpr int oW1f = oW0f + 8 * C * 32;                     // [2][8][32] uint2
  static constexpr int oW1g = oW1f + 8 * 2 * 8 * 32;                 // [16][32] uint2
  static constexpr int oBias = oW1g + 8 * 16 * 32;                   // b0 [8], b1 [16]
  static constexpr int bytes = oBias + 4 * (kF0 + kF1P);
  // the end-of-kernel sums reuse the windows: dW0 [8 warps][128 C], db0 and db1 [8][8]
  static constexpr int red = kWarps * 16 * C * kF0 + 2 * kWarps * 8;
  static_assert(4 * red <= 2 * 2 * win, "reduction scratch fits in the windows");
  static_assert(oE0 % 16 == 0 && oDp1 % 16 == 0 && oStg % 16 == 0 && oW0f % 16 == 0,
                "16-byte aligned rows for ldmatrix");
};

// Stage-0 row r (0 .. 95) of parity class cls: tile position (py, px); false for the
// padding rows (81 .. 95), which alias position (cls >> 1, cls & 1).
__device__ __forceinline__ bool class_pos(int cls, int r, int& py, int& px) {
  const bool valid = r < kClassPos;
  const int qy = valid ? r / kHalf : 0, qx = valid ? r % kHalf : 0;
  py = (cls >> 1) + 2 * qy;
  px = (cls & 1) + 2 * qx;
  return valid;
}

// Window of tile t into xw, asynchronously: image rows/cols [32 ty - 3, 32 ty + 35),
// one pixel (2C bytes) a copy, zeros outside the image.
template <int C>
__device__ void load_window_async(const bf16* __restrict__ x, int P, Tile t, bf16* xw) {
  const int iy0 = 32 * t.ty - 3, ix0 = 32 * t.tx - 3;
  for (int i = threadIdx.x; i < kXW * kXW; i += blockDim.x) {
    const int iy = iy0 + i / kXW, ix = ix0 + i % kXW;
    const bool in = iy >= 0 && iy < P && ix >= 0 && ix < P;
    const bf16* src = in ? x + (((size_t)t.n * P + iy) * P + ix) * C : x;
    cp_async<2 * C>(saddr(xw + i * C), src, in ? 2 * C : 0);
  }
}

// The B fragments of the three weight operands, once per block, in lane order, piece p
// of each (one piece for bf16 weights, three for float32): w0f[p][s] stage 0 (k = (ky,
// kx, c) in [16 s, 16 s + 16), n = f0); w1f[p][nt][s] stage 1 (k = taps 2s, 2s + 1 by
// f0, n = f1 in [8 nt, 8 nt + 8)); w1g[p][tap] the d e0 gather (k = f1, n = f0).
// f1 >= 12 is 0.
template <int C, typename T>
__device__ void load_fragments(const T* __restrict__ w0, const T* __restrict__ b0,
                               const T* __restrict__ w1, const T* __restrict__ b1,
                               uint2* w0f, uint2* w1f, uint2* w1g, float* b0s, float* b1s) {
  constexpr int kPc = kPiecesOf<T>;
  auto W0 = [&](int k, int f0) {           // k = (ky * 4 + kx) * C + c
    return lshm::to_f32(w0[(f0 * C + k % C) * 16 + k / C]);
  };
  auto W1 = [&](int f1, int f0, int tap) {
    return f1 < kF1 ? lshm::to_f32(w1[(f1 * kF0 + f0) * 16 + tap]) : 0.0f;
  };
  for (int i = threadIdx.x; i < (C + 16 + 16) * 32; i += blockDim.x) {
    const int lane = i % 32, frag = i / 32, g = lane / 4, q = lane % 4;
    float v[4];                            // b0 = (v[0], v[1]), b1 = (v[2], v[3])
    uint2* dst;
    int stride;                            // between pieces
    if (frag < C) {
      const int k = 16 * frag + 2 * q;
      v[0] = W0(k, g), v[1] = W0(k + 1, g), v[2] = W0(k + 8, g), v[3] = W0(k + 9, g);
      dst = w0f + i;
      stride = 32 * C;
    } else if (frag < C + 16) {
      const int nt = (frag - C) / 8, s = (frag - C) % 8, f1 = 8 * nt + g;
      v[0] = W1(f1, 2 * q, 2 * s), v[1] = W1(f1, 2 * q + 1, 2 * s);
      v[2] = W1(f1, 2 * q, 2 * s + 1), v[3] = W1(f1, 2 * q + 1, 2 * s + 1);
      dst = w1f + i - 32 * C;
      stride = 32 * 16;
    } else {
      const int tap = frag - C - 16;
      v[0] = W1(2 * q, g, tap), v[1] = W1(2 * q + 1, g, tap);
      v[2] = W1(2 * q + 8, g, tap), v[3] = W1(2 * q + 9, g, tap);
      dst = w1g + i - 32 * (C + 16);
      stride = 32 * 16;
    }
    float pc[4][kPc];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<kPc>(v[e], pc[e]);
#pragma unroll
    for (int p = 0; p < kPc; ++p)
      dst[p * stride] = make_uint2(pack(pc[0][p], pc[1][p]), pack(pc[2][p], pc[3][p]));
  }
  if (threadIdx.x < kF0) b0s[threadIdx.x] = lshm::to_f32(b0[threadIdx.x]);
  if (threadIdx.x < kF1P)
    b1s[threadIdx.x] = threadIdx.x < kF1 ? lshm::to_f32(b1[threadIdx.x]) : 0.0f;
}

// Stage 0 of tile t on this warp's three class m-tiles, from the window xw in the
// pieces of T (kXwPiece elements apart): with kE0, e0 = elu(a0) (0 on conv1's padding
// ring) into e0 at its tile position, rounded to bf16 for T = bf16, in three pieces
// (kPos0 * kF0 elements apart) for float; with kD0, elu'(a0) of the unrounded a0 (0 on
// the ring and on the padding rows) into d0, in the accumulator layout (rows r0 + g,
// r0 + g + 8; f0 2q, 2q + 1).
template <int C, typename T, bool kE0, bool kD0>
__device__ __forceinline__ void stage0_tc(const bf16* xw, const uint2* w0f, const float* b0s,
                                          int H0, Tile t, bf16* e0,
                                          float d0[kMtPerWarp][4]) {
  constexpr int kPc = kPiecesOf<T>;
  constexpr unsigned kXwPiece = kXW * kXW * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < kMtPerWarp; ++j) {
    const int mt = warp + kWarps * j, cls = mt / kClassTiles, r0 = mt % kClassTiles * 16;
    int py, px;
    class_pos(cls, r0 + lane % 16, py, px);
    const unsigned arow = saddr(xw + (2 * py * kXW + 2 * px) * C) + 16 * (lane / 16);
    float acc[4] = {};
    constexpr int kUnroll = kPc == 1 ? C : 1;   // float32: fewer registers live
#pragma unroll (kUnroll)
    for (int s = 0; s < C; ++s) {        // k-step s: ky = 16 s / 4C
      const unsigned at = arow + 2 * ((16 * s / (4 * C)) * kXW * C + (16 * s) % (4 * C));
      unsigned a[kPc][4];
      uint2 b[kPc];
#pragma unroll
      for (int k = 0; k < kPc; ++k) {
        ldsm_x4(at + 2 * k * kXwPiece, a[k]);
        b[k] = w0f[(k * C + s) * 32 + lane];
      }
      if constexpr (kPc == 1) {
        float part[4] = {};              // each k-step alone, added rounding to nearest
        mma(part, a[0], b[0].x, b[0].y);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += part[i];
      } else {
        mma_pairs(acc, a, b);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = class_pos(cls, r0 + g + 8 * h, py, px);
      const int y0 = 16 * t.ty - 1 + py, x0 = 16 * t.tx - 1 + px;
      const bool in = valid && y0 >= 0 && y0 < H0 && x0 >= 0 && x0 < H0;
      float e[2][kPc];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float a = acc[2 * h + c] + b0s[2 * q + c];
        if constexpr (kE0) split<kPc>(in ? lshm::elu(a) : 0.0f, e[c]);
        if constexpr (kD0) d0[j][2 * h + c] = in ? lshm::elu_grad(a) : 0.0f;
      }
      if constexpr (kE0) {
        if (valid) {
#pragma unroll
          for (int k = 0; k < kPc; ++k)
            *reinterpret_cast<unsigned*>(e0 + (k * kPos0 + py * kT0 + px) * kF0 + 2 * q) =
                pack(e[0][k], e[1][k]);
        }
      }
    }
  }
}

// Whether stage-1 output row (0 .. 63) of tile t, channel f1, lies inside the image
// and F1; and its index in a [B, H1, H1, F1] tensor.
__device__ __forceinline__ bool in1(Tile t, int H1, int row, int f1) {
  const int oy = kT1 * t.ty + row / kT1, ox = kT1 * t.tx + row % kT1;
  return oy < H1 && ox < H1 && f1 < kF1;
}

__device__ __forceinline__ size_t out1(Tile t, int H1, int row, int f1) {
  const int oy = kT1 * t.ty + row / kT1, ox = kT1 * t.tx + row % kT1;
  return (((size_t)t.n * H1 + oy) * H1 + ox) * kF1 + f1;
}

// Stage 1 of tile t, warp = (m-tile of 16 outputs, n-tile of 8 channels), from e0 in
// the pieces of T (kPos0 * kF0 elements apart): a1 without b1 into acc (rows 16 mt + g,
// + 8; f1 8 nt + 2q, + 1).
template <typename T>
__device__ __forceinline__ void stage1_tc(const bf16* e0, const uint2* w1f, float acc[4]) {
  constexpr int kPc = kPiecesOf<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp / 2, nt = warp % 2;
  const int p = 16 * mt + lane % 16;
  const unsigned arow = saddr(e0 + (2 * (p / kT1) * kT0 + 2 * (p % kT1)) * kF0);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
  constexpr int kUnroll = kPc == 1 ? 8 : 1;     // float32: fewer registers live
#pragma unroll (kUnroll)
  for (int s = 0; s < 8; ++s) {          // k-step s: taps 2 s (k < 8) and 2 s + 1
    const int tap = 2 * s + lane / 16;
    unsigned a[kPc][4];
    uint2 b[kPc];
#pragma unroll
    for (int k = 0; k < kPc; ++k) {
      ldsm_x4(arow + 2 * (((tap / 4) * kT0 + tap % 4) * kF0 + k * kPos0 * kF0), a[k]);
      b[k] = w1f[(k * 16 + nt * 8 + s) * 32 + lane];
    }
    if constexpr (kPc == 1) {
      mma(acc, a[0], b[0].x, b[0].y);
    } else {
      mma_pairs(acc, a, b);
    }
  }
}

// The same, and g1 at the same places into gv (0 where in1 is false): K4 and K5.
template <typename T>
__device__ __forceinline__ void stage1_tc(const bf16* e0, const uint2* w1f,
                                          const T* __restrict__ g1, int H1, Tile t,
                                          float acc[4], float gv[2][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int mt = warp / 2, nt = warp % 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {          // g1 early: its latency hides behind the mma
    const int row = 16 * mt + g + 8 * h, f1 = 8 * nt + 2 * q;
    gv[h][0] = gv[h][1] = 0.0f;
    if (in1(t, H1, row, f1)) {
      if constexpr (std::is_same<T, float>::value) {
        const float2 v = *reinterpret_cast<const float2*>(g1 + out1(t, H1, row, f1));
        gv[h][0] = v.x;
        gv[h][1] = v.y;
      } else {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(g1 + out1(t, H1, row, f1));
        gv[h][0] = __low2float(v);
        gv[h][1] = __high2float(v);
      }
    }
  }
  stage1_tc<T>(e0, w1f, acc);
}

// dpre1 = g1 elu'(a1) of this warp's stage-1 outputs (stage1_tc's acc and gv) into dp1
// in three pieces; db1 summed.  Both K4 kernels.
__device__ __forceinline__ void store_dpre1(const float acc[4], const float gv[2][2],
                                            const float* b1s, int warp, int g, int q,
                                            bf16* dp1, float db1a[2]) {
  const int mt = warp / 2, nt = warp % 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * mt + g + 8 * h;
    float v[2], pc[2][kPieces];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      v[c] = gv[h][c] * lshm::elu_grad(acc[2 * h + c] + b1s[8 * nt + 2 * q + c]);
      db1a[c] += v[c];
      split3(v[c], pc[c]);
    }
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<unsigned*>(dp1 + (k * kDpRows + row) * kF1P + 8 * nt + 2 * q) =
          pack(pc[0][k], pc[1][k]);
  }
}

// dpre0 = d e0 elu'(a0) of one class m-tile (acc the gathered d e0, d0 elu'(a0), 0 on
// the ring and padding) into this warp's staging [3][16][8] in pieces; db0 summed.
// Both K4 kernels.
__device__ __forceinline__ void stage_dpre0(const float acc[4], const float d0[4],
                                            int g, int q, bf16* stg, float db0a[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float pc[2][kPieces];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v = acc[2 * h + c] * d0[2 * h + c];
      db0a[c] += v;
      split3(v, pc[c]);
    }
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<unsigned*>(stg + (k * 16 + g + 8 * h) * kF0 + 2 * q) =
          pack(pc[0][k], pc[1][k]);
  }
}

// This block's row of partials out = [dW0 | db0 | dW1 | db1] from each warp's register
// sums (dW0 m-tiles accW0, dW1 m-tile accW1, bias sums per lane), the warps' dW0 and bias
// sums added in a fixed order through red (shared memory, Smem::red floats, free for it:
// the caller syncs the block first).
template <int C>
__device__ __forceinline__ void write_partials(const float accW0[C][4],
                                               const float accW1[2][4], const float db0a[2],
                                               const float db1a[2], float* red, float* out) {
  using L = Layout<C>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  float* rdb0 = red + kWarps * 16 * C * kF0;
  float* rdb1 = rdb0 + kWarps * 8;
#pragma unroll
  for (int mm = 0; mm < C; ++mm) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * mm + g + 8 * h, tap = k / C, c = k % C;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        red[warp * 16 * C * kF0 + ((2 * q + cc) * C + c) * 16 + tap] =
            accW0[mm][2 * h + cc];
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {          // dW1: each entry owned by one thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int f1 = 8 * nt + 2 * q + cc, tap = 2 * warp + h;
        if (f1 < kF1) out[L::oW1 + (f1 * kF0 + g) * 16 + tap] = accW1[nt][2 * h + cc];
      }
    }
  }
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {          // over g: lanes q, q + 4, ..., q + 28
    float s0 = db0a[cc], s1 = db1a[cc];
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      rdb0[warp * 8 + 2 * q + cc] = s0;
      rdb1[warp * 8 + 2 * q + cc] = s1;    // channel 8 (warp % 2) + 2 q + cc
    }
  }
  __syncthreads();
  for (int i = tid; i < 16 * C * kF0; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 16 * C * kF0 + i];
    out[L::oW0 + i] = s;
  }
  if (tid < kF0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += rdb0[w * 8 + tid];
    out[L::oB0 + tid] = s;
  } else if (tid >= 32 && tid < 32 + kF1) {
    const int f1 = tid - 32;
    float s = 0.0f;
    for (int w = f1 / 8; w < kWarps; w += 2) s += rdb1[w * 8 + f1 % 8];
    out[L::oB1 + f1] = s;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
head_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                   const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ g1, int P, int tps,
                   int ntiles, float* __restrict__ partial) {
  using S = Smem<C>;
  using L = Layout<C>;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  bf16* win = reinterpret_cast<bf16*>(sm + S::oWin);
  bf16* e0 = reinterpret_cast<bf16*>(sm + S::oE0);
  bf16* dp1 = reinterpret_cast<bf16*>(sm + S::oDp1);
  uint2* w0f = reinterpret_cast<uint2*>(sm + S::oW0f);
  uint2* w1f = reinterpret_cast<uint2*>(sm + S::oW1f);
  uint2* w1g = reinterpret_cast<uint2*>(sm + S::oW1g);
  float* b0s = reinterpret_cast<float*>(sm + S::oBias);
  float* b1s = b0s + kF0;
  const int H0 = P / 2, H1 = P / 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  bf16* stg = reinterpret_cast<bf16*>(sm + S::oStg) + warp * kPieces * 16 * kF0;

  if (blockIdx.x < ntiles) load_window_async<C>(x, P, decode_tile(blockIdx.x, tps), win);
  cp_async_commit();
  load_fragments<C>(w0, b0, w1, b1, w0f, w1f, w1g, b0s, b1s);
  for (int i = tid; i < kPieces * kF1P; i += blockDim.x)      // the zero row of each piece
    dp1[((i / kF1P) * kDpRows + kP1) * kF1P + i % kF1P] = __float2bfloat16_rn(0.0f);

  float accW0[C][4] = {}, accW1[2][4] = {}, db0a[2] = {}, db1a[2] = {};

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile t = decode_tile(tile, tps);
    const bf16* xw = win + buf * S::win;
    cp_async_wait_all();
    __syncthreads();                       // window t in; tile t - 1 done with e0, dp1
    if (tile + (int)gridDim.x < ntiles)
      load_window_async<C>(x, P, decode_tile(tile + gridDim.x, tps),
                           win + (buf ^ 1) * S::win);
    cp_async_commit();

    // stage 0 on this warp's three class m-tiles: e0 to shared memory, elu'(a0) kept
    float d0[kMtPerWarp][4];
    stage0_tc<C, bf16, true, true>(xw, w0f, b0s, H0, t, e0, d0);
    __syncthreads();

    // stage 1, warp = (m-tile of 16 outputs, n-tile of 8 channels): dpre1 in pieces
    {
      float acc[4], gv[2][2];
      stage1_tc(e0, w1f, g1, H1, t, acc, gv);
      store_dpre1(acc, gv, b1s, warp, g, q, dp1, db1a);
    }
    __syncthreads();

    // dW1 += A1^T dpre1: this warp's m-tile is taps 2 warp, 2 warp + 1 (by f0)
#pragma unroll
    for (int s = 0; s < kP1 / 16; ++s) {
      const int mq = lane / 8, p = 16 * s + lane % 8 + 8 * (mq / 2);
      const int tap = 2 * warp + mq % 2;
      unsigned a[4];
      ldsm_x4_t(
          saddr(e0 + ((2 * (p / kT1) + tap / 4) * kT0 + 2 * (p % kT1) + tap % 4) * kF0), a);
      const int pb = 16 * s + lane % 8 + 8 * (mq % 2);
      float part[2][4] = {};
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        unsigned b[4];
        ldsm_x4_t(saddr(dp1 + (k * kDpRows + pb) * kF1P + 8 * (mq / 2)), b);
        mma(part[0], a, b[0], b[1]);
        mma(part[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) accW1[i / 4][i % 4] += part[i / 4][i % 4];
    }

    // d e0 gathered per class m-tile, dpre0 = d e0 * elu'(a0), then dW0 += A0^T dpre0
#pragma unroll
    for (int j = 0; j < kMtPerWarp; ++j) {
      const int mt = warp + kWarps * j, cls = mt / kClassTiles, r0 = mt % kClassTiles * 16;
      const int r = r0 + lane % 16;
      const bool valid = r < kClassPos;
      const int qy = r / kHalf, qx = r % kHalf;
      float acc[4] = {};
#pragma unroll
      for (int s = 0; s < 4; ++s) {        // slot s: ky = py % 2 + 2 (s / 2), kx likewise
        const int oyl = qy - s / 2, oxl = qx - s % 2;
        const int prow = valid && oyl >= 0 && oyl < kT1 && oxl >= 0 && oxl < kT1
                             ? oyl * kT1 + oxl : kP1;
        const int tap = ((cls >> 1) + 2 * (s / 2)) * 4 + (cls & 1) + 2 * (s % 2);
        const uint2 b = w1g[tap * 32 + lane];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          unsigned a[4];
          ldsm_x4(saddr(dp1 + (k * kDpRows + prow) * kF1P + 8 * (lane / 16)), a);
          mma(acc, a, b.x, b.y);
        }
      }
      stage_dpre0(acc, d0[j], g, q, stg, db0a);
      __syncwarp();
      // B: dpre0 [16 positions x 8 f0] per piece
      unsigned b01[4], b2[2];
      ldsm_x4_t(saddr(stg + (lane / 16) * 16 * kF0 + (lane % 16) * kF0), b01);
      ldsm_x2_t(saddr(stg + 2 * 16 * kF0 + (lane % 16) * kF0), b2);
      // A: the window rows of the m-tile's positions, transposed: m = (ky, kx, c)
      int py, px;
      class_pos(cls, r0 + lane % 8 + 8 * (lane / 16), py, px);
      const unsigned arow = saddr(xw + (2 * py * kXW + 2 * px) * C) + 16 * (lane / 8 % 2);
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {     // m-tile mm: k = (ky, kx, c) in [16 mm, +16)
        unsigned a[4];
        ldsm_x4_t(arow + 2 * ((16 * mm / (4 * C)) * kXW * C + (16 * mm) % (4 * C)), a);
        float part[4] = {};
        mma(part, a, b01[0], b01[1]);
        mma(part, a, b01[2], b01[3]);
        mma(part, a, b2[0], b2[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) accW0[mm][i] += part[i];
      }
      __syncwarp();                         // stg is rewritten by the next m-tile
    }
  }
  cp_async_wait_all();
  __syncthreads();

  write_partials<C>(accW0, accW1, db0a, db1a, reinterpret_cast<float*>(sm + S::oWin),
                    partial + (size_t)blockIdx.x * L::nacc);
}

// ---- Backward, weights, float32 (K4 float32) on the tensor cores ----
//
// K4 bf16's kernel with every float32 operand in three bf16 pieces and each product
// through mma_pairs; the header gives the design.

template <int C>
struct F32Smem {   // byte offsets; every array 16-byte aligned
  static constexpr int win = kXW * kXW * C;                          // elements of a piece
  static constexpr int oWin = 0;                                     // [3][38][38][C] bf16
  static constexpr int oRaw = oWin + 2 * kPieces * win;              // [38][38][C] float
  static constexpr int oE0 = oRaw + 4 * win;                         // [3][324][8] bf16
  static constexpr int oDp1 = oE0 + 2 * kPieces * kPos0 * kF0;       // [3][65][16] bf16
  static constexpr int oStg = oDp1 + 2 * kPieces * kDpRows * kF1P;   // [8][3][16][8] bf16
  static constexpr int oW0f = oStg + 2 * kWarps * kPieces * 16 * kF0;  // [3][C][32] uint2
  static constexpr int oW1f = oW0f + 8 * kPieces * C * 32;           // [3][2][8][32] uint2
  static constexpr int oW1g = oW1f + 8 * kPieces * 16 * 32;          // [3][16][32] uint2
  static constexpr int oBias = oW1g + 8 * kPieces * 16 * 32;         // b0 [8], b1 [16]
  static constexpr int bytes = oBias + 4 * (kF0 + kF1P);
  // resident blocks per SM: two at C = 4 (113,440 bytes each, plus the 1 KB the runtime
  // keeps per block, within the SM's 228 KB), one at C = 8
  static constexpr int per_sm = C == 4 ? 2 : 1;
  static_assert(per_sm * (bytes + 1024) <= 228 * 1024, "blocks per SM fit");
  static_assert(4 * Smem<C>::red <= oRaw, "reduction scratch fits in the window pieces");
  static_assert(oRaw % 16 == 0 && oE0 % 16 == 0 && oDp1 % 16 == 0 && oStg % 16 == 0 &&
                oW0f % 16 == 0 && (2 * win) % 16 == 0, "16-byte aligned rows");
};

// The float32 window of tile t into raw, asynchronously, 16 bytes a copy, zeros outside
// the image.  Chunk i (floats 4 i .. 4 i + 3) is copied by thread i mod blockDim.x.
template <int C>
__device__ void load_window_f32_async(const float* __restrict__ x, int P, Tile t,
                                      float* raw) {
  const int iy0 = 32 * t.ty - 3, ix0 = 32 * t.tx - 3;
  for (int i = threadIdx.x; i < kXW * kXW * C / 4; i += blockDim.x) {
    const int pix = i / (C / 4);
    const int iy = iy0 + pix / kXW, ix = ix0 + pix % kXW;
    const bool in = iy >= 0 && iy < P && ix >= 0 && ix < P;
    const float* src =
        in ? x + (((size_t)t.n * P + iy) * P + ix) * C + 4 * (i % (C / 4)) : x;
    cp_async<16>(saddr(raw + 4 * i), src, in ? 16 : 0);
  }
}

// The chunks of raw that this thread copied (its own cp.async writes are visible to it
// after the wait) into three exact bf16 pieces, win[k][.] for k = 0, 1, 2.
template <int C>
__device__ void split_window(const float* raw, bf16* win) {
  for (int i = threadIdx.x; i < kXW * kXW * C / 4; i += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(raw)[i];
    float pc[4][kPieces];
    split3(v.x, pc[0]);
    split3(v.y, pc[1]);
    split3(v.z, pc[2]);
    split3(v.w, pc[3]);
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<uint2*>(win + k * kXW * kXW * C + 4 * i) =
          make_uint2(pack(pc[0][k], pc[1][k]), pack(pc[2][k], pc[3][k]));
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, F32Smem<C>::per_sm)
head_bwd_f32_tc_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                       const float* __restrict__ b0, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ g1, int P,
                       int tps, int ntiles, float* __restrict__ partial) {
  using S = F32Smem<C>;
  using L = Layout<C>;
  constexpr int kWinPiece = kXW * kXW * C, kE0Piece = kPos0 * kF0;   // elements
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  bf16* win = reinterpret_cast<bf16*>(sm + S::oWin);
  float* raw = reinterpret_cast<float*>(sm + S::oRaw);
  bf16* e0 = reinterpret_cast<bf16*>(sm + S::oE0);
  bf16* dp1 = reinterpret_cast<bf16*>(sm + S::oDp1);
  uint2* w0f = reinterpret_cast<uint2*>(sm + S::oW0f);
  uint2* w1f = reinterpret_cast<uint2*>(sm + S::oW1f);
  uint2* w1g = reinterpret_cast<uint2*>(sm + S::oW1g);
  float* b0s = reinterpret_cast<float*>(sm + S::oBias);
  float* b1s = b0s + kF0;
  const int H0 = P / 2, H1 = P / 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  bf16* stg = reinterpret_cast<bf16*>(sm + S::oStg) + warp * kPieces * 16 * kF0;

  if (blockIdx.x < ntiles) load_window_f32_async<C>(x, P, decode_tile(blockIdx.x, tps), raw);
  cp_async_commit();
  load_fragments<C>(w0, b0, w1, b1, w0f, w1f, w1g, b0s, b1s);
  for (int i = tid; i < kPieces * kF1P; i += blockDim.x)      // the zero row of each piece
    dp1[((i / kF1P) * kDpRows + kP1) * kF1P + i % kF1P] = __float2bfloat16_rn(0.0f);

  float accW0[C][4] = {}, accW1[2][4] = {}, db0a[2] = {}, db1a[2] = {};

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = decode_tile(tile, tps);
    cp_async_wait_all();
    __syncthreads();                       // tile t - 1 done with the window, e0, dp1
    split_window<C>(raw, win);             // its own copies: visible after its wait
    __syncthreads();                       // the window's pieces in; raw free
    if (tile + (int)gridDim.x < ntiles)
      load_window_f32_async<C>(x, P, decode_tile(tile + gridDim.x, tps), raw);
    cp_async_commit();

    // stage 0 on this warp's three class m-tiles: e0 in pieces, elu'(a0) kept
    float d0[kMtPerWarp][4];
    stage0_tc<C, float, true, true>(win, w0f, b0s, H0, t, e0, d0);
    __syncthreads();

    // stage 1, warp = (m-tile of 16 outputs, n-tile of 8 channels): dpre1 in pieces
    {
      float acc[4], gv[2][2];
      stage1_tc(e0, w1f, g1, H1, t, acc, gv);
      store_dpre1(acc, gv, b1s, warp, g, q, dp1, db1a);
    }
    __syncthreads();

    // dW1 += A1^T dpre1: this warp's m-tile is taps 2 warp, 2 warp + 1 (by f0)
#pragma unroll
    for (int s = 0; s < kP1 / 16; ++s) {
      const int mq = lane / 8, p = 16 * s + lane % 8 + 8 * (mq / 2);
      const int tap = 2 * warp + mq % 2;
      const unsigned ae =
          saddr(e0 + ((2 * (p / kT1) + tap / 4) * kT0 + 2 * (p % kT1) + tap % 4) * kF0);
      const unsigned bd = saddr(dp1 + (16 * s + lane % 16) * kF1P);
      unsigned a[kPieces][4];
#pragma unroll
      for (int k = 0; k < kPieces; ++k) ldsm_x4_t(ae + 2 * k * kE0Piece, a[k]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {        // B per n-tile: fewer registers live
        uint2 b[kPieces];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          unsigned r[2];
          ldsm_x2_t(bd + 2 * (k * kDpRows * kF1P + 8 * n), r);
          b[k] = make_uint2(r[0], r[1]);
        }
        mma_pairs(accW1[n], a, b);
      }
    }

    // d e0 gathered per class m-tile, dpre0 = d e0 * elu'(a0), then dW0 += A0^T dpre0
#pragma unroll
    for (int j = 0; j < kMtPerWarp; ++j) {
      const int mt = warp + kWarps * j, cls = mt / kClassTiles, r0 = mt % kClassTiles * 16;
      const int r = r0 + lane % 16;
      const bool valid = r < kClassPos;
      const int qy = r / kHalf, qx = r % kHalf;
      float acc[4] = {};
#pragma unroll 1                           // fewer registers live
      for (int s = 0; s < 4; ++s) {        // slot s: ky = py % 2 + 2 (s / 2), kx likewise
        const int oyl = qy - s / 2, oxl = qx - s % 2;
        const int prow = valid && oyl >= 0 && oyl < kT1 && oxl >= 0 && oxl < kT1
                             ? oyl * kT1 + oxl : kP1;
        const int tap = ((cls >> 1) + 2 * (s / 2)) * 4 + (cls & 1) + 2 * (s % 2);
        unsigned a[kPieces][4];
        uint2 b[kPieces];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          ldsm_x4(saddr(dp1 + (k * kDpRows + prow) * kF1P + 8 * (lane / 16)), a[k]);
          b[k] = w1g[(k * 16 + tap) * 32 + lane];
        }
        mma_pairs(acc, a, b);
      }
      stage_dpre0(acc, d0[j], g, q, stg, db0a);
      __syncwarp();
      // B: dpre0 [16 positions x 8 f0] per piece
      unsigned b01[4], b2[2];
      ldsm_x4_t(saddr(stg + (lane / 16) * 16 * kF0 + (lane % 16) * kF0), b01);
      ldsm_x2_t(saddr(stg + 2 * 16 * kF0 + (lane % 16) * kF0), b2);
      const uint2 b[kPieces] = {make_uint2(b01[0], b01[1]), make_uint2(b01[2], b01[3]),
                                make_uint2(b2[0], b2[1])};
      // A: the window rows of the m-tile's positions, transposed: m = (ky, kx, c)
      int py, px;
      class_pos(cls, r0 + lane % 8 + 8 * (lane / 16), py, px);
      const unsigned arow = saddr(win + (2 * py * kXW + 2 * px) * C) + 16 * (lane / 8 % 2);
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {     // m-tile mm: k = (ky, kx, c) in [16 mm, +16)
        const unsigned at =
            arow + 2 * ((16 * mm / (4 * C)) * kXW * C + (16 * mm) % (4 * C));
        unsigned a[kPieces][4];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) ldsm_x4_t(at + 2 * k * kWinPiece, a[k]);
        mma_pairs(accW0[mm], a, b);
      }
      __syncwarp();                         // stg is rewritten by the next m-tile
    }
  }
  cp_async_wait_all();
  __syncthreads();

  write_partials<C>(accW0, accW1, db0a, db1a, reinterpret_cast<float*>(sm + S::oWin),
                    partial + (size_t)blockIdx.x * L::nacc);
}

// ---- Forward (K3) and the first pass of K5 on the tensor cores, both dtypes ----
//
// K4's stage 0 (e0 only) and stage 1 on a fixed grid walking the tiles, the next tile's
// window in flight, with one of two epilogues: K3's out = elu(a1 + b1) rounded to T, or
// K5's dpre1 = g1 elu'(a1 + b1) in float32.  The header gives the design.

constexpr int kSMs = 132;                  // the H100's: the fixed grids fill every SM
// resident blocks per SM of the bf16 forward: three (ptxas: 71 and 80 registers at C =
// 4 and 8, within the 80 that three blocks of 256 threads allow, no spills)
constexpr int kFwdBf16PerSM = 3;

template <int C, typename T>
struct FwdSmem {   // byte offsets; every array 16-byte aligned
  static constexpr int kPc = kPiecesOf<T>;
  static constexpr int win = kXW * kXW * C;                    // elements of a window piece
  // bf16: two windows [2][38][38][C], the next tile's arriving in the other; float32:
  // the pieces [3][38][38][C] and one raw float32 window that the next tile's arrives in
  static constexpr int oWin = 0;
  static constexpr int oRaw = oWin + 2 * (kPc == 1 ? 2 : kPieces) * win;
  static constexpr int oE0 = oRaw + (kPc == 1 ? 0 : 4 * win);  // [kPc][324][8] bf16
  static constexpr int oW0f = oE0 + 2 * kPc * kPos0 * kF0;     // [kPc][C][32] uint2
  static constexpr int oW1f = oW0f + 8 * kPc * C * 32;         // [kPc][2][8][32] uint2
  static constexpr int oBias = oW1f + 8 * kPc * 16 * 32;       // b0 [8], b1 [16]
  static constexpr int bytes = oBias + 4 * (kF0 + kF1P);
  static constexpr int per_sm = kPc == 1 ? kFwdBf16PerSM : C == 4 ? 2 : 1;
  static_assert(per_sm * (bytes + 1024) <= 228 * 1024, "blocks per SM fit");
  static_assert(2 * kPc * kPos0 * kF0 >= 8 * kPc * 16 * 32, "the gather's fragments in e0");
  static_assert(oRaw % 16 == 0 && oE0 % 16 == 0 && oW0f % 16 == 0 && (2 * win) % 16 == 0,
                "16-byte aligned rows for cp.async and ldmatrix");
};

// The tiles of this block: out = elu(a1 + b1) in T (K3), or with kDpre1, dpre1 = g1
// elu'(a1 + b1) in float32 (K5's first pass; g1 read by stage 1).
template <int C, typename T, bool kDpre1>
__device__ __forceinline__ void fwd_tiles(const T* __restrict__ x,
                                          const T* __restrict__ w0,
                                          const T* __restrict__ b0,
                                          const T* __restrict__ w1,
                                          const T* __restrict__ b1,
                                          const T* __restrict__ g1, int P, int tps,
                                          int ntiles,
                                          std::conditional_t<kDpre1, float, T>*
                                              __restrict__ out) {
  using S = FwdSmem<C, T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  bf16* win = reinterpret_cast<bf16*>(sm + S::oWin);
  float* raw = reinterpret_cast<float*>(sm + S::oRaw);
  bf16* e0 = reinterpret_cast<bf16*>(sm + S::oE0);
  uint2* w0f = reinterpret_cast<uint2*>(sm + S::oW0f);
  uint2* w1f = reinterpret_cast<uint2*>(sm + S::oW1f);
  // load_fragments also writes the d e0 gather's fragments, which the forward never
  // reads: they go to e0's space, which the first tile writes only after a block-wide sync
  uint2* w1g = reinterpret_cast<uint2*>(sm + S::oE0);
  float* b0s = reinterpret_cast<float*>(sm + S::oBias);
  float* b1s = b0s + kF0;
  const int H0 = P / 2, H1 = P / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int mt = warp / 2, nt = warp % 2;

  auto load = [&](int tile, int buf) {     // tile's window into the buffer that takes it
    const Tile t = decode_tile(tile, tps);
    if constexpr (kF32) {
      load_window_f32_async<C>(x, P, t, raw);
    } else {
      load_window_async<C>(x, P, t, win + buf * S::win);
    }
  };
  if (blockIdx.x < ntiles) load(blockIdx.x, 0);
  cp_async_commit();
  load_fragments<C>(w0, b0, w1, b1, w0f, w1f, w1g, b0s, b1s);

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile t = decode_tile(tile, tps);
    cp_async_wait_all();
    __syncthreads();                       // window t in; tile t - 1 done with it and e0
    if constexpr (kF32) {
      split_window<C>(raw, win);           // its own copies: visible after its wait
      __syncthreads();                     // the window's pieces in; raw free
    }
    if (tile + (int)gridDim.x < ntiles) load(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    stage0_tc<C, T, true, false>(kF32 ? win : win + buf * S::win, w0f, b0s, H0, t, e0,
                                 nullptr);
    __syncthreads();
    float acc[4], gv[2][2];
    if constexpr (kDpre1) {
      stage1_tc(e0, w1f, g1, H1, t, acc, gv);
    } else {
      stage1_tc<T>(e0, w1f, acc);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + g + 8 * h, f1 = 8 * nt + 2 * q;
      if constexpr (kDpre1) {
        if (in1(t, H1, row, f1))
          store_pair(out + out1(t, H1, row, f1),
                     gv[h][0] * lshm::elu_grad(acc[2 * h] + b1s[f1]),
                     gv[h][1] * lshm::elu_grad(acc[2 * h + 1] + b1s[f1 + 1]));
      } else {
        if (in1(t, H1, row, f1))
          store_pair(out + out1(t, H1, row, f1), lshm::elu(acc[2 * h] + b1s[f1]),
                     lshm::elu(acc[2 * h + 1] + b1s[f1 + 1]));
      }
    }
  }
  cp_async_wait_all();
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads, FwdSmem<C, T>::per_sm)
head_fwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                   const T* __restrict__ b0, const T* __restrict__ w1,
                   const T* __restrict__ b1, int P, int tps, int ntiles,
                   T* __restrict__ out) {
  fwd_tiles<C, T, false>(x, w0, b0, w1, b1, nullptr, P, tps, ntiles, out);
}

// ---- Backward, input (K5) on the tensor cores, both dtypes, in two passes ----

// Pass 1: dpre1 = g1 * elu'(a1) in float32 to device memory, K3's kernel with the other
// epilogue (its grid, shared memory and blocks per SM).
template <int C, typename T>
__global__ void __launch_bounds__(kThreads, FwdSmem<C, T>::per_sm)
dpre1_tc_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ g1, int P, int tps, int ntiles,
                float* __restrict__ dpre1) {
  fwd_tiles<C, T, true>(x, w0, b0, w1, b1, g1, P, tps, ntiles, dpre1);
}

// Pass 2: one 32 x 32 input tile at a time (the inputs of stage-1 tile (ty, tx)); its
// stage-0 halo tile is K4's 18 x 18, and the dpre1 that reaches it a 10 x 10 halo
// (halo position qy <-> stage-1 row 8 ty - 1 + qy).
constexpr int kHalo = kTD * kTD;           // 100 dpre1 positions
constexpr int kDxTiles = 4 * (kTX / 2);    // 64 dx m-tiles: 4 parity classes x 16 rows
static_assert(kDxTiles % kWarps == 0, "dx m-tiles per warp");

template <int C, typename T>
struct DxSmem {   // byte offsets; every array 16-byte aligned
  static constexpr int kPc = kPiecesOf<T>;
  static constexpr int win = kXW * kXW * C;                       // elements of a piece
  // bf16: two windows [2][38][38][C]; float32: the pieces [3][38][38][C] and one raw
  // float32 window that the next tile's arrives in
  static constexpr int oWin = 0;
  static constexpr int oRaw = oWin + 2 * (kPc == 1 ? 2 : kPieces) * win;
  static constexpr int oRawD = oRaw + (kPc == 1 ? 0 : 4 * win);  // [2][100][12] float
  static constexpr int oDp1 = oRawD + 2 * 4 * kHalo * kF1;        // [3][100][16] bf16
  static constexpr int oDp0 = oDp1 + 2 * kPieces * kHalo * kF1P;  // [3][324][8] bf16
  // dx staged [32][32][C] in T: bf16 in its own array, float32 in the window's pieces,
  // which only stage 0 reads
  static constexpr int oDx = kPc == 1 ? oDp0 + 2 * kPieces * kPos0 * kF0 : oWin;
  static constexpr int oW0f = kPc == 1 ? oDx + 2 * kTX * kTX * C
                                       : oDp0 + 2 * kPieces * kPos0 * kF0;  // [kPc][C][32]
  static constexpr int oW1g = oW0f + 8 * kPc * C * 32;            // [kPc][16][32] uint2
  static constexpr int oW0x = oW1g + 8 * kPc * 16 * 32;           // [kPc][4][2][32] uint2
  static constexpr int oBias = oW0x + 8 * kPc * 8 * 32;           // b0 [8], b1 [16]
  static constexpr int bytes = oBias + 4 * (kF0 + kF1P);
  // resident blocks per SM: two (bf16 125 registers; float32 114,112 bytes at C = 4),
  // one for float32 at C = 8
  static constexpr int per_sm = kPc == 1 || C == 4 ? 2 : 1;
  static_assert(per_sm * (bytes + 1024) <= 228 * 1024, "blocks per SM fit");
  static_assert(kPc == 1 || 4 * kTX * kTX * C <= 2 * kPieces * win,
                "float32 dx staging fits in the window's pieces");
  static_assert(2 * kPieces * kPos0 * kF0 >= 8 * kPc * 16 * 32,
                "stage 1's fragments in dp0");
  static_assert(oRaw % 16 == 0 && oRawD % 16 == 0 && oDp1 % 16 == 0 && oDp0 % 16 == 0 &&
                oDx % 16 == 0 && oW0f % 16 == 0 && (2 * win) % 16 == 0,
                "16-byte aligned rows for cp.async and ldmatrix");
};

// dpre1's 10 x 10 halo of tile t into raw [100][12], asynchronously: 16 bytes a copy,
// zeros outside the image.
__device__ void load_dpre1_async(const float* __restrict__ dpre1, int H1, Tile t,
                                 float* raw) {
  for (int i = threadIdx.x; i < kHalo * 3; i += blockDim.x) {
    const int pos = i / 3, k = i % 3;
    const int oy = kT1 * t.ty - 1 + pos / kTD, ox = kT1 * t.tx - 1 + pos % kTD;
    const bool in = oy >= 0 && oy < H1 && ox >= 0 && ox < H1;
    const float* src = in ? dpre1 + (((size_t)t.n * H1 + oy) * H1 + ox) * kF1 + 4 * k
                          : dpre1;
    cp_async<16>(saddr(raw + pos * kF1 + 4 * k), src, in ? 16 : 0);
  }
}

// The dpre1 halo raw [100][12] into three exact bf16 pieces dp1 [3][100][16] (f1 12 ..
// 15 left as they are), four channels a thread.
__device__ __forceinline__ void split_halo(const float* raw, bf16* dp1) {
  for (int i = threadIdx.x; i < kHalo * 3; i += blockDim.x) {
    const int pos = i / 3, f1 = 4 * (i % 3);
    const float4 v = *reinterpret_cast<const float4*>(raw + pos * kF1 + f1);
    float pc[4][kPieces];
    split3(v.x, pc[0]);
    split3(v.y, pc[1]);
    split3(v.z, pc[2]);
    split3(v.w, pc[3]);
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<uint2*>(dp1 + (k * kHalo + pos) * kF1P + f1) =
          make_uint2(pack(pc[0][k], pc[1][k]), pack(pc[2][k], pc[3][k]));
  }
}

// B fragments of the dx product, in lane order, piece p of each (one piece for bf16
// weights, three for float32): w0x[p][cls][s] for parity class cls = (ry % 2, rx % 2)
// and k-step s: k = (tap (s, 0) by f0 | tap (s, 1) by f0), n = c, where tap (ty, tx) is
// ky = 1 - ry % 2 + 2 ty, kx = 1 - rx % 2 + 2 tx; c >= C is 0.
template <int C, typename T>
__device__ void load_dx_fragments(const T* __restrict__ w0, uint2* w0x) {
  constexpr int kPc = kPiecesOf<T>;
  auto W0 = [&](int f0, int c, int ky, int kx) {
    return c < C ? lshm::to_f32(w0[((f0 * C + c) * 4 + ky) * 4 + kx]) : 0.0f;
  };
  for (int i = threadIdx.x; i < 8 * 32; i += blockDim.x) {
    const int lane = i % 32, cls = i / 64, s = (i / 32) % 2, g = lane / 4, q = lane % 4;
    const int ky = 1 - (cls >> 1) + 2 * s, kx0 = 1 - (cls & 1), kx1 = kx0 + 2;
    const float v[4] = {W0(2 * q, g, ky, kx0), W0(2 * q + 1, g, ky, kx0),
                        W0(2 * q, g, ky, kx1), W0(2 * q + 1, g, ky, kx1)};
    float pc[4][kPc];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<kPc>(v[e], pc[e]);
#pragma unroll
    for (int p = 0; p < kPc; ++p)
      w0x[p * 8 * 32 + i] = make_uint2(pack(pc[0][p], pc[1][p]), pack(pc[2][p], pc[3][p]));
  }
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads, DxSmem<C, T>::per_sm)
head_dx_tc_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                  const T* __restrict__ b0, const T* __restrict__ w1,
                  const T* __restrict__ b1, const float* __restrict__ dpre1, int P,
                  int tps, int ntiles, T* __restrict__ dx) {
  using S = DxSmem<C, T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kPc = kPiecesOf<T>;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  bf16* win = reinterpret_cast<bf16*>(sm + S::oWin);
  float* raw = reinterpret_cast<float*>(sm + S::oRaw);
  float* rawd = reinterpret_cast<float*>(sm + S::oRawD);
  bf16* dp1 = reinterpret_cast<bf16*>(sm + S::oDp1);
  bf16* dp0 = reinterpret_cast<bf16*>(sm + S::oDp0);
  T* dxs = reinterpret_cast<T*>(sm + S::oDx);
  uint2* w0f = reinterpret_cast<uint2*>(sm + S::oW0f);
  // load_fragments also writes stage 1's fragments, which this kernel never reads:
  // they go to dp0's space, which the first tile writes only after a block-wide sync
  uint2* w1f = reinterpret_cast<uint2*>(sm + S::oDp0);
  uint2* w1g = reinterpret_cast<uint2*>(sm + S::oW1g);
  uint2* w0x = reinterpret_cast<uint2*>(sm + S::oW0x);
  float* b0s = reinterpret_cast<float*>(sm + S::oBias);
  float* b1s = b0s + kF0;
  const int H0 = P / 2, H1 = P / 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;

  auto load = [&](int tile, int buf) {     // tile's window and dpre1 halo
    const Tile t = decode_tile(tile, tps);
    if constexpr (kF32) {
      load_window_f32_async<C>(x, P, t, raw);
    } else {
      load_window_async<C>(x, P, t, win + buf * S::win);
    }
    load_dpre1_async(dpre1, H1, t, rawd + buf * kHalo * kF1);
  };
  if (blockIdx.x < ntiles) load(blockIdx.x, 0);
  cp_async_commit();
  load_fragments<C>(w0, b0, w1, b1, w0f, w1f, w1g, b0s, b1s);
  load_dx_fragments<C>(w0, w0x);
  for (int i = tid; i < kPieces * kHalo; i += blockDim.x)    // f1 12 .. 15 of dp1 stay 0
    *reinterpret_cast<uint2*>(dp1 + i * kF1P + kF1) = make_uint2(0u, 0u);

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile t = decode_tile(tile, tps);
    cp_async_wait_all();
    __syncthreads();                       // tile t in; tile t - 1 done with dp0, dxs
    if constexpr (kF32) {
      split_window<C>(raw, win);           // its own copies: visible after its wait
      __syncthreads();                     // the window's pieces in; raw free
    }
    if (tile + (int)gridDim.x < ntiles) load(tile + gridDim.x, buf ^ 1);
    cp_async_commit();

    split_halo(rawd + buf * kHalo * kF1, dp1);
    // stage 0 on this warp's three class m-tiles: elu'(a0) kept
    float d0[kMtPerWarp][4];
    stage0_tc<C, T, false, true>(kF32 ? win : win + buf * S::win, w0f, b0s, H0, t, nullptr,
                                 d0);
    __syncthreads();

    // d e0 per class m-tile: four tap slots, the A rows dpre1 halo rows picked by
    // address; dpre0 = d e0 * elu'(a0) in three pieces at its tile position
#pragma unroll
    for (int j = 0; j < kMtPerWarp; ++j) {
      const int mt = warp + kWarps * j, cls = mt / kClassTiles, r0 = mt % kClassTiles * 16;
      const int r = r0 + lane % 16;
      const bool valid = r < kClassPos;    // padding rows: position (0, 0)'s rows, d0 0
      const int qy = valid ? r / kHalf : 0, qx = valid ? r % kHalf : 0;
      float acc[4] = {};
      constexpr int kUnroll = kPc == 1 ? 4 : 1;   // float32: fewer registers live
#pragma unroll (kUnroll)
      for (int s = 0; s < 4; ++s) {        // slot s: ky = py % 2 + 2 (s / 2), kx likewise
        const int hrow = (qy + 1 - s / 2) * kTD + qx + 1 - s % 2;
        const int tap = ((cls >> 1) + 2 * (s / 2)) * 4 + (cls & 1) + 2 * (s % 2);
        const unsigned arow = saddr(dp1 + hrow * kF1P + 8 * (lane / 16));
        if constexpr (kPc == 1) {
          const uint2 b = w1g[tap * 32 + lane];
#pragma unroll
          for (int k = 0; k < kPieces; ++k) {
            unsigned a[4];
            ldsm_x4(arow + 2 * k * kHalo * kF1P, a);
            mma(acc, a, b.x, b.y);
          }
        } else {
          unsigned a[kPieces][4];
          uint2 b[kPieces];
#pragma unroll
          for (int k = 0; k < kPieces; ++k) {
            ldsm_x4(arow + 2 * k * kHalo * kF1P, a[k]);
            b[k] = w1g[(k * 16 + tap) * 32 + lane];
          }
          mma_pairs(acc, a, b);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int py, px;
        const bool valid_h = class_pos(cls, r0 + g + 8 * h, py, px);
        float pc[2][kPieces];
#pragma unroll
        for (int c = 0; c < 2; ++c) split3(acc[2 * h + c] * d0[j][2 * h + c], pc[c]);
        if (valid_h) {
#pragma unroll
          for (int k = 0; k < kPieces; ++k)
            *reinterpret_cast<unsigned*>(dp0 + (k * kPos0 + py * kT0 + px) * kF0 + 2 * q) =
                pack(pc[0][k], pc[1][k]);
        }
      }
    }
    __syncthreads();

    // dx per m-tile: parity class cls = (ry % 2, rx % 2), row a = ry / 2, the 16
    // pixels b = rx / 2; every pixel of the class takes taps (ty, tx), ky = 1 - ry % 2
    // + 2 ty, at stage-0 position (a + 1 + ry % 2 - ty, b + 1 + rx % 2 - tx).  K-step
    // s pairs taps (s, 0) and (s, 1); each product starts from zero and is added in
    // float32 (bf16: one per piece of dpre0; float32: mma_pairs), and the sum is
    // rounded once to T.
#pragma unroll
    for (int j = 0; j < kDxTiles / kWarps; ++j) {
      const int mt = warp + kWarps * j, cls = mt / (kTX / 2), a = mt % (kTX / 2);
      const int cy = cls >> 1, cx = cls & 1;
      float acc[4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int py = a + 1 + cy - s, px = lane % 16 + 1 + cx - lane / 16;
        const unsigned arow = saddr(dp0 + (py * kT0 + px) * kF0);
        if constexpr (kPc == 1) {
          const uint2 b = w0x[(cls * 2 + s) * 32 + lane];
#pragma unroll
          for (int k = 0; k < kPieces; ++k) {
            unsigned af[4];
            ldsm_x4(arow + 2 * k * kPos0 * kF0, af);
            float part[4] = {};
            mma(part, af, b.x, b.y);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] += part[i];
          }
        } else {
          unsigned af[kPieces][4];
          uint2 b[kPieces];
#pragma unroll
          for (int k = 0; k < kPieces; ++k) {
            ldsm_x4(arow + 2 * k * kPos0 * kF0, af[k]);
            b[k] = w0x[(k * 8 + cls * 2 + s) * 32 + lane];
          }
          mma_pairs(acc, af, b);
        }
      }
      if (2 * q < C) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ry = 2 * a + cy, rx = 2 * (g + 8 * h) + cx;
          store_pair(dxs + (ry * kTX + rx) * C + 2 * q, acc[2 * h], acc[2 * h + 1]);
        }
      }
    }
    __syncthreads();

    // the tile's dx, 16 bytes a store
    constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes: a pixel or two
    for (int i = tid; i < kTX * kTX * C / kVec; i += blockDim.x) {
      const int e = kVec * i, ry = e / C / kTX, rx = e / C % kTX;
      const int iy = kTX * t.ty + ry, ix = kTX * t.tx + rx;
      if (iy < P && ix < P)
        *reinterpret_cast<uint4*>(dx + (((size_t)t.n * P + iy) * P + ix) * C + e % C) =
            *reinterpret_cast<const uint4*>(dxs + e);
    }
  }
  cp_async_wait_all();
}

}  // namespace tc

int tiles_per_side(int P) { return (P / 4 + kT1 - 1) / kT1; }

// the fixed grids: per_sm blocks on each SM walking the tiles, or one block a tile
int grid(int ntiles, int per_sm) {
  return ntiles < per_sm * tc::kSMs ? ntiles : per_sm * tc::kSMs;
}

// K3 in both dtypes on the tensor cores
template <typename T, int C>
int fwd(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, int B, int P,
        T* out, cudaStream_t stream) {
  using S = tc::FwdSmem<C, T>;
  const int tps = tiles_per_side(P);
  const int ntiles = B * tps * tps;
  cudaError_t err = lshm::allow_smem(tc::head_fwd_tc_kernel<C, T>, S::bytes);
  if (err != cudaSuccess) return (int)err;
  tc::head_fwd_tc_kernel<C, T><<<grid(ntiles, S::per_sm), kThreads, S::bytes, stream>>>(
      x, w0, b0, w1, b1, P, tps, ntiles, out);
  return (int)cudaGetLastError();
}

// Both dtypes on the tensor cores: float32 tc::head_bwd_f32_tc_kernel, bfloat16
// tc::head_bwd_tc_kernel.  Each writes one row of partials per block, added in a fixed
// order.
template <typename T, int C>
int bwd(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, const T* g1, int B,
        int P, float* partial, float* grads, cudaStream_t stream) {
  using L = Layout<C>;
  const int tps = tiles_per_side(P);
  const int ntiles = B * tps * tps;
  const int nblk = ntiles < kBwdBlocks ? ntiles : kBwdBlocks;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int bytes = tc::F32Smem<C>::bytes;
    cudaError_t err = lshm::allow_smem(tc::head_bwd_f32_tc_kernel<C>, bytes);
    if (err != cudaSuccess) return (int)err;
    tc::head_bwd_f32_tc_kernel<C><<<nblk, kThreads, bytes, stream>>>(x, w0, b0, w1, b1, g1,
                                                                     P, tps, ntiles, partial);
  } else {
    constexpr int bytes = tc::Smem<C>::bytes;
    cudaError_t err = lshm::allow_smem(tc::head_bwd_tc_kernel<C>, bytes);
    if (err != cudaSuccess) return (int)err;
    tc::head_bwd_tc_kernel<C><<<nblk, kThreads, bytes, stream>>>(x, w0, b0, w1, b1, g1, P,
                                                                 tps, ntiles, partial);
  }
  lshm::launch_reduce_partials(partial, nblk, L::nacc, 1.0f, grads, stream);
  return (int)cudaGetLastError();
}

// K5 in both dtypes on the tensor cores, in two passes
template <typename T, int C>
int dx_pass(const T* x, const T* w0, const T* b0, const T* w1, const T* b1, const T* g1,
            int B, int P, float* dpre1, T* dx, cudaStream_t stream) {
  using S1 = tc::FwdSmem<C, T>;
  using S2 = tc::DxSmem<C, T>;
  const int tps = tiles_per_side(P);
  const int ntiles = B * tps * tps;
  cudaError_t err = lshm::allow_smem(tc::dpre1_tc_kernel<C, T>, S1::bytes);
  if (err != cudaSuccess) return (int)err;
  tc::dpre1_tc_kernel<C, T><<<grid(ntiles, S1::per_sm), kThreads, S1::bytes, stream>>>(
      x, w0, b0, w1, b1, g1, P, tps, ntiles, dpre1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = lshm::allow_smem(tc::head_dx_tc_kernel<C, T>, S2::bytes);
  if (err != cudaSuccess) return (int)err;
  tc::head_dx_tc_kernel<C, T><<<grid(ntiles, S2::per_sm), kThreads, S2::bytes, stream>>>(
      x, w0, b0, w1, b1, dpre1, P, tps, ntiles, dx);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_c(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
          int B, int P, int C, void* out, cudaStream_t stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  T* o = static_cast<T*>(out);
  if (C == 4) return fwd<T, 4>(p(x), p(w0), p(b0), p(w1), p(b1), B, P, o, stream);
  if (C == 8) return fwd<T, 8>(p(x), p(w0), p(b0), p(w1), p(b1), B, P, o, stream);
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
