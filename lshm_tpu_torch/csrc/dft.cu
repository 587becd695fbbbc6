// The Fourier cascade's transform: the orthonormal 2D DFT of NHWC float32 patches with
// the fftshift, real | imag out (dft2_fwd_kernel), and its adjoint (dft2_adj_kernel).
//
// Replaces no TPU kernel: the JAX package computes the transform with dense DFT
// matrices in jnp.einsum (lshm_tpu/models/cascade.py:66-90), which the port's dense path
// repeats as six matrix products (models/cascade.py::fft2_dense); on the card those
// products ran as 53,760 cuBLAS products of inner dimension 4 at 4.5 TFLOP/s, with a
// roll and a cat over the result.  This is an FFT in shared memory instead.
//
//   forward  x [N, P, P, C] -> out [N, P, P, 2C]:
//            Z = F x (F the orthonormal 2D DFT over h and w), out[n, s(kh), s(kw), c] =
//            Re Z[kh, kw] of channel c, out[..., C + c] = Im, s(k) = (k + P/2) mod P
//   adjoint  g [N, P, P, 2C] -> dx [N, P, P, C]:
//            dx = Re(F^H G), G[k] = g[s(k), re] + i g[s(k), im]
//
// P is a power of two, 8 <= P <= 128; C is 2, 4 or 8.  float32 throughout: the
// transform is bound by bytes, not by operations.
//
// Design.  One CTA transforms one pair of channels (a, b) = (2q, 2q + 1) of one patch as
// one complex plane a + i b, P x P float2 in dynamic shared memory (128 KB at P = 128;
// one CTA an SM, 512 threads).  Each 1D transform of length P = R1 R2 (R1 = 16, R2 = 8
// at P = 128) is the four-step split: a radix-R1 FFT in registers over n1 of the points
// R2 n1 + n2, the twiddle W_P^(n2 k1), then a radix-R2 FFT in registers over n2.  Each
// step reads and writes its own points of the plane in place, so one barrier separates
// the steps and nothing is copied; the result is left in digit-reversed order (position
// R2 k1 + k2 holds frequency k1 + R1 k2), which the last pass undoes in its index
// arithmetic.
//   - forward: rows step 1 straight from device memory (each thread loads its R1 points
//     of a row, the two channels as one float2), rows step 2, columns step 1 and 2 in
//     shared memory, then for each output pixel two neighbouring lanes read Z(k) and
//     Z(-k), separate the two spectra by conjugate symmetry, A = (Z(k) + conj Z(-k)) / 2,
//     B = (Z(k) - conj Z(-k)) / 2i, scale by 1/P and store at the shifted pixel, one lane
//     the real parts (channels 2q, 2q + 1), the other the imaginary parts (C + 2q,
//     C + 2q + 1): no roll and no concatenation.
//   - adjoint: a thread loads g at the pixels shifted from k and from -k once and forms
//     the two channels' Hermitian parts at both, (G(k) + conj G(-k)) / 2 and its
//     conjugate, packed as Ha + i Hb (F^H of each is real, so F^H of the pair is
//     dx_a + i dx_b); rows step 1 and 2, columns step 1 in shared memory with conjugate
//     twiddles, and columns step 2 stores dx_a, dx_b scaled by 1/P.  Nothing is saved
//     from the forward: the map is linear.
// A CTA reads and writes 8 of each pixel's 16 or 32 bytes; the other pairs' CTAs,
// launched beside it, take the rest of each sector from L2.  So each global access
// covers as much of a sector as the pair holds: the forward's two lanes a pixel put its
// real and imaginary parts into one store instruction, and the adjoint loads each pixel
// once for k and -k, four tasks' loads in flight (on the H100 at the Fourier cascade's
// shapes these took the forward from 0.32 to 0.24 ms a launch and the adjoint from 0.28
// to 0.23 ms).  A cluster of the patch's CTAs that met in distributed shared memory, so
// that every access took whole sectors, was slower (0.28 and 0.41 ms).
// The radix FFTs are radix-2 decimation in frequency, unrolled, with the 16th roots of
// unity as constants; the W_P^(n2 k1) are a table of P complex numbers in shared
// memory.  Both are computed in double precision and rounded once to float32.  The
// plane's columns are permuted within each 16-float2 group by row (Dft::at) so that
// the passes on one plane read and write shared memory without bank conflicts at
// P = 128 (one two-way conflict in the forward's mirrored read).
//
// Bound on the H100 at the Fourier cascade's shapes (N = 420, P = 128, C = 4): a call
// moves 110.1 MB in and 220.2 MB out, 98.6 us at 3.35 TB/s, and does about 1 GFLOP
// (5 M log2 M for each complex plane of M points): bound by bytes.

#include "common.cuh"

namespace {

constexpr int kMinLog2 = 3, kMaxLog2 = 7;      // P from 8 to 128

// cos(2 pi j / 16), the 16th roots of unity rounded once to float32
__host__ __device__ constexpr float cos16(int j) {
  switch (j & 15) {
    case 0: return 1.0f;
    case 1: case 15: return 0.92387953251128674f;
    case 2: case 14: return 0.70710678118654752f;
    case 3: case 13: return 0.38268343236508977f;
    case 4: case 12: return 0.0f;
    case 5: case 11: return -0.38268343236508977f;
    case 6: case 10: return -0.70710678118654752f;
    case 7: case 9: return -0.92387953251128674f;
    default: return -1.0f;
  }
}

// k < 2^bits, bits <= 4, with its bits in reverse order (bit operations only, so that
// an unrolled loop's index folds to a constant)
__host__ __device__ constexpr int bit_reverse(int k, int bits) {
  return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3)) >> (4 - bits);
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// z W_16^m, W = exp(-2 pi i / 16) (forward) or its conjugate (kInv); m in [0, 8)
template <bool kInv>
__device__ __forceinline__ float2 rot16(float2 z, int m) {
  if (m == 0) return z;
  if (m == 4) return kInv ? make_float2(-z.y, z.x) : make_float2(z.y, -z.x);
  const float c = cos16(m), s = cos16(m + 12);          // s = sin(2 pi m / 16)
  return kInv ? make_float2(z.x * c - z.y * s, z.y * c + z.x * s)
              : make_float2(z.x * c + z.y * s, z.y * c - z.x * s);
}

// z w (forward) or z conj(w) (kInv)
template <bool kInv>
__device__ __forceinline__ float2 twiddle(float2 z, float2 w) {
  return kInv ? make_float2(z.x * w.x + z.y * w.y, z.y * w.x - z.x * w.y)
              : make_float2(z.x * w.x - z.y * w.y, z.y * w.x + z.x * w.y);
}

// In-register radix-2 FFT of length R (a power of two, at most 16), decimation in
// frequency, one stage a template level (every index a constant, so v stays in
// registers): on return v[bit_reverse(k)] holds V[k] = sum_n v[n] W_R^(n k).
template <int R, bool kInv, int kHalf = R / 2>
__device__ __forceinline__ void fft_reg(float2 (&v)[R]) {
  if constexpr (kHalf >= 1) {
#pragma unroll
    for (int s = 0; s < R; s += 2 * kHalf) {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float2 a = v[s + j], b = v[s + j + kHalf];
        v[s + j] = make_float2(a.x + b.x, a.y + b.y);
        v[s + j + kHalf] = rot16<kInv>(make_float2(a.x - b.x, a.y - b.y), j * 8 / kHalf);
      }
    }
    fft_reg<R, kInv, kHalf / 2>(v);
  }
}

template <int L>
struct Dft {
  static constexpr int P = 1 << L;
  static constexpr int R1 = 1 << ((L + 1) / 2);      // the first step's radix
  static constexpr int R2 = P / R1;                  // the second's
  static constexpr int kThreads = P * P / 8 < 32 ? 32 : (P * P / 8 > 512 ? 512 : P * P / 8);
  static constexpr size_t kSmem = sizeof(float2) * (P * P + P);   // the plane, twiddles

  // the plane's element (h, w): within each group of 16 columns, rotated by
  // (w / 16 + 8 h) mod 16, so that 16 lanes on one row at stride 1 or 8, or on rows h
  // and h + 1, fall in 16 different float2 banks
  __device__ static __forceinline__ int at(int h, int w) {
    if constexpr (P >= 16) {
      return h * P + (w & ~15) + ((w + (w >> 4) + 8 * h) & 15);
    } else {
      return h * P + w;
    }
  }

  // the position of frequency (or, in the adjoint, index) k after both steps
  __device__ static __forceinline__ int pos(int k) { return R2 * (k % R1) + k / R1; }

  // tw[R2 k1 + n2] = W_P^(n2 k1) = exp(-2 pi i n2 k1 / P), from double precision (the
  // lanes of a row's step 1 take neighbouring n2: no bank conflict)
  __device__ static void load_twiddles(float2* tw) {
    for (int m = threadIdx.x; m < P; m += kThreads) {
      double s, c;
      sincospi(2.0 * ((m % R2) * (m / R2)) / P, &s, &c);
      tw[m] = make_float2((float)c, (float)-s);
    }
  }

  // Step 1 on v[n1] = line[R2 n1 + n2]: the radix-R1 FFT, then W_P^(n2 k1); writes
  // line[R2 k1 + n2] through put(k1, value)
  template <bool kInv, typename Put>
  __device__ static __forceinline__ void step1(float2 (&v)[R1], int n2, const float2* tw,
                                               Put put) {
    constexpr int kBits = log2_of(R1);
    fft_reg<R1, kInv>(v);
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      const float2 z = v[bit_reverse(k1, kBits)];
      put(k1, k1 == 0 ? z : twiddle<kInv>(z, tw[R2 * k1 + n2]));
    }
  }

  // Step 2 on v[n2] = line[R2 k1 + n2]: the radix-R2 FFT; writes frequency k1 + R1 k2
  // through put(k2, value)
  template <bool kInv, typename Put>
  __device__ static __forceinline__ void step2(float2 (&v)[R2], Put put) {
    constexpr int kBits = log2_of(R2);
    fft_reg<R2, kInv>(v);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) put(k2, v[bit_reverse(k2, kBits)]);
  }

  // Rows step 2, then columns step 1 and step 2 of columns in place, barriers between
  template <bool kInv>
  __device__ static void rows2_cols1(float2* s, const float2* tw) {
    for (int t = threadIdx.x; t < P * R1; t += kThreads) {
      const int k1 = t % R1, h = t / R1;
      float2 v[R2];
#pragma unroll
      for (int n2 = 0; n2 < R2; ++n2) v[n2] = s[at(h, R2 * k1 + n2)];
      step2<kInv>(v, [&](int k2, float2 z) { s[at(h, R2 * k1 + k2)] = z; });
    }
    __syncthreads();
    for (int t = threadIdx.x; t < P * R2; t += kThreads) {
      const int w = t % P, n2 = t / P;
      float2 v[R1];
#pragma unroll
      for (int n1 = 0; n1 < R1; ++n1) v[n1] = s[at(R2 * n1 + n2, w)];
      step1<kInv>(v, n2, tw, [&](int k1, float2 z) { s[at(R2 * k1 + n2, w)] = z; });
    }
    __syncthreads();
  }
};

// Forward: CTA b transforms channel pair q = b % (C / 2) of patch b / (C / 2).
template <int L, int C>
__global__ void __launch_bounds__(Dft<L>::kThreads)
    dft2_fwd_kernel(const float* __restrict__ x, float* __restrict__ out) {
  using D = Dft<L>;
  constexpr int P = D::P, R1 = D::R1, R2 = D::R2;
  extern __shared__ float2 smem[];
  float2* s = smem;
  float2* tw = smem + P * P;
  const int n = blockIdx.x / (C / 2), q = blockIdx.x % (C / 2);
  D::load_twiddles(tw);
  __syncthreads();

  // rows, step 1, from device memory: lanes on R2 neighbouring pixels of a few rows
  const float* xp = x + (size_t)n * P * P * C + 2 * q;
  for (int t = threadIdx.x; t < P * R2; t += D::kThreads) {
    const int n2 = t % R2, h = t / R2;
    float2 v[R1];
#pragma unroll
    for (int n1 = 0; n1 < R1; ++n1)
      v[n1] = *reinterpret_cast<const float2*>(xp + ((size_t)h * P + R2 * n1 + n2) * C);
    D::template step1<false>(v, n2, tw,
                             [&](int k1, float2 z) { s[D::at(h, R2 * k1 + n2)] = z; });
  }
  __syncthreads();
  D::template rows2_cols1<false>(s, tw);

  // columns, step 2, in place
  for (int t = threadIdx.x; t < P * R1; t += D::kThreads) {
    const int w = t % P, k1 = t / P;
    float2 v[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) v[n2] = s[D::at(R2 * k1 + n2, w)];
    D::template step2<false>(v, [&](int k2, float2 z) { s[D::at(R2 * k1 + k2, w)] = z; });
  }
  __syncthreads();

  // separate the two spectra, scale, shift, store: two neighbouring lanes a pixel, the
  // real parts (channels 2q, 2q + 1) and the imaginary parts (C + 2q, C + 2q + 1), so
  // that one store instruction covers both halves of the pixel's pair in one sector
  constexpr float kScale = 0.5f / P;
  float* op = out + (size_t)n * P * P * 2 * C + 2 * q;
#pragma unroll 4
  for (int t = threadIdx.x; t < 2 * P * P; t += D::kThreads) {
    const int im = t % 2, ws = t / 2 % P, hs = t / (2 * P);
    const int kh = (hs + P / 2) % P, kw = (ws + P / 2) % P;
    const float2 z = s[D::at(D::pos(kh), D::pos(kw))];
    const float2 m = s[D::at(D::pos((P - kh) % P), D::pos((P - kw) % P))];
    *reinterpret_cast<float2*>(op + ((size_t)hs * P + ws) * 2 * C + im * C) =
        im ? make_float2(kScale * (z.y - m.y), kScale * (m.x - z.x))
           : make_float2(kScale * (z.x + m.x), kScale * (z.y + m.y));
  }
}

// Adjoint: the same CTAs.
template <int L, int C>
__global__ void __launch_bounds__(Dft<L>::kThreads)
    dft2_adj_kernel(const float* __restrict__ g, float* __restrict__ dx) {
  using D = Dft<L>;
  constexpr int P = D::P, R1 = D::R1, R2 = D::R2;
  extern __shared__ float2 smem[];
  float2* s = smem;
  float2* tw = smem + P * P;
  const int n = blockIdx.x / (C / 2), q = blockIdx.x % (C / 2);
  D::load_twiddles(tw);

  // the Hermitian parts of channels a and b, packed as Y = Ha + i Hb, at k and at -k
  // from one load of each of the two pixels (shifted from k and from -k): a task for
  // each pair {k, -k}, rows 1 .. P/2 - 1 whole, then rows 0 and P/2 to column P/2;
  // lanes on neighbouring frequencies
  constexpr int kMain = (P / 2 - 1) * P;
  const float* gp = g + (size_t)n * P * P * 2 * C + 2 * q;
#pragma unroll 4                          // the loads of four tasks in flight
  for (int t = threadIdx.x; t < kMain + P + 2; t += D::kThreads) {
    const int u = t - kMain;
    const int kh = t < kMain ? 1 + t / P : (u <= P / 2 ? 0 : P / 2);
    const int kw = t < kMain ? t % P : (u <= P / 2 ? u : u - (P / 2 + 1));
    const int mh = (P - kh) % P, mw = (P - kw) % P;
    const float* a = gp + ((size_t)((kh + P / 2) % P) * P + (kw + P / 2) % P) * 2 * C;
    const float* b = gp + ((size_t)((mh + P / 2) % P) * P + (mw + P / 2) % P) * 2 * C;
    const float2 re = *reinterpret_cast<const float2*>(a);       // (Re Ga, Re Gb)(k)
    const float2 im = *reinterpret_cast<const float2*>(a + C);   // (Im Ga, Im Gb)(k)
    const float2 rm = *reinterpret_cast<const float2*>(b);       // the same at -k
    const float2 imm = *reinterpret_cast<const float2*>(b + C);
    // Ha(k) = (hra, hia), Hb(k) = (hrb, hib); Ha(-k) = conj Ha(k), Hb(-k) = conj Hb(k)
    const float hra = 0.5f * (re.x + rm.x), hia = 0.5f * (im.x - imm.x);
    const float hrb = 0.5f * (re.y + rm.y), hib = 0.5f * (im.y - imm.y);
    s[D::at(kh, kw)] = make_float2(hra - hib, hia + hrb);
    s[D::at(mh, mw)] = make_float2(hra + hib, hrb - hia);
  }
  __syncthreads();

  // rows, step 1, in place
  for (int t = threadIdx.x; t < P * R2; t += D::kThreads) {
    const int n2 = t % R2, h = t / R2;
    float2 v[R1];
#pragma unroll
    for (int n1 = 0; n1 < R1; ++n1) v[n1] = s[D::at(h, R2 * n1 + n2)];
    D::template step1<true>(v, n2, tw,
                            [&](int k1, float2 z) { s[D::at(h, R2 * k1 + n2)] = z; });
  }
  __syncthreads();
  D::template rows2_cols1<true>(s, tw);

  // columns, step 2, to device memory scaled by 1/P: lanes on neighbouring pixels of a
  // row, each column read from its digit-reversed position
  constexpr float kScale = 1.0f / P;
  float* dp = dx + (size_t)n * P * P * C + 2 * q;
  for (int t = threadIdx.x; t < P * R1; t += D::kThreads) {
    const int jw = t % P, k1 = t / P, w = D::pos(jw);
    float2 v[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) v[n2] = s[D::at(R2 * k1 + n2, w)];
    D::template step2<true>(v, [&](int k2, float2 z) {
      *reinterpret_cast<float2*>(dp + ((size_t)(k1 + R1 * k2) * P + jw) * C) =
          make_float2(kScale * z.x, kScale * z.y);
    });
  }
}

template <int L, int C>
int launch(bool adjoint, const float* in, int N, float* out, cudaStream_t stream) {
  using D = Dft<L>;
  void (*kernel)(const float*, float*) =
      adjoint ? dft2_adj_kernel<L, C> : dft2_fwd_kernel<L, C>;
  cudaError_t err = lshm::allow_smem(kernel, D::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N * (C / 2), D::kThreads, D::kSmem, stream>>>(in, out);
  return (int)cudaGetLastError();
}

template <int L>
int launch_c(bool adjoint, const float* in, int N, int C, float* out, cudaStream_t stream) {
  if (C == 2) return launch<L, 2>(adjoint, in, N, out, stream);
  if (C == 4) return launch<L, 4>(adjoint, in, N, out, stream);
  if (C == 8) return launch<L, 8>(adjoint, in, N, out, stream);
  return (int)cudaErrorInvalidValue;
}

template <int L = kMinLog2>
int dispatch(bool adjoint, const float* in, int N, int P, int C, float* out,
             cudaStream_t stream) {
  if (P == (1 << L)) return launch_c<L>(adjoint, in, N, C, out, stream);
  if constexpr (L < kMaxLog2) {
    return dispatch<L + 1>(adjoint, in, N, P, C, out, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

int run(bool adjoint, const float* in, int N, int P, int C, float* out,
        cudaStream_t stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  return dispatch(adjoint, in, N, P, C, out, stream);
}

}  // namespace

extern "C" {

// x [N, P, P, C] -> out [N, P, P, 2C], float32 NHWC; P a power of two in [8, 128], C in
// {2, 4, 8}.
int dft2_fwd(const float* x, int N, int P, int C, float* out, cudaStream_t stream) {
  return run(false, x, N, P, C, out, stream);
}

// g [N, P, P, 2C] -> dx [N, P, P, C], the adjoint of dft2_fwd.
int dft2_adj(const float* g, int N, int P, int C, float* dx, cudaStream_t stream) {
  return run(true, g, N, P, C, dx, stream);
}

}  // extern "C"
