// Tensor-core and asynchronous-copy primitives for sm_90a, shared by the kernels that
// sum on the tensor cores (conv_head.cu: K3, K4, K5; conv0.cu: K6).
//
// Products are mma.sync m16n8k16 (bf16 operands, float32 accumulators) fed by
// ldmatrix from shared memory.  Fragment layouts (g = lane / 4, q = lane % 4): A
// [16 x 16] row-major, a0 = A[g][2q, 2q+1], a1 = A[g+8][..], a2 = A[g][2q+8, 2q+9],
// a3 = A[g+8][2q+8, ..]; B [16 x 8], b0 = B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g];
// C [16 x 8], c0, c1 = C[g][2q, 2q+1], c2, c3 = C[g+8][2q, 2q+1].  ldmatrix .x4: lane
// l gives the address of row l % 8 of matrix l / 8, 16 contiguous bytes.
//
// float32 operands go in as three exact bf16 pieces (split3) and each product as the
// six piece pairs of order 2^-16 and above (mma_pairs): float32's accuracy on the
// tensor cores.
#pragma once

#include "common.cuh"

namespace lshm {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kPieces = 3;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += A B, A [16 x 16] and B [16 x 8] in bf16, d float32
__device__ __forceinline__ void mma(float d[4], const unsigned a[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kBytes from global to shared memory, asynchronously; src_bytes 0 writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         unsigned src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// until at most kPending of this thread's committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned pack(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// v = p[0] + p[1] + p[2] exactly: p[0] = bf16(v), p[1] = bf16(v - p[0]), p[2] the rest
// (a float32 significand is 24 bits, each piece carries 8 and the sign)
__device__ __forceinline__ void split3(float v, float p[kPieces]) {
  p[0] = lshm::round_to<bf16>(v);
  const float r = v - p[0];
  p[1] = lshm::round_to<bf16>(r);
  p[2] = r - p[1];
}

// Pieces of an operand stored as T: a bf16 value is one piece, a float32 one three.
template <typename T>
constexpr int kPiecesOf = std::is_same<T, float>::value ? 3 : 1;

// v in kPc pieces, kept as float: v itself for one piece (pack rounds it to bf16),
// split3 for three
template <int kPc>
__device__ __forceinline__ void split(float v, float p[kPc]) {
  if constexpr (kPc == 1) {
    p[0] = v;
  } else {
    split3(v, p);
  }
}

// (a, b) rounded to T and stored at p, 8-byte (float) or 4-byte (bf16) aligned: the
// two channels 2q, 2q + 1 of an accumulator fragment's row
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// d += A B for A and B each in three bf16 pieces (0 hi, 1 mid, 2 lo), through the six
// piece pairs of order 2^-16 and above: hi.hi into one partial from zero, hi.mid,
// hi.lo, mid.hi, mid.mid and lo.hi chained into a second, their sum added in float32.
// mid.lo, lo.mid and lo.lo (order 2^-24 and below) are left out.
__device__ __forceinline__ void mma_pairs(float d[4], const unsigned a[kPieces][4],
                                          const uint2 b[kPieces]) {
  float hh[4] = {}, lo[4] = {};
  mma(hh, a[0], b[0].x, b[0].y);
  mma(lo, a[0], b[1].x, b[1].y);
  mma(lo, a[0], b[2].x, b[2].y);
  mma(lo, a[1], b[0].x, b[0].y);
  mma(lo, a[1], b[1].x, b[1].y);
  mma(lo, a[2], b[0].x, b[0].y);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += hh[i] + lo[i];
}

}  // namespace tc
}  // namespace lshm
