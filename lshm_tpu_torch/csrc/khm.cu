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
// dispatcher does).
//
// Design: each pass is ONE launch of ONE thread block cluster of G CTAs (G = 16, the
// wrapper's kernels/khm.py::CLUSTER; above 8 the size is non-portable, and Hopper
// allows 16) of W warps (W = 16, 512 threads, 128 registers a thread; fewer where the
// shared memory below does not fit: kernels/khm.py::plan).  The TPU kernel carried
// the loss and dM across its sequential grid with +=; here the CTAs of the cluster
// exchange those sums through distributed shared memory (DSMEM): no second launch, no
// scratch in device memory and no float atomic, so two runs are bit-identical.
//   - Each CTA loads M [K, D] into shared memory once, and |m_k|^2 (one warp per k).
//   - CTA rank r takes the rows r, r + G, r + 2 G, ... in rounds of 2 W rows; warp w
//     takes two rows of a round at once (kRows), copied into its slots of shared memory
//     with their |x|^2.  For a chunk of NC centroids (8, then 4, 2, 1: K = 10 is 8 + 2,
//     each width known at compile time) each lane sums x_d m_kd over its d = lane + 32 i
//     for both rows with one load of m_kd, and reduce_scatter sums the 2 NC values over
//     the warp with the pairing of an xor butterfly (bit for bit lshm::warp_sum's) in
//     2 NC + 4 - log2(2 NC) shuffles instead of 10 NC, leaving each value in
//     32 / (2 NC) lanes.
//   - K1: a lane owning (row, k) writes 1 / (d2^(p/2) + eps); e_i sums them chunk by
//     chunk (each chunk's sum in order, then the chunks' sums in order); the CTA sums
//     K / (e_i + eps) over its rows in row order (thread 0, round by round); after
//     cluster.sync() rank 0 reads the G CTA sums through DSMEM in rank order and writes
//     the loss.
//   - K2: a lane owning (row, k) writes c_ik to shared memory; the warp writes dX_i,
//     both sums over k chunk by chunk as e_i's, with one load of m_kd for its two rows.
//     After each round the CTA adds the round's rows, in row order, into its running
//     sum_i c_ik x_i [K, D] and sum_i c_ik [K] in shared memory (a thread takes a chunk
//     of centroids by four columns, its sums in registers).  After the last round it
//     forms its dM partial (sum c) m - sum c x; after cluster.sync() rank r sums the
//     r-th slice of the K D entries over the G partials in rank order through DSMEM and
//     writes dM; a last cluster.sync() keeps every CTA's shared memory alive until its
//     peers have read it.
//     Where M and both [K, D] buffers do not fit, K2 reads M from device memory (L2).
//
// Shared memory (floats, Kp = K rounded up to 4): K1  2 W Kp + K D + K + 2 W D + 2 W + 1;
// K2  2 W Kp + (K D if M is in shared memory) + K D + 2 K + 2 W D.  At the main path's
// shapes (K = 10, D = 256, W = 16) 44,716 and 54,864 bytes.  kernels/khm.py::plan repeats
// these sizes.
//
// Bound on the H100: at the main path's shapes (N = 420, D = 256, K = 10) both passes
// move under 1 MB and do ~2 MFLOP, 0.13 and 0.26 us at the memory rate, so they are
// bound by latency: the launch, the loads of M and of the rows, the chains of
// shared-memory loads and shuffles per row (one cluster has 16 of the 132 SMs), and the
// cluster's barriers.  At N = 2,500 the 16 SMs make the kernels slower than the
// two-pass kernels they replace (PERF.md).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 8;              // centroids per pass over the rows, at most
constexpr int kRows = 2;               // rows a warp takes at once
constexpr int kMaxThreads = 512;       // so 128 registers a thread
constexpr int kMaxCluster = 16;        // CTAs in a cluster (above 8: non-portable)
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;    // bytes of shared memory a block can use
constexpr float kEps = 1e-9f;

// Loads M into Ms (when copy) and |m_k|^2 into mm, reading centroids from Mc (Ms or
// M); returns after a block barrier.
__device__ void load_centroids(const float* __restrict__ M, int K, int D, float* Ms,
                               bool copy, float* mm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  if (copy) {                       // four loads in flight before their stores
    for (int i0 = tid; i0 < K * D; i0 += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < K * D ? M[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < K * D) Ms[i] = v[u];
      }
    }
    __syncthreads();
  }
  const float* Mc = copy ? Ms : M;
  for (int k = warp; k < K; k += warps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += Mc[k * D + d] * Mc[k * D + d];
    s = lshm::warp_sum(s);
    if (lane == 0) mm[k] = s;
  }
  __syncthreads();
}

// body(std::integral_constant<int, NC>(), k0) over chunks of centroids [k0, k0 + NC)
// that cover 0 .. K - 1 in order: chunks of 8, then at most one each of 4, 2, 1, so
// every chunk has a width known at compile time (no predicated shuffles).
template <typename Body>
__device__ __forceinline__ void over_chunks(int K, Body&& body) {
  int k0 = 0;
  for (; k0 + kChunk <= K; k0 += kChunk) body(std::integral_constant<int, kChunk>(), k0);
  if (K - k0 >= 4) {
    body(std::integral_constant<int, 4>(), k0);
    k0 += 4;
  }
  if (K - k0 >= 2) {
    body(std::integral_constant<int, 2>(), k0);
    k0 += 2;
  }
  if (K - k0 >= 1) body(std::integral_constant<int, 1>(), k0);
}

// The chunks of over_chunks, by number: how many, and the ch-th one's k0 and width.
__device__ __forceinline__ int num_chunks(int K) { return K / kChunk + __popc(K % kChunk); }

__device__ __forceinline__ void chunk_at(int K, int ch, int& k0, int& nc) {
  k0 = min(ch, K / kChunk) * kChunk;
  ch -= K / kChunk;
  nc = kChunk;
  for (int w = kChunk / 2; ch >= 0; w /= 2) {
    if (K - k0 >= w) {
      nc = w;
      if (ch-- == 0) return;
      k0 += w;
    }
  }
}

// body(std::integral_constant<int, nc>()) for a run-time chunk width nc.
template <typename Body>
__device__ __forceinline__ void with_width(int nc, Body&& body) {
  switch (nc) {
    case 8: body(std::integral_constant<int, 8>()); break;
    case 4: body(std::integral_constant<int, 4>()); break;
    case 2: body(std::integral_constant<int, 2>()); break;
    default: body(std::integral_constant<int, 1>()); break;
  }
}

// v = p[0 .. NC) from shared memory in 16-, 8- or 4-byte loads (p aligned to match:
// chunks start at multiples of their width, rows of cs at multiples of 4 floats).
template <int NC>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[NC]) {
  if constexpr (NC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
  } else if constexpr (NC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// v[q] for a run-time q < N, without indexing a register array.
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int q) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = q == i ? v[i] : r;
  return r;
}

// The warp's kRows rows of this round, row[q], into its slots xr + q D of shared
// memory (zeros for a row at or past N); xx[q] = |x_q|^2 in every lane (each lane sums
// d = lane + 32 i, then lshm::warp_sum).
__device__ __forceinline__ void load_rows(const float* __restrict__ X, const int (&row)[kRows],
                                          int N, int D, float* __restrict__ xr,
                                          float (&xx)[kRows]) {
  constexpr int kUnroll = 4;        // loads in flight per row before their stores
  const int lane = threadIdx.x % 32;
  float s[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) s[q] = 0.0f;
  for (int d0 = lane; d0 < D; d0 += 32 * kUnroll) {
    float v[kRows][kUnroll];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int d = d0 + 32 * u;
        v[q][u] = row[q] < N && d < D ? X[(size_t)row[q] * D + d] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int d = d0 + 32 * u;
        if (d < D) {
          xr[q * D + d] = v[q][u];
          s[q] += v[q][u] * v[q][u];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) xx[q] = lshm::warp_sum(s[q]);
  __syncwarp();
}

// Sums V values (a power of two, at most 32) over the warp at once, with the pairing of
// lshm::warp_sum's xor butterfly, so each sum equals warp_sum's bit for bit: at each
// step a lane keeps half of its values, adds its partner's copy of them and hands the
// other half over (V - 1 + 5 - log2 V shuffles instead of 5 V).  Afterwards v[0] in
// lane l is the sum of value l >> (5 - log2 V).
template <int N, int OFF, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool upper = lane & OFF;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float keep = upper ? v[j + N / 2] : v[j];
        const float send = upper ? v[j] : v[j + N / 2];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<N / 2, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, lane);
    }
  }
}

// The kRows x NC dot products x_q . m_k (k = k0 + j) of the rows in xr, spread over the
// lanes: lane l returns the one with q NC + j = l >> (5 - log2(kRows NC)).  Each lane
// sums its d = lane + 32 i with one load of m_kd for all kRows rows.
template <int NC>
__device__ __forceinline__ float dots(const float* xr, const float* Mc, int k0, int D,
                                      int lane) {
  constexpr int V = kRows * NC;
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
  const float* m = Mc + (size_t)k0 * D;
  for (int d = lane; d < D; d += 32) {
    float x[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) x[q] = xr[q * D + d];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float mv = m[j * D + d];
#pragma unroll
      for (int q = 0; q < kRows; ++q) v[q * NC + j] += x[q] * mv;
    }
  }
  reduce_scatter<V, 16>(v, lane);
  return v[0];
}

// v[0] + ... + v[NC - 1] in order.  The sums over k (e_i, sum_k c_ik, sum_k c_ik m_k)
// add each chunk's sum into the total: at K = 200, one sum in order over all k lay 4 to
// 6 times farther from float64 than the plain version's.
template <int NC>
__device__ __forceinline__ float chunk_sum(const float (&v)[NC]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) s += v[j];
  return s;
}

// v = p[0 .. DQ) (DQ = 1 or 4; p 16-byte aligned for 4), and the store back.
template <int DQ>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[DQ]) {
  if constexpr (DQ == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    v[0] = p[0];
  }
}

template <int DQ>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[DQ]) {
  if constexpr (DQ == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// sum_{i < n} part(i) in increasing i, n <= N: the loads are issued together, then
// added in order.
template <int N, typename Part>
__device__ __forceinline__ float ordered_sum(int n, Part part) {
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < n ? part(i) : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) s += v[i];
  return s;
}

// cx[k, d] += sum_{s < rows} c_s,k x_s,d over the round's rows in order (cs [rows, Kp],
// xs [rows, D]): a thread takes one chunk of centroids by DQ adjacent columns (DQ = 4:
// 16-byte loads of x; D % 4 == 0 and xs, cx 16-byte aligned), DQ NC sums in registers.
template <int DQ>
__device__ __forceinline__ void accumulate_cx(const float* cs, const float* xs, int rows,
                                              int K, int Kp, int D, float* cx) {
  const int cols = D / DQ;
  for (int item = threadIdx.x; item < num_chunks(K) * cols; item += blockDim.x) {
    const int ch = item / cols, d = (item - ch * cols) * DQ;
    int k0, width;
    chunk_at(K, ch, k0, width);
    with_width(width, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      float a[NC][DQ], c[NC], x[DQ];
#pragma unroll
      for (int j = 0; j < NC; ++j) load_cols<DQ>(cx + (k0 + j) * D + d, a[j]);
#pragma unroll 4
      for (int s = 0; s < rows; ++s) {
        load_cols<DQ>(xs + s * D + d, x);
        load_chunk<NC>(cs + s * Kp + k0, c);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
          for (int u = 0; u < DQ; ++u) a[j][u] += c[j] * x[u];
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) store_cols<DQ>(cx + (k0 + j) * D + d, a[j]);
    });
  }
}

__global__ void __launch_bounds__(kMaxThreads)
khm_fwd_cluster_kernel(const float* __restrict__ X, const float* __restrict__ M, int N,
                       int K, int D, int p, float* __restrict__ e_out,
                       float* __restrict__ loss) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Kp = (K + 3) / 4 * 4, RW = kRows * W;
  float* rb = smem;                 // [RW, Kp]: 1 / (d2^(p/2) + eps) of the round's rows
  float* Ms = rb + RW * Kp;         // [K, D]
  float* mm = Ms + K * D;           // [K]
  float* xs = mm + K;               // [RW, D]: the round's rows
  float* cb = xs + RW * D;          // [RW]: K / (e_i + eps) of the round's rows
  float* cta_sum = cb + RW;         // [1], read by rank 0 through DSMEM
  load_centroids(M, K, D, Ms, true, mm);

  float* xr = xs + kRows * warp * D;
  float* rr = rb + kRows * warp * Kp;
  float acc = 0.0f;                 // thread 0: the sum over the CTA's rows, in order
  // a round: the CTA's rows base + G s, slot s = 0 .. RW - 1; warp w takes the kRows
  // slots from kRows w
  for (int base = rank; base < N; base += G * RW) {
    int row[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) row[q] = base + G * (kRows * warp + q);
    float xx[kRows];
    load_rows(X, row, N, D, xr, xx);
    over_chunks(K, [&](auto nc, int k0) {
      constexpr int NC = decltype(nc)::value, S = 5 - log2i(kRows * NC);
      const int q = (lane >> S) / NC, j = (lane >> S) % NC;
      const float dot = dots<NC>(xr, Ms, k0, D, lane);
      const float d2 = fmaxf(pick(xx, q) + mm[k0 + j] - 2.0f * dot, 0.0f);
      if ((lane & ((1 << S) - 1)) == 0)  // __frcp_rn(t): 1.0f / t, correctly rounded
        rr[q * Kp + k0 + j] = __frcp_rn(lshm::ipow(d2, p / 2) + kEps);
    });
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (row[q] >= N) continue;
      float e = 0.0f;               // e_i: each chunk's sum, then the chunks', in order
      over_chunks(K, [&](auto nc, int k0) {
        constexpr int NC = decltype(nc)::value;
        float r[NC];
        load_chunk<NC>(rr + q * Kp + k0, r);
        e += chunk_sum<NC>(r);
      });
      if (lane == 0) {
        e_out[row[q]] = e;
        cb[kRows * warp + q] = (float)K / (e + kEps);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int rows = min(RW, (N - base + G - 1) / G);
      for (int s = 0; s < rows; ++s) acc += cb[s];
    }
    __syncthreads();                // before the next round overwrites xs, rb and cb
  }
  if (threadIdx.x == 0) *cta_sum = acc;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const float s = ordered_sum<kMaxCluster>(
        G, [&](int r) { return *cluster.map_shared_rank(cta_sum, r); });
    *loss = s / ((float)N * (float)K * (float)D);
  }
  cluster.sync();                   // rank 0 has read every CTA's sum
}

template <bool kMShared>
__global__ void __launch_bounds__(kMaxThreads)
khm_bwd_cluster_kernel(const float* __restrict__ X, const float* __restrict__ M,
                       const float* __restrict__ e_in, const float* __restrict__ g_in,
                       int N, int K, int D, int p, float* __restrict__ dX,
                       float* __restrict__ dM) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int T = blockDim.x, W = T / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KD = K * D, Kp = (K + 3) / 4 * 4, RW = kRows * W;
  float* cs = smem;                          // [RW, Kp]: c_ik of the round's rows
  float* xs = cs + RW * Kp;                  // [RW, D]: the round's rows
  float* Ms = xs + RW * D;                   // [K, D] when kMShared
  float* cx = Ms + (kMShared ? KD : 0);      // [K, D]: sum_i c_ik x_i, then the partial
  float* csum = cx + KD;                     // [K]: sum_i c_ik
  float* mm = csum + K;                      // [K]
  const float g = *g_in;
  for (int i = threadIdx.x; i < KD; i += T) cx[i] = 0.0f;
  for (int k = threadIdx.x; k < K; k += T) csum[k] = 0.0f;
  load_centroids(M, K, D, Ms, kMShared, mm);
  const float* Mc = kMShared ? Ms : M;

  const float nd = (float)N * (float)D;
  float* xr = xs + kRows * warp * D;
  float* cr = cs + kRows * warp * Kp;
  // rounds as in the forward
  for (int base = rank; base < N; base += G * RW) {
    int row[kRows];
    float denom[kRows];             // (N D) (e_i + eps)^2
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      row[q] = base + G * (kRows * warp + q);
      const float ee = row[q] < N ? e_in[row[q]] + kEps : 1.0f;
      denom[q] = nd * (ee * ee);
    }
    float xx[kRows];
    load_rows(X, row, N, D, xr, xx);
    over_chunks(K, [&](auto nc, int k0) {
      constexpr int NC = decltype(nc)::value, S = 5 - log2i(kRows * NC);
      const int q = (lane >> S) / NC, j = (lane >> S) % NC;
      const float dot = dots<NC>(xr, Mc, k0, D, lane);
      const float d2 = fmaxf(pick(xx, q) + mm[k0 + j] - 2.0f * dot, 0.0f);
      const float t = lshm::ipow(d2, p / 2) + kEps;
      const float c = ((float)p * lshm::ipow(d2, p / 2 - 1)) / (pick(denom, q) * t * t) * g;
      if ((lane & ((1 << S) - 1)) == 0) cr[q * Kp + k0 + j] = c;
    });
    __syncwarp();
    // dX_i = (sum_k c_ik) x_i - sum_k c_ik m_k, both sums chunk by chunk as e_i's; one
    // load of m_kd for the warp's rows
    float crow[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      crow[q] = 0.0f;
      over_chunks(K, [&](auto nc, int k0) {
        constexpr int NC = decltype(nc)::value;
        float c[NC];
        load_chunk<NC>(cr + q * Kp + k0, c);
        crow[q] += chunk_sum<NC>(c);
      });
    }
    for (int d = lane; d < D; d += 32) {
      float cm[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) cm[q] = 0.0f;
      over_chunks(K, [&](auto nc, int k0) {
        constexpr int NC = decltype(nc)::value;
        float c[kRows][NC];
#pragma unroll
        for (int q = 0; q < kRows; ++q) load_chunk<NC>(cr + q * Kp + k0, c[q]);
        float part[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) part[q] = 0.0f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float mv = Mc[(size_t)(k0 + j) * D + d];
#pragma unroll
          for (int q = 0; q < kRows; ++q) part[q] += c[q][j] * mv;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) cm[q] += part[q];
      });
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (row[q] < N) dX[(size_t)row[q] * D + d] = crow[q] * xr[q * D + d] - cm[q];
    }
    __syncthreads();
    // the round's rows into the CTA's running sums, in row order: a thread takes a
    // chunk of centroids and four columns (one where D is not a multiple of 4), its
    // sums in registers
    const int rows = min(RW, (N - base + G - 1) / G);
    if (D % 4 == 0)
      accumulate_cx<4>(cs, xs, rows, K, Kp, D, cx);
    else
      accumulate_cx<1>(cs, xs, rows, K, Kp, D, cx);
    for (int k = T - 1 - threadIdx.x; k >= 0 && k < K; k += T) {   // the last threads
      float a = csum[k];
      for (int s = 0; s < rows; ++s) a += cs[s * Kp + k];
      csum[k] = a;
    }
    __syncthreads();                // before the next round overwrites xs and cs
  }
  for (int idx = threadIdx.x; idx < KD; idx += T) {   // this CTA's share of dM
    const int k = idx / D;
    cx[idx] = csum[k] * Mc[idx] - cx[idx];
  }
  cluster.sync();
  // rank r writes the r-th slice of dM, the G partials summed in rank order
  const int per = (KD + G - 1) / G, lo = rank * per, hi = min(KD, lo + per);
  for (int idx = lo + threadIdx.x; idx < hi; idx += T)
    dM[idx] = ordered_sum<kMaxCluster>(
        G, [&](int r) { return cluster.map_shared_rank(cx, r)[idx]; });
  cluster.sync();                   // every peer has read this CTA's partial
}

size_t fwd_smem(int K, int D, int W) {
  const size_t rw = (size_t)kRows * W, kp = (K + 3) / 4 * 4;
  return sizeof(float) * (rw * kp + (size_t)K * D + K + rw * D + rw + 1);
}
size_t bwd_smem(int K, int D, int W, bool m_shared) {
  const size_t rw = (size_t)kRows * W, kp = (K + 3) / 4 * 4;
  return sizeof(float) * (rw * kp + (m_shared ? 2 : 1) * (size_t)K * D + 2 * K + rw * D);
}

// Per-device record of the attributes already set on a kernel, so a call sets an
// attribute only when its value changes.
struct Prepared {
  size_t smem = 48 * 1024;
  bool nonportable = false;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, Prepared* per_device, int device, size_t smem,
                    int cluster) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Prepared& done = per_device[device];
  if (smem > done.smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done.smem = smem;
  }
  if (cluster > 8 && !done.nonportable) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done.nonportable = true;
  }
  return cudaSuccess;
}

// Launches kernel(args...) as one cluster of `cluster` CTAs of 32 `warps` threads on
// `device` (made current for the launch, then restored).
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, Prepared* per_device, int device, int cluster,
                   int warps, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > kMaxSmem || warps < 1 || warps > kMaxThreads / 32 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare(kernel, per_device, device, smem, cluster);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(32 * warps);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

Prepared fwd_prepared[kMaxDevices];
Prepared bwd_prepared[2][kMaxDevices];

}  // namespace

extern "C" {

// e: [N], loss: one float.  warps (W) and cluster (G) as in the header.
int khm_fwd(const float* X, const float* M, int N, int K, int D, int p, int warps,
            int cluster, int device, float* e, float* loss, cudaStream_t stream) {
  return launch_cluster(khm_fwd_cluster_kernel, fwd_prepared, device, cluster, warps,
                        fwd_smem(K, D, warps), stream, X, M, N, K, D, p, e, loss);
}

// g: one float on the device (the loss cotangent).  m_shared: M in shared memory.
int khm_bwd(const float* X, const float* M, const float* e, const float* g, int N, int K,
            int D, int p, int warps, int cluster, int m_shared, int device, float* dX,
            float* dM, cudaStream_t stream) {
  const size_t smem = bwd_smem(K, D, warps, m_shared != 0);
  if (m_shared)
    return launch_cluster(khm_bwd_cluster_kernel<true>, bwd_prepared[1], device, cluster,
                          warps, smem, stream, X, M, e, g, N, K, D, p, dX, dM);
  return launch_cluster(khm_bwd_cluster_kernel<false>, bwd_prepared[0], device, cluster,
                        warps, smem, stream, X, M, e, g, N, K, D, p, dX, dM);
}

}  // extern "C"
