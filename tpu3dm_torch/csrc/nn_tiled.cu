// Tiled top-1 nearest neighbour of one query set among one target set.
//
// Replaces the two TPU kernels behind tpu3dm/ops/nn.py:nn_search_pallas, the
// search that nn_search takes above DENSE_MAX_ENTRIES (16M entries):
//
//   t3t_nn_tiled_smalld  <-  _nn_kernel_smalld (d < 8; built for d = 3, the
//     only width of the port's paths: the 3-D searches of the large-cloud
//     path, donor normals at 1,000,448 x 768 or x 8192 targets, and the
//     downsampled ICP and evaluation at 8192 x 8192):
//       d2(i, j) = bias[j] + sum_k (q[i, k] - t[j, k])^2
//     bias is 0 for a valid target and BIG for a masked one, so d2 is the
//     true squared distance.  biased_sq_dist3 (sqdist3.cuh, shared with
//     lane_nn.cu) rounds each step on its own in the plain version's order
//     (tpu3dm_torch/ops/nn.py:nn_search_dense), so the two agree bit for bit.
//
//   t3t_nn_tiled_wide  <-  _nn_kernel (d >= 8: the FPFH searches of
//     nn_mutual at 8192 x 8192 x 33):
//       p(i, j) = tsq[j] - 2 (q_i . t_j)
//     with tsq = |t_j|^2, or BIG for a masked target.  The dot is an fmaf
//     chain over k in order; the plain version's is a cuBLAS fp32 product, so
//     the two agree up to the dot's summation order.  The wrapper adds |q_i|^2
//     and clamps at 0 after the search, as nn_search_pallas does.
//
// Both keep, per query, the running minimum and its FIRST index: a strict `<`
// over ascending targets, which is the TPU kernel's rule (first argmin inside
// a tile, strict `<` across tiles in order) and torch.argmin's.
//
// Design.  The TPU kernels carry the running best across the sequential
// target axis of their grid in VMEM.  Hopper blocks run in no order, so a
// block owns a set of queries and loops over every target tile itself,
// staged in shared memory; the best (value, index) stays in registers and
// is written once.
//
// What bounds them on the H100: operations.  smalld does 9 fp32 operations
// per entry (1M x 768: 7.7e8 entries against ~25 MB moved).  Targets are
// staged as (x, y, z, bias) rows; each thread holds QPT queries in
// registers and reads each staged target as a shared-memory broadcast, so a
// target load serves QPT entries; for small query sets QPT = 1 and 64-thread
// blocks keep ~128 blocks on the card's 132 SMs.  wide does d + 2 per entry
// (d FMAs, the scale, the subtraction; 8192^2 x 33: 2.2e9 FMAs against 2 MB
// moved): 64 x 64 tiles of queries and targets, transposed in shared memory,
// each thread a 4 x 4 register tile, so every pair of float4 shared loads
// feeds 16 FMAs.  No tensor cores: the contract is fp32 (TF32 is off in the
// port), and the 16 threads that share a query row merge their running
// bests with warp shuffles.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist3.cuh"

namespace {

// ---------------------------------------------------------------- smalld --

constexpr int kSmallTile = 2048;  // targets staged per pass: 32 KB of (x, y, z, bias)

template <int QPT>
__global__ void nn_smalld_kernel(const float* __restrict__ q, const float* __restrict__ t,
                                 const float* __restrict__ bias, float* __restrict__ d2_out,
                                 int* __restrict__ idx_out, int M, int N) {
  __shared__ float tile[4 * kSmallTile];
  const int first = blockIdx.x * blockDim.x * QPT + threadIdx.x;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int best_j[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = first + r * blockDim.x;
    const size_t g = i < M ? static_cast<size_t>(i) : 0;
    qx[r] = i < M ? q[3 * g] : 0.f;
    qy[r] = i < M ? q[3 * g + 1] : 0.f;
    qz[r] = i < M ? q[3 * g + 2] : 0.f;
    best[r] = CUDART_INF_F;
    best_j[r] = 0;
  }

  for (int base = 0; base < N; base += kSmallTile) {
    const int n = min(kSmallTile, N - base);
    __syncthreads();
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const size_t g = static_cast<size_t>(base) + x;
      tile[4 * x] = t[3 * g];
      tile[4 * x + 1] = t[3 * g + 1];
      tile[4 * x + 2] = t[3 * g + 2];
      tile[4 * x + 3] = bias[g];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float tv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) tv[k] = tile[4 * j + k];
#pragma unroll
      for (int r = 0; r < QPT; ++r) {
        const float acc = biased_sq_dist3(qx[r], qy[r], qz[r], tv[0], tv[1], tv[2], tv[3]);
        if (acc < best[r]) {  // strict: ties keep the smaller index
          best[r] = acc;
          best_j[r] = base + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = first + r * blockDim.x;
    if (i < M) {
      d2_out[i] = fmaxf(best[r], 0.f);
      idx_out[i] = best_j[r];
    }
  }
}

// ------------------------------------------------------------------ wide --

constexpr int kWideTile = 64;     // queries and targets per tile
constexpr int kWideStride = 68;   // padded row of the transposed tiles (float4 aligned)
constexpr int kWideMaxD = 64;
constexpr int kWideThreads = 256; // 16 x 16 threads, a 4 x 4 tile each

__global__ void __launch_bounds__(kWideThreads)
nn_wide_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const float* __restrict__ tsq, float* __restrict__ part_out,
               int* __restrict__ idx_out, int M, int N, int D) {
  __shared__ __align__(16) float qs[kWideMaxD * kWideStride];
  __shared__ __align__(16) float ts[kWideMaxD * kWideStride];
  __shared__ float tsq_s[kWideTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // target columns tx*4 .. tx*4+3 of a tile
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kWideTile;

  // The block's queries, transposed: qs[k][r] = q[q0 + r, k].
  for (int x = tid; x < kWideTile * D; x += kWideThreads) {
    const int r = x / D, k = x % D;
    qs[k * kWideStride + r] = q0 + r < M ? q[static_cast<size_t>(q0 + r) * D + k] : 0.f;
  }

  float best[4];
  int best_j[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    best[a] = CUDART_INF_F;
    best_j[a] = 0;
  }

  for (int base = 0; base < N; base += kWideTile) {
    __syncthreads();
    for (int x = tid; x < kWideTile * D; x += kWideThreads) {
      const int r = x / D, k = x % D;
      ts[k * kWideStride + r] = base + r < N ? t[static_cast<size_t>(base + r) * D + k] : 0.f;
    }
    if (tid < kWideTile) tsq_s[tid] = base + tid < N ? tsq[base + tid] : CUDART_INF_F;
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[k * kWideStride + ty * 4]);
      const float4 tb = *reinterpret_cast<const float4*>(&ts[k * kWideStride + tx * 4]);
      const float qq[4] = {qa.x, qa.y, qa.z, qa.w};
      const float tt[4] = {tb.x, tb.y, tb.z, tb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = __fmaf_rn(qq[a], tt[b], acc[a][b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = base + tx * 4 + b;
      if (j < N) {
        const float sq = tsq_s[tx * 4 + b];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = __fsub_rn(sq, __fmul_rn(2.f, acc[a][b]));
          if (p < best[a]) {  // this thread's targets ascend: first index kept
            best[a] = p;
            best_j[a] = j;
          }
        }
      }
    }
  }

  // Merge the 16 threads of a half-warp that share these query rows: the
  // smaller value wins, the smaller index on a tie.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[a], off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j[a], off);
      if (ov < best[a] || (ov == best[a] && oj < best_j[a])) {
        best[a] = ov;
        best_j[a] = oj;
      }
    }
    const int i = q0 + ty * 4 + a;
    if (tx == 0 && i < M) {
      part_out[i] = best[a];
      idx_out[i] = best_j[a];
    }
  }
}

}  // namespace

// q [M, 3], t [N, 3], bias [N] float32, contiguous; writes d2 [M] float32
// (the true squared distance, clamped at 0) and idx [M] int32.  Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int t3t_nn_tiled_smalld(const float* q, const float* t, const float* bias,
                                   float* d2, int* idx, int M, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  // Enough queries per block to amortise each staged target over several
  // entries, but never fewer blocks than SMs when the query set allows it.
  constexpr int kSMs = 132;
  if (M >= kSMs * 256 * 4) {
    const int threads = 256;
    const int grid = (M + threads * 4 - 1) / (threads * 4);
    nn_smalld_kernel<4><<<grid, threads, 0, stream>>>(q, t, bias, d2, idx, M, N);
  } else {
    const int threads = 64;
    const int grid = (M + threads - 1) / threads;
    nn_smalld_kernel<1><<<grid, threads, 0, stream>>>(q, t, bias, d2, idx, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [M, d], t [N, d], tsq [N] float32, contiguous, 8 <= d <= 64; writes
// part [M] = min_j (tsq[j] - 2 q.t_j) float32 and idx [M] int32.  Launches
// on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_nn_tiled_wide(const float* q, const float* t, const float* tsq,
                                 float* part, int* idx, int M, int N, int d,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kWideMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (M + kWideTile - 1) / kWideTile;
  nn_wide_kernel<<<grid, kWideThreads, 0, stream>>>(q, t, tsq, part, idx, M, N, d);
  return static_cast<int>(cudaGetLastError());
}
