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
//     with tsq = |t_j|^2, or BIG for a masked target; the tile is
//     nn_wide_block (nn_wide.cuh, shared with lane_nn.cu).  The dot is an
//     fmaf chain over k in order; the plain version's is a cuBLAS fp32
//     product, so the two agree up to the dot's summation order.  The
//     wrapper adds |q_i|^2 and clamps at 0 after the search, as
//     nn_search_pallas does.
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
// blocks keep ~128 blocks on the card's 132 SMs.  wide does d + 1 per entry
// (d FMAs, then one fmaf of the -2 scale with tsq; 8192^2 x 33: 2.2e9 FMAs against 2 MB
// moved): 64 x 64 tiles of queries and targets, transposed in shared memory,
// each thread a 4 x 4 register tile, so every pair of float4 shared loads
// feeds 16 FMAs.  No tensor cores: the contract is fp32 (TF32 is off in the
// port), and the 16 threads that share a query row merge their running
// bests with warp shuffles.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn_wide.cuh"
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

__global__ void __launch_bounds__(kWideThreads)
nn_wide_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const float* __restrict__ tsq, float* __restrict__ part_out,
               int* __restrict__ idx_out, int M, int N, int D) {
  nn_wide_block(q, t, tsq, part_out, idx_out, M, N, D, blockIdx.x * kWideTile);
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
