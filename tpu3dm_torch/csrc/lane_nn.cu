// Top-1 3-D nearest neighbour per pair lane.
//
// Replaces the TPU kernel tpu3dm/ops/nn_lane.py:_lane_nn_smalld_kernel (the ICP
// correspondence search of registration/fused.py with nn_impl="lane").
//
// For pair lane b and query row i, over every target j of the same lane:
//   d2(i, j) = bias[b, j] + sum_d (q[b, i, d] - t[b, j, d])^2
// keeping the running minimum and its first index.  bias is 0 for a valid
// target and BIG (1e30) for a masked one, so d2 is the true squared distance.
//
// What bounds it on the H100: operations.  At B=2048, M=N=1024 a search is
// 2.1 G entries of 9 fp32 operations each, against ~50 MB of inputs and
// outputs.  The TPU kernel holds one lane in VMEM and sweeps 256-wide target
// sub-blocks; here blocks run in no order, so a block takes 256 query rows of
// one lane, each thread keeps its query point and its running (min, argmin) in
// registers, and the lane's targets stream through shared memory as
// (x, y, z, bias) rows.  Every thread of a warp reads the same target, which shared
// memory serves as one broadcast load per entry; the [M, N] distances never
// leave registers.
//
// Rounding: biased_sq_dist3 (sqdist3.cuh, shared with nn_tiled.cu) rounds
// each difference, square and sum on its own in the plain version's order, so
// the two agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // targets staged per pass: 32 KB of (x, y, z, bias)

__global__ void __launch_bounds__(kThreads)
lane_nn_smalld_kernel(const float* __restrict__ q, const float* __restrict__ t,
                      const float* __restrict__ bias, float* __restrict__ d2_out,
                      int* __restrict__ idx_out, int M, int N) {
  __shared__ float tile[4 * kTile];
  const int lane = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* lq = q + static_cast<size_t>(lane) * M * 3;
  const float* lt = t + static_cast<size_t>(lane) * N * 3;
  const float* lb = bias + static_cast<size_t>(lane) * N;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < M) {
    qx = lq[3 * i];
    qy = lq[3 * i + 1];
    qz = lq[3 * i + 2];
  }
  float best = CUDART_INF_F;
  int best_j = 0;
  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int g = base + j;
      tile[4 * j] = lt[3 * g];
      tile[4 * j + 1] = lt[3 * g + 1];
      tile[4 * j + 2] = lt[3 * g + 2];
      tile[4 * j + 3] = lb[g];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float acc = biased_sq_dist3(qx, qy, qz, tile[4 * j], tile[4 * j + 1],
                                        tile[4 * j + 2], tile[4 * j + 3]);
      if (acc < best) {  // strict: ties keep the smaller index
        best = acc;
        best_j = base + j;
      }
    }
  }
  if (i < M) {
    const size_t o = static_cast<size_t>(lane) * M + i;
    d2_out[o] = fmaxf(best, 0.f);
    idx_out[o] = best_j;
  }
}

}  // namespace

// q [B, M, 3], t [B, N, 3], bias [B, N] float32, contiguous; writes
// d2 [B, M] float32 and idx [B, M] int32.  Launches on ``stream`` and
// returns cudaGetLastError().
extern "C" int t3t_lane_nn_smalld(const float* q, const float* t, const float* bias,
                                  float* d2, int* idx, int B, int M, int N,
                                  cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  lane_nn_smalld_kernel<<<grid, kThreads, 0, stream>>>(q, t, bias, d2, idx, M, N);
  return static_cast<int>(cudaGetLastError());
}
