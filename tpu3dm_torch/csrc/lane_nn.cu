// Top-1 nearest neighbour per pair lane: two kernels.
//
// t3t_lane_nn_smalld replaces the TPU kernel
// tpu3dm/ops/nn_lane.py:_lane_nn_smalld_kernel (d < 8; the 3-D ICP and
// rescue-verification searches of registration/fused.py with nn_impl="lane").
// The verification's C candidate poses of a lane are C * M query rows of that
// lane, so the kernel sees [B, C * M, 3] queries against [B, N, 3] targets:
// no copy of the targets and no group argument.
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
//
// t3t_lane_nn_wide replaces tpu3dm/ops/nn_lane.py:_lane_nn_mxu_kernel (d >= 8:
// the 33-D FPFH correspondences of fused_register_step with
// mutual_filter=False):
//   p(b, i, j) = tsq[b, j] - 2 (q[b, i] . t[b, j])
// with tsq = |t|^2, or BIG for a masked target; the wrapper adds |q|^2 and
// clamps at 0, as the TPU wrapper does (nn_lane.py:254-255).  The TPU kernel
// runs the cross term on the MXU over 256-wide target tiles; here each block
// is one 64-query tile of one lane running nn_wide_block (nn_wide.cuh, the
// body of nn_tiled.cu's d >= 8 kernel), the pair lane on the grid's y axis.
// What bounds it on the H100: operations.  At B = 2048, M = N = 1024, d = 33
// a search is 2.1 G entries of 34 fp32 instructions (33 FMAs, then one fmaf
// of the -2 scale with tsq), ~2.2 ms at the card's fp32 rate, against ~550 MB of inputs
// (0.17 ms at its memory rate).
// The design keeps the entries in registers (a 4 x 4 tile a thread, fed by
// float4 shared loads) and the lane's targets stream through shared memory
// in 64-row tiles; no tensor cores, since the contract is fp32 and the port
// keeps TF32 off.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn_wide.cuh"
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

__global__ void __launch_bounds__(kWideThreads)
lane_nn_wide_kernel(const float* __restrict__ q, const float* __restrict__ t,
                    const float* __restrict__ tsq, float* __restrict__ part_out,
                    int* __restrict__ idx_out, int M, int N, int D) {
  const size_t lane = blockIdx.y;
  nn_wide_block(q + lane * M * D, t + lane * N * D, tsq + lane * N, part_out + lane * M,
                idx_out + lane * M, M, N, D, blockIdx.x * kWideTile);
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

// q [B, M, d], t [B, N, d], tsq [B, N] float32, contiguous, 8 <= d <= 64;
// writes part [B, M] = min_j (tsq[b, j] - 2 q[b, i].t[b, j]) float32 and
// idx [B, M] int32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_lane_nn_wide(const float* q, const float* t, const float* tsq, float* part,
                                int* idx, int B, int M, int N, int d, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kWideMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kWideTile - 1) / kWideTile, B);
  lane_nn_wide_kernel<<<grid, kWideThreads, 0, stream>>>(q, t, tsq, part, idx, M, N, d);
  return static_cast<int>(cudaGetLastError());
}
