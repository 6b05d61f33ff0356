// Top-1 nearest neighbour per pair lane: two kernels.
//
// t3t_lane_nn_smalld replaces the TPU kernel
// tpu3dm/ops/nn_lane.py:_lane_nn_smalld_kernel (d < 8; the 3-D ICP and
// rescue-verification searches of registration/fused.py with nn_impl="lane").
// The verification's C candidate poses of a lane are C * M query rows of that
// lane, so the kernel sees [B, C * M, 3] queries against [B, N, 3] targets:
// no copy of the targets and no group argument.
//
// For pair lane b and query row i, the plain version
// (tpu3dm_torch/ops/nn.py:nn_search_dense) takes over every target j
//   d2(i, j) = bias[b, j] + sum_d (q[b, i, d] - t[b, j, d])^2
// the minimum and its first index; bias is 0 for a valid target and BIG
// (1e30) for a masked one.  0 + x == x for every x >= +0, so a valid
// target's d2 has the bits of sq_dist3 (sqdist3.cuh, no bias), and a masked
// target's d2 is >= BIG or NaN.  While the best valid d2 is below BIG no
// masked target can win or tie, so the kernel searches the valid targets
// only, in ascending index order with a strict `<`: the same minimum and the
// same first index.  A query whose best valid d2 is not below BIG (a lane
// with no valid target; coordinates near 1e15) runs the biased loop over
// every target instead, so the kernel equals the plain version bit for bit
// in every case.
//
// What bounds it on the H100: the fp32 instruction rate.  A valid entry needs 3
// subtractions, 3 squares, 2 adds and the compare, against ~50 MB of
// inputs and outputs at B = 2048, M = N = 1024.  The earlier design (one query a
// thread, every target row staged as four scalars x, y, z, bias) reached
// ~30% of that bound: each entry also paid four shared-memory broadcast
// loads, which run at a quarter of the fp32 rate (the time of 16 fp32
// instructions), and masked rows, ~a quarter of a lane's capacity,
// cost as much as valid ones.  Here a block takes 1024 query rows of one
// lane and each thread keeps R of them (strided by the block size, so the
// query loads stay coalesced) with their running (min, argmin) in
// registers.  While staging a target tile the block compacts the lane's
// valid targets in ascending order (warp ballot + popc prefix, compact.cuh)
// into four shared arrays: x, y, z and the original index.  Each target's
// three broadcast loads then serve R entries (the index matters only when
// a target wins), and an entry costs its 8 arithmetic instructions, the
// compare and two selects.  R = 8 (128 threads, 76 registers, no spills)
// with scalar arrays ran fastest at both shapes on the H100, ahead of R = 4
// and of float4 rows (x, y, z, index as int bits) at either R (PERF.md).
//
// t3t_lane_nn_wide replaces tpu3dm/ops/nn_lane.py:_lane_nn_mxu_kernel (d >= 8:
// the 33-D FPFH correspondences of fused_register_step with
// mutual_filter=False):
//   p(b, i, j) = fmaf(-2, q[b, i] . t[b, j], tsq[b, j])
// with tsq = |t|^2, or BIG for a masked target, and the dot one fmaf chain
// over k in order; the wrapper adds |q|^2 and clamps at 0, as the TPU
// wrapper does (nn_lane.py:254-255).  A masked query row gets idx 0 and p =
// BIG (its result is unspecified, as in JAX).
// What bounds it on the H100: operations.  At B = 2048, M = N = 1024, d = 33
// and ~70% valid rows a side, ~1.06e9 valid entries of 34 fp32 instructions
// (33 FMAs, then the -2 scale's FMA with tsq) against ~0.3 GB of valid rows.
// At d = 33 it runs fpfh_search.cuh, the route of kernel 5 at that width,
// one lane a row of clusters: a block takes 128 of the lane's listed valid
// queries and sweeps its share of the lane's listed valid targets on the
// FPFH tile (fpfh_tile.cuh: 8 x 8 entries a thread, 4 shared loads for 64
// FMAs, the next target tile copied with cp.async while this one is
// computed).  At the fused step's 2048 lanes the card is full with one
// block a query tile, so a cluster is one block and its share the lane's
// whole list; few lanes split the targets over a cluster, and a lane side
// longer than a block's list is swept in parts, so there is no row limit.
// A lane with no valid target lists every target (tsq BIG), so the biased
// entries decide there, as in the plain version.  Other widths (8 <= d <=
// 64) run nn_wide_block (nn_wide.cuh, the body of nn_tiled.cu's d != 33
// kernel) over every row: 64-query tiles, a 4 x 4 register tile a thread,
// the pair lane on the grid's y axis.  No tensor cores: the contract is
// fp32 and the port keeps TF32 off.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "compact.cuh"
#include "fpfh_search.cuh"
#include "nn_wide.cuh"
#include "sqdist3.cuh"

namespace {

constexpr int kQueriesPerBlock = 1024;
constexpr int kQueriesPerThread = 8;  // R
constexpr int kTile = 2048;           // targets staged per pass: 32 KB of (x, y, z, index)

constexpr int kThreads = kQueriesPerBlock / kQueriesPerThread;

__global__ void __launch_bounds__(kThreads)
lane_nn_smalld_kernel(const float* __restrict__ q, const float* __restrict__ t,
                      const unsigned char* __restrict__ mask, float* __restrict__ d2_out,
                      int* __restrict__ idx_out, int M, int N) {
  constexpr int R = kQueriesPerThread;
  __shared__ float sx[kTile], sy[kTile], sz[kTile];  // compacted valid targets
  __shared__ int sj[kTile];                          // and their original indices
  __shared__ int warp_counts[kThreads / 32];
  const int lane = blockIdx.y;
  const float* lq = q + static_cast<size_t>(lane) * M * 3;
  const float* lt = t + static_cast<size_t>(lane) * N * 3;
  const unsigned char* lm = mask == nullptr ? nullptr : mask + static_cast<size_t>(lane) * N;
  const int first = blockIdx.x * kQueriesPerBlock + threadIdx.x;

  float qx[R], qy[R], qz[R], best[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(first + r * kThreads, M - 1);  // rows past M compute, unwritten
    qx[r] = lq[3 * i];
    qy[r] = lq[3 * i + 1];
    qz[r] = lq[3 * i + 2];
    best[r] = CUDART_INF_F;
    best_j[r] = 0;
  }
  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    int nv = 0;  // valid targets of this tile, compacted in index order
    for (int r0 = 0; r0 < n; r0 += kThreads) {
      const int j = r0 + threadIdx.x;
      const bool keep = j < n && (lm == nullptr || lm[base + j]);
      int kept;
      const int slot = nv + compact_slot(keep, warp_counts, &kept);  // syncs: the last tile is read
      if (keep) {
        const int g = base + j;
        sx[slot] = lt[3 * g];
        sy[slot] = lt[3 * g + 1];
        sz[slot] = lt[3 * g + 2];
        sj[slot] = g;
      }
      nv += kept;
    }
    __syncthreads();
    for (int s = 0; s < nv; ++s) {
      const float tx = sx[s], ty = sy[s], tz = sz[s];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float acc = sq_dist3(qx[r], qy[r], qz[r], tx, ty, tz);
        if (acc < best[r]) {  // strict: ties keep the smaller index
          best[r] = acc;
          best_j[r] = sj[s];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * kThreads;
    if (i < M) {
      if (!(best[r] < kBig)) {
        const Best b = biased_search(qx[r], qy[r], qz[r], lt, lm, N);
        best[r] = b.d2;
        best_j[r] = b.j;
      }
      const size_t o = static_cast<size_t>(lane) * M + i;
      d2_out[o] = fmaxf(best[r], 0.f);
      idx_out[o] = best_j[r];
    }
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

// q [B, M, 3], t [B, N, 3] float32 and mask [B, N] bool (one byte each; null:
// every target valid), contiguous; writes d2 [B, M] float32 and idx [B, M]
// int32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_lane_nn_smalld(const float* q, const float* t, const unsigned char* mask,
                                  float* d2, int* idx, int B, int M, int N,
                                  cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kQueriesPerBlock - 1) / kQueriesPerBlock, B);
  lane_nn_smalld_kernel<<<grid, kThreads, 0, stream>>>(q, t, mask, d2, idx, M, N);
  return static_cast<int>(cudaGetLastError());
}

// q [B, M, d], t [B, N, d], tsq [B, N] float32, contiguous, 8 <= d <= 64,
// tsq BIG at masked targets; qmask [B, M] and tmask [B, N] bool (one byte
// each; null: every row valid), read at d = 33 only.  Writes part [B, M] =
// min_j fmaf(-2, q[b, i].t[b, j], tsq[b, j]) float32 and idx [B, M] int32
// (at d = 33: idx 0 and part BIG at a masked query).  Launches on
// ``stream`` and returns cudaGetLastError(), or cudaErrorInvalidValue where
// d is out of range or N >= 2^30.
extern "C" int t3t_lane_nn_wide(const float* q, const float* t, const float* tsq,
                                const unsigned char* qmask, const unsigned char* tmask,
                                float* part, int* idx, int B, int M, int N, int d,
                                cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kWideMaxD || N >= kPartTag) return static_cast<int>(cudaErrorInvalidValue);
  if (d == fpfh::kD) {
    return static_cast<int>(launch_fpfh_search(q, t, tsq, qmask, tmask, part, idx, B, M, N,
                                               stream));
  }
  const dim3 grid((M + kWideTile - 1) / kWideTile, B);
  lane_nn_wide_kernel<<<grid, kWideThreads, 0, stream>>>(q, t, tsq, part, idx, M, N, d);
  return static_cast<int>(cudaGetLastError());
}
