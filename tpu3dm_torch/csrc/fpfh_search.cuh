// Top-1 NN at d = 33 of one query set's listed valid rows over a target set
// split across a thread-block cluster, on the FPFH tile (fpfh_tile.cuh): the
// d = 33 route of kernel 5 (nn_tiled.cu, t3t_nn_tiled_wide: one set) and of
// kernel 7 (lane_nn.cu, t3t_lane_nn_wide: one set a pair lane, the lane on
// the grid's y axis).
//
//   part(i) = min_j fmaf(-2, q_i . t_j, tsq[j]),  idx(i) = its first j
//
// tsq = |t_j|^2, BIG at a masked target; each dot is one fmaf chain over k =
// 0 .. 32 in order from 0, so a valid entry has the bits of nn_wide.cuh's.
// A masked query row is not computed: it gets part BIG and idx 0.
//
// What bounds it on the H100: operations, 34 fp32 instructions a valid entry
// (33 FMAs, the -2 scale's FMA with tsq) against a few MB of rows.  The
// design answers the earlier kernel's four losses (64 x 64 tiles, 4 x 4
// entries a thread, every row computed, one block a 64-query tile: 128
// blocks of 8 warps at 8192 queries):
//   - the FPFH tile: 128 listed queries against 128 listed targets, 8 x 8
//     entries a thread (4 shared loads feed 64 FMAs), the k loop unrolled
//     over 33, the next target tile copied by cp.async during this one;
//   - only valid rows: a block lists the set's valid queries in index order
//     (list_rows) and takes the 128 at its tile's positions; a block whose
//     tile lies past them returns at once.  Targets are listed the same way;
//   - the card filled: a cluster of nsplit blocks shares a query tile, block
//     s sweeping the s-th of nsplit equal shares of the listed targets (in
//     list positions, so a valid prefix splits evenly), and the blocks merge
//     their (part, idx) through distributed shared memory in share order
//     with a strict `<`: the first index of the row's minimum, one launch,
//     no scratch and no atomics.  The host picks nsplit from the number of
//     query tiles (search_split), so that tiles x lanes x nsplit blocks put
//     at least one on every SM;
//   - no row limit: a share longer than the block's list (kSearchListCap)
//     is listed and swept in parts, in order.  A set with no valid target
//     lists every target at its BIG norm, so the biased entries decide there,
//     as in the plain version.
// Every block of a cluster has the same query tile and so takes the same
// early exit; the rest reach both cluster.sync(), the last of which keeps
// each block's shared memory alive while the others read it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "async_copy.cuh"
#include "compact.cuh"
#include "fpfh_tile.cuh"

namespace {

constexpr int kSearchMaxSplit = 8;     // blocks of a cluster: the portable maximum
constexpr int kSearchListCap = 8192;   // listed targets a block holds at once: 32 KB
constexpr int kSearchSMs = 132;
constexpr int kSearchBlocksPerSM = 2;  // 128 registers a thread: two blocks of 256
constexpr int kPartTag = 1 << 30;      // best_j holds a list position of this part, not a row

// Dynamic shared memory: the query tile, two target tiles and their norms,
// the tile's listed queries, the block's (part, idx) of each, the list.
__host__ __device__ constexpr size_t search_smem_bytes(int list_cap) {
  return 4 * (3 * static_cast<size_t>(fpfh::kTileFloats) + 5 * fpfh::kTile +
              static_cast<size_t>(list_cap));
}

__global__ void __launch_bounds__(fpfh::kThreads, kSearchBlocksPerSM)
fpfh_search_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const float* __restrict__ tsq, const unsigned char* __restrict__ qmask,
                   const unsigned char* __restrict__ tmask, float* __restrict__ part_out,
                   int* __restrict__ idx_out, int M, int N, int list_cap) {
  using fpfh::kD;
  using fpfh::kThreads;
  using fpfh::kTile;
  using fpfh::kTileFloats;
  namespace cg = cooperative_groups;
  extern __shared__ float4 dyn[];
  float* qs = reinterpret_cast<float*>(dyn);               // the query tile
  float* ts = qs + kTileFloats;                            // two target tiles
  float* tsq_s = ts + 2 * kTileFloats;                     // their norms
  int* qi = reinterpret_cast<int*>(tsq_s + 2 * kTile);     // the tile's listed queries
  float* part_d = reinterpret_cast<float*>(qi + kTile);    // this block's best of each,
  int* part_j = reinterpret_cast<int*>(part_d + kTile);    // read by the cluster
  int* tj = part_j + kTile;                                // [list_cap] listed targets
  __shared__ int warp_counts[fpfh::kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());

  const size_t lane = blockIdx.y;
  const float* lq = q + lane * M * kD;
  const float* lt = t + lane * N * kD;
  const float* ltsq = tsq + lane * N;
  const unsigned char* lqm = qmask == nullptr ? nullptr : qmask + lane * M;
  const unsigned char* ltm = tmask == nullptr ? nullptr : tmask + lane * N;
  float* lpart = part_out + lane * M;
  int* lidx = idx_out + lane * M;
  const int tid = threadIdx.x;
  const int q0 = static_cast<int>(blockIdx.x / nsplit) * kTile;  // rows and list positions

  if (lqm != nullptr && split == 0 && tid < kTile && q0 + tid < M && !lqm[q0 + tid]) {
    lpart[q0 + tid] = fpfh::kBig;
    lidx[q0 + tid] = 0;
  }
  const int nva = list_rows(lqm, M, q0, q0 + kTile, qi, warp_counts);
  if (q0 >= nva) return;  // the same in every block of the cluster
  const int n_rows = min(kTile, nva - q0);
  __syncthreads();  // qi
  fpfh::stage_tile(qs, nullptr, lq, nullptr, qi, 0, n_rows);
  cp_async_commit();

  // This block's share: positions [lo, hi) of the set's listed targets.
  const unsigned char* list_mask = ltm;
  int nvt = count_rows(ltm, N, warp_counts);
  if (nvt == 0) {  // no valid target: every target, at its BIG norm
    list_mask = nullptr;
    nvt = N;
  }
  const int lo = static_cast<int>(static_cast<long long>(nvt) * split / nsplit);
  const int hi = static_cast<int>(static_cast<long long>(nvt) * (split + 1) / nsplit);

  const int ty = tid >> 4, tx = tid & 15;
  float best[8];
  int best_j[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    best[e] = CUDART_INF_F;
    best_j[e] = 0;
  }
  for (int p = lo; p < hi; p += list_cap) {
    // list_rows' first barrier comes before its first write: every thread
    // has read the last part's tj by then.
    const int pe = min(p + list_cap, hi);
    list_rows(list_mask, N, p, pe, tj, warp_counts);
    __syncthreads();  // tj
    fpfh::sweep_targets(qs, ts, tsq_s, lt, ltsq, tj, pe - p,
                        [&](float (&acc)[8][8], const float* tsq_t, int first) {
      float tn[8];
      fpfh::load8(tsq_t, tx, tn);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(-2.0f, acc[r][c], tn[c]);
        fpfh::row_update(acc[r], tx, kPartTag + first, best[r], best_j[r]);
      }
    });
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (best_j[r] >= kPartTag) best_j[r] = tj[best_j[r] - kPartTag];
    }
  }
  cp_async_wait<0>();  // the query tile, where no target tile was swept

  // Merge the cluster's shares: each block finishes the listed rows s with
  // s % nsplit == split, reading every block's best in share order (ascending
  // targets, strict `<`: the first index of the row's minimum).
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    fpfh::row_merge(best[r], best_j[r]);
    const int s = fpfh::tile_pos(ty, r);
    if (tx == 0 && s < n_rows) {
      part_d[s] = best[r];
      part_j[s] = best_j[r];
    }
  }
  cluster.sync();
  if (tid < n_rows && tid % nsplit == split) {
    float b = CUDART_INF_F;
    int j = 0;
    for (int k = 0; k < nsplit; ++k) {
      const float d = cluster.map_shared_rank(part_d, k)[tid];
      if (d < b) {
        b = d;
        j = cluster.map_shared_rank(part_j, k)[tid];
      }
    }
    lpart[qi[tid]] = b;
    lidx[qi[tid]] = j;
  }
  cluster.sync();  // no block leaves while another may read its part_d / part_j
}

// Blocks of a cluster for `blocks` clusters (query tiles x lanes): the
// least power of two, up to 8, that puts a block on every SM, and no share
// under 512 targets.  A variant timer on the H100 at path B's shape (8192^2,
// 53 of 64 query tiles valid; PERF.md) ran 2 and 4 blocks a cluster alike,
// ahead of 8 (what a rule of two blocks an SM gives) and well ahead of 1.
inline int search_split(long long blocks, int N) {
  int nsplit = 1;
  while (nsplit < kSearchMaxSplit && blocks * nsplit < kSearchSMs && 2 * nsplit * 512 <= N) {
    nsplit *= 2;
  }
  return nsplit;
}

// q [B, M, 33], t [B, N, 33], tsq [B, N] float32, contiguous; qmask [B, M]
// and tmask [B, N] one byte a row (null: every row valid).  Writes part and
// idx [B, M].  Launches on ``stream``.
inline cudaError_t launch_fpfh_search(const float* q, const float* t, const float* tsq,
                                      const unsigned char* qmask, const unsigned char* tmask,
                                      float* part, int* idx, int B, int M, int N,
                                      cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(M) + fpfh::kTile - 1) / fpfh::kTile;
  const int nsplit = search_split(tiles * B, N);
  const int list_cap = std::min(kSearchListCap, (N + nsplit - 1) / nsplit);
  const size_t smem = search_smem_bytes(list_cap);
  cudaError_t err = cudaFuncSetAttribute(
      fpfh_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * nsplit), static_cast<unsigned>(B), 1);
  cfg.blockDim = dim3(fpfh::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fpfh_search_kernel, q, t, tsq, qmask, tmask, part, idx, M, N,
                           list_cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
