// Stable block-wide compaction of a lane's valid rows: compact_slot places
// one round of blockDim.x rows (lane_nn.cu, nn_tiled.cu, the bf16 score);
// count_rows and list_rows count and list a whole mask (fpfh_tile.cuh, the
// fp32 score).

#pragma once

#include <cuda_runtime.h>

// Every thread of the block calls it with whether its row of the round is
// kept.  Returns the row's slot among the round's kept rows, in thread order
// (meaningful where keep is true), and sets *kept to the round's count.  A
// warp ballot and popc give each row its rank inside its warp; a prefix over
// the warps' counts, through warp_counts (shared memory, blockDim.x / 32
// ints), places the warps.  blockDim.x is a multiple of 32.  Two
// __syncthreads(): call it from control flow that is uniform over the block.
__device__ __forceinline__ int compact_slot(bool keep, int* warp_counts, int* kept) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  *kept = total;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// The number of rows of [0, n) whose mask byte is set (n for a null mask),
// the same in every thread.  Every thread of the block calls it; two
// __syncthreads().
__device__ __forceinline__ int count_rows(const unsigned char* __restrict__ mask, int n,
                                          int* warp_counts) {
  if (mask == nullptr) return n;
  int c = 0;
  for (int i = static_cast<int>(threadIdx.x); i < n; i += static_cast<int>(blockDim.x)) {
    c += mask[i] ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_counts[w];
  __syncthreads();
  return total;
}

// The rows of [0, n) whose mask byte is set (every row for a null mask), in
// index order: the index of kept row number s goes to order[s - lo] for lo
// <= s < hi.  A round takes 4 * blockDim.x rows, four consecutive rows a
// thread, all read before the round's prefix (a warp shuffle scan, then the
// warps' counts through warp_counts); the scan stops after the round in
// which the count reaches hi.  Returns the kept rows seen: at least hi when
// it stopped early, else every kept row.  Every thread of the block calls it
// with the same arguments; two __syncthreads() a round, the first before
// any write, so a caller may still be reading an earlier list.
__device__ __forceinline__ int list_rows(const unsigned char* __restrict__ mask, int n, int lo,
                                         int hi, int* __restrict__ order, int* warp_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = 4 * static_cast<int>(blockDim.x);
  int nv = 0;
  for (int r0 = 0; r0 < n && nv < hi; r0 += step) {
    const int i0 = r0 + 4 * static_cast<int>(threadIdx.x);
    bool keep[4];
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      keep[k] = i0 + k < n && (mask == nullptr || mask[i0 + k]);
      c += keep[k] ? 1 : 0;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_counts[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      const int cw = warp_counts[w];
      before += w < warp ? cw : 0;
      total += cw;
    }
    __syncthreads();
    int s = nv + before + incl - c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (keep[k]) {
        if (s >= lo && s < hi) order[s - lo] = i0 + k;
        ++s;
      }
    }
    nv += total;
  }
  return nv;
}
