// Stable block-wide compaction of a lane's valid rows into shared memory,
// one round of blockDim.x rows at a time (lane_nn.cu and ransac_score.cu).

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
