// The d >= 8 top-1 NN tile of the kernels nn_tiled.cu (t3t_nn_tiled_wide,
// one query set) and lane_nn.cu (t3t_lane_nn_wide, one set a pair lane).
//
//   p(i, j) = tsq[j] - 2 (q_i . t_j)
//
// with tsq = |t_j|^2, or BIG for a masked target.  The dot is one fmaf chain
// over k in order, then one fmaf(-2, dot, tsq): the doubling is exact, so it
// rounds once, as tsq - 2 * dot does.  The callers add |q_i|^2 and clamp at 0
// after the search.
// The running minimum keeps its FIRST index: each thread sees its targets in
// ascending order (strict `<`), and the merge across threads takes the
// smaller value, then the smaller index, which is the TPU kernels' rule
// (first argmin inside a tile, strict `<` across tiles) and torch.argmin's.
//
// A block owns 64 queries and loops over every target in 64-wide tiles:
// queries and targets staged transposed in shared memory, each of the 256
// threads a 4 x 4 register tile, so every pair of float4 shared loads feeds
// 16 FMAs.  fp32 on the CUDA cores (the port keeps TF32 off); the 16 threads
// that share a query row merge their running bests with warp shuffles.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int kWideTile = 64;     // queries and targets per tile
constexpr int kWideStride = 68;   // padded row of the transposed tiles (float4 aligned)
constexpr int kWideMaxD = 64;
constexpr int kWideThreads = 256; // 16 x 16 threads, a 4 x 4 tile each

// Queries q0 .. q0 + 63 of q [M, D] against every row of t [N, D]: writes
// part [i] = min_j (tsq[j] - 2 q_i . t_j) and idx [i] for those queries.
// Called by every thread of a kWideThreads block.
__device__ __forceinline__ void nn_wide_block(const float* __restrict__ q,
                                              const float* __restrict__ t,
                                              const float* __restrict__ tsq,
                                              float* __restrict__ part_out,
                                              int* __restrict__ idx_out, int M, int N, int D,
                                              int q0) {
  __shared__ __align__(16) float qs[kWideMaxD * kWideStride];
  __shared__ __align__(16) float ts[kWideMaxD * kWideStride];
  __shared__ float tsq_s[kWideTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // target columns tx*4 .. tx*4+3 of a tile
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3

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
          const float p = __fmaf_rn(-2.f, acc[a][b], sq);
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
