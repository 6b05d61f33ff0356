// The 3-D squared distance of the NN kernels lane_nn.cu and nn_tiled.cu.
//
//   d2 = ((bias + dx * dx) + dy * dy) + dz * dz,   d = q - t
//
// bias is 0 for a valid target and BIG (1e30) for a masked one.  Each
// difference, square and sum is rounded on its own (no FMA contraction), in
// the order of the plain version (tpu3dm_torch/ops/nn.py:nn_search_dense), so
// kernels and plain version agree bit for bit.
//
// Both kernels stage only the valid targets, compacted in index order, and
// call sq_dist3 on them; a query whose best valid d2 is not below BIG runs
// biased_search over every target instead (see lane_nn.cu), so each equals
// the plain version bit for bit in every case.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr float kBig = 1e30f;  // the plain version's bias of a masked target (ops/nn.py:BIG)

__device__ __forceinline__ float biased_sq_dist3(float qx, float qy, float qz, float tx, float ty,
                                                 float tz, float bias) {
  float acc = bias;
  float d = __fsub_rn(qx, tx);
  acc = __fadd_rn(acc, __fmul_rn(d, d));
  d = __fsub_rn(qy, ty);
  acc = __fadd_rn(acc, __fmul_rn(d, d));
  d = __fsub_rn(qz, tz);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// (dx * dx + dy * dy) + dz * dz, each step rounded on its own: the bits of
// biased_sq_dist3 with bias 0, since 0 + x == x for every x >= +0 (a square
// is >= +0 or NaN, and 0 + NaN is NaN).
__device__ __forceinline__ float sq_dist3(float qx, float qy, float qz, float tx, float ty,
                                          float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

struct Best {
  float d2;
  int j;
};

// The biased d2 over every target t [N, 3] (mask null: every target
// valid), the plain version's, from global memory, first index on ties.
__device__ __noinline__ Best biased_search(float qx, float qy, float qz,
                                           const float* __restrict__ t,
                                           const unsigned char* __restrict__ mask, int N) {
  Best b{CUDART_INF_F, 0};
  for (int j = 0; j < N; ++j) {
    const float bias = (mask == nullptr || mask[j]) ? 0.f : kBig;
    const float acc = biased_sq_dist3(qx, qy, qz, t[3 * j], t[3 * j + 1], t[3 * j + 2], bias);
    if (acc < b.d2) {  // strict: ties keep the smaller index
      b.d2 = acc;
      b.j = j;
    }
  }
  return b;
}
