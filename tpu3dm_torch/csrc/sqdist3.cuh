// The 3-D squared distance of the NN kernels lane_nn.cu and nn_tiled.cu.
//
//   d2 = ((bias + dx * dx) + dy * dy) + dz * dz,   d = q - t
//
// bias is 0 for a valid target and BIG (1e30) for a masked one.  Each
// difference, square and sum is rounded on its own (no FMA contraction), in
// the order of the plain version (tpu3dm_torch/ops/nn.py:nn_search_dense), so
// kernels and plain version agree bit for bit.
//
// nn_tiled.cu stages its targets in shared memory as four scalars a row
// (x, y, z, bias) and passes them here one by one: on the H100 that ran
// faster than float4 rows, whose 128-bit broadcast loads also made the
// one-query-a-thread lane_nn.cu spill.  lane_nn.cu now stages only the
// valid targets and calls sq_dist3.

#pragma once

#include <cuda_runtime.h>

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
