// The 3-D squared distance of the NN kernels lane_nn.cu and nn_tiled.cu.
//
//   d2 = ((bias + dx * dx) + dy * dy) + dz * dz,   d = q - t
//
// bias is 0 for a valid target and BIG (1e30) for a masked one.  Each
// difference, square and sum is rounded on its own (no FMA contraction), in
// the order of the plain version (tpu3dm_torch/ops/nn.py:nn_search_dense), so
// kernels and plain version agree bit for bit.
//
// Both kernels stage their targets in shared memory as four scalars a row
// (x, y, z, bias) and pass them here one by one: on the H100 that ran faster
// than float4 rows, whose 128-bit broadcast loads also made lane_nn.cu spill.

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
