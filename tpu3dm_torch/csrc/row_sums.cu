// Ordered row sums: out[r] = the sum of x[r, 0..M) in an order fixed by M
// alone.
//
// This kernel replaces no TPU kernel.  It is the port's repair of a fault
// the TPU never had: PyTorch's reduction kernels split a row's sum between
// threads and blocks by the number of outputs, so a pair's ICP normal
// equations, its RANSAC refit and its frame centroid took another order, and
// other last bits, as the number of pairs sharing its call changed.  Here
// the order depends on M only:
//   lane l of the row's warp adds x[l], x[l + 32], x[l + 64], ... in turn to
//   0.0f, then the warp folds the 32 partial sums by a fixed xor-shuffle
//   tree (offsets 16, 8, 4, 2, 1), and lane 0 writes the row's sum.
// The plain version (tpu3dm_torch/ops/rowsum.py:row_sums_plain) adds in the
// same order, so the card and the CPU give the same bits on the same rows.
// No product is formed, so nvcc has nothing to contract into an FMA, and it
// never reassociates float adds.
//
// What bounds it on the H100: bytes.  Each row is read once, 32 consecutive
// floats a warp step (coalesced 128-byte loads), one float written a row;
// the adds are one per element.  One warp a row fills the card when the
// rows number in the thousands (the fused step's B x 27 normal-equation
// rows); a single pair's 27 rows are a latency-bound launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__global__ void __launch_bounds__(kThreads)
row_sums_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows, int m) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* src = x + row * static_cast<long long>(m);
  float s = 0.0f;
  for (int i = lane; i < m; i += 32) s = __fadd_rn(s, src[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  if (lane == 0) out[row] = s;
}

}  // namespace

// x [rows, m] float32, contiguous; writes out [rows] float32.  Launches on
// ``stream`` and returns cudaGetLastError(); rows <= 0 launches nothing (m
// <= 0 writes zeros).
extern "C" int t3t_row_sums(const float* x, float* out, long long rows, int m,
                            cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, out, rows, m);
  return static_cast<int>(cudaGetLastError());
}
