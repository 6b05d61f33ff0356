// Mutual nearest neighbour over 33-D FPFH features per pair lane.
//
// Replaces the TPU kernel tpu3dm/ops/nn_lane.py:_lane_mutual_kernel (the
// correspondence stage of registration/fused.py with nn_impl="lane").
//
// For pair lane b, query row i (features a_i) and target column j (b_j):
//   d2(i, j) = (asq[i] + bsq[j]) - 2 a_i . b_j
// where asq / bsq are the squared norms, BIG (1e30) at masked rows and
// columns.  Per query row the outputs are d2_fwd = min_j d2(i, j), idx = its
// first argmin, and colb = colmin[idx] with colmin[j] = min_i d2(i, j) over
// EVERY query row of the lane; the caller's mutuality test is
// d2_fwd <= colb.  Always fp32, as the TPU kernel is.
//
// The TPU kernel gets global column minima by keeping a whole lane resident
// in VMEM.  Hopper blocks are far smaller and run in no order, so this runs
// two passes:
//   1. column_min_kernel: one thread per target column holds b_j in
//      registers while the lane's query rows stream through shared memory;
//      writes colmin [B, Nb] to scratch that the wrapper allocates;
//   2. row_argmin_kernel: one thread per query row holds a_i in registers
//      while the target columns (with their colmin) stream through shared
//      memory; keeps the running (min, first argmin, colmin at argmin).
// Both passes compute an entry through dot33() and pair_d2(): the same fmaf
// chain over k = 0..32 and the same final rounding.  fma(x, y, acc) equals
// fma(y, x, acc) exactly, so entry (i, j) is bit-identical in both passes
// and a true mutual pair always passes d2_fwd <= colmin[idx].
//
// What bounds it on the H100: operations.  At B=2048, Na=Nb=1024 each pass
// is 2.1 G entries x 33 FMAs against ~0.55 GB of features.  Streamed rows are
// staged with a stride of 36 floats so a thread reads each as eight float4
// broadcasts plus one scalar: one shared load per four FMAs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kD = 33;       // FPFH width
constexpr int kStride = 36;  // shared row stride: 16-byte aligned rows
constexpr int kRows = 128;   // rows (pass 1) or columns (pass 2) per stage

__device__ __forceinline__ float dot33(const float (&x)[kD], const float* __restrict__ row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float4 y = r4[v];
    acc = __fmaf_rn(x[4 * v], y.x, acc);
    acc = __fmaf_rn(x[4 * v + 1], y.y, acc);
    acc = __fmaf_rn(x[4 * v + 2], y.z, acc);
    acc = __fmaf_rn(x[4 * v + 3], y.w, acc);
  }
  return __fmaf_rn(x[32], row[32], acc);
}

__device__ __forceinline__ float pair_d2(float dot, float xsq, float ysq) {
  return __fmaf_rn(-2.0f, dot, __fadd_rn(xsq, ysq));
}

// Stage n rows of src ([*, kD], starting at row `first`) into sh with stride kStride.
__device__ __forceinline__ void stage_rows(float* __restrict__ sh,
                                           const float* __restrict__ src,
                                           size_t first, int n) {
  for (int e = threadIdx.x; e < n * kStride; e += kThreads) {
    const int r = e / kStride;
    const int k = e - r * kStride;
    sh[e] = k < kD ? src[(first + r) * kD + k] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
column_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ asq, const float* __restrict__ bsq,
                  float* __restrict__ colmin, int Na, int Nb) {
  __shared__ __align__(16) float rows[kRows * kStride];
  __shared__ float rsq[kRows];
  const int lane = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  float x[kD];
  float xsq = 0.f;
  const size_t jb = static_cast<size_t>(lane) * Nb + (j < Nb ? j : 0);
#pragma unroll
  for (int k = 0; k < kD; ++k) x[k] = j < Nb ? b[jb * kD + k] : 0.f;
  if (j < Nb) xsq = bsq[jb];

  float cmin = CUDART_INF_F;
  for (int base = 0; base < Na; base += kRows) {
    const int n = min(kRows, Na - base);
    const size_t first = static_cast<size_t>(lane) * Na + base;
    __syncthreads();
    stage_rows(rows, a, first, n);
    for (int r = threadIdx.x; r < n; r += kThreads) rsq[r] = asq[first + r];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      cmin = fminf(cmin, pair_d2(dot33(x, rows + r * kStride), xsq, rsq[r]));
    }
  }
  if (j < Nb) colmin[jb] = cmin;
}

__global__ void __launch_bounds__(kThreads)
row_argmin_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ asq, const float* __restrict__ bsq,
                  const float* __restrict__ colmin, float* __restrict__ d2_out,
                  int* __restrict__ idx_out, float* __restrict__ colb_out,
                  int Na, int Nb) {
  __shared__ __align__(16) float cols[kRows * kStride];
  __shared__ float csq[kRows];
  __shared__ float cmin[kRows];
  const int lane = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float x[kD];
  float xsq = 0.f;
  const size_t ia = static_cast<size_t>(lane) * Na + (i < Na ? i : 0);
#pragma unroll
  for (int k = 0; k < kD; ++k) x[k] = i < Na ? a[ia * kD + k] : 0.f;
  if (i < Na) xsq = asq[ia];

  float best = CUDART_INF_F;
  int best_j = 0;
  float best_col = CUDART_INF_F;
  for (int base = 0; base < Nb; base += kRows) {
    const int n = min(kRows, Nb - base);
    const size_t first = static_cast<size_t>(lane) * Nb + base;
    __syncthreads();
    stage_rows(cols, b, first, n);
    for (int c = threadIdx.x; c < n; c += kThreads) {
      csq[c] = bsq[first + c];
      cmin[c] = colmin[first + c];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float d = pair_d2(dot33(x, cols + c * kStride), xsq, csq[c]);
      if (d < best) {  // strict: ties keep the smaller index
        best = d;
        best_j = base + c;
        best_col = cmin[c];
      }
    }
  }
  if (i < Na) {
    d2_out[ia] = best;
    idx_out[ia] = best_j;
    colb_out[ia] = best_col;
  }
}

}  // namespace

// a [B, Na, 33], b [B, Nb, 33], asq [B, Na], bsq [B, Nb] float32, contiguous;
// colmin [B, Nb] is scratch.  Writes d2 [B, Na], idx [B, Na] int32 and
// colb [B, Na].  Launches both passes on ``stream`` and returns
// cudaGetLastError().
extern "C" int t3t_lane_mutual(const float* a, const float* b, const float* asq,
                               const float* bsq, float* colmin, float* d2, int* idx,
                               float* colb, int B, int Na, int Nb,
                               cudaStream_t stream) {
  if (B <= 0 || Na <= 0 || Nb <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid_cols((Nb + kThreads - 1) / kThreads, B);
  column_min_kernel<<<grid_cols, kThreads, 0, stream>>>(a, b, asq, bsq, colmin, Na, Nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_rows((Na + kThreads - 1) / kThreads, B);
  row_argmin_kernel<<<grid_rows, kThreads, 0, stream>>>(a, b, asq, bsq, colmin, d2, idx,
                                                        colb, Na, Nb);
  return static_cast<int>(cudaGetLastError());
}
