// Point-to-plane normal equations: out[l, 0..27) = the 21 entries of J^T W J
// (lower triangle, row-major) and the 6 of J^T W r of lane l, summed over
// its M correspondence rows in the order of csrc/row_sums.cu.
//
// This kernel replaces no TPU kernel.  On the TPU, XLA fuses the Jacobian,
// the residual and the 27 weighted products into the reduction, so they
// never reach memory.  Eager PyTorch wrote each as a tensor as large as the
// row set (about 71 elementwise ops, a [..., 27, M] stack) before the
// ordered-row-sum kernel read it back.  Here each row's 10 floats are read
// once and everything between them and the 27 sums stays in registers.
//
// The arithmetic is the plain chain's, each operation rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn, so nvcc contracts nothing into an FMA):
//   J = (nx, ny, nz, py*nz - pz*ny, pz*nx - px*nz, px*ny - py*nx)
//   r = ((px - qx)*nx + (py - qy)*ny) + (pz - qz)*nz
//   entry k < 21: (w*J[i])*J[j], i = 0..5, j = 0..i; entry 21 + i: (w*J[i])*r
// and the sums are row_sums_kernel's: lane t of the lane's warp adds rows t,
// t + 32, t + 64, ... in turn to +0.0f, then the warp folds its 32 partial
// sums by the xor-shuffle tree (offsets 16, 8, 4, 2, 1).  Masked rows
// (w = 0) are multiplied, not skipped, so a non-finite row still poisons
// its lane's sums as it does in the plain chain.  The plain version
// (tpu3dm_torch/ops/rowsum.py:p2pl_sums_plain) gives the same bits.
//
// What bounds it on the H100: bytes.  40 bytes a row in (point, matched
// point, normal, weight), 108 a lane out; about 80 fp32 instructions a row
// against 40 bytes is far below the card's ratio.  One warp a lane keeps
// the order above; a thread holds 27 accumulators and loads kUnroll rows
// ahead of their adds, so each warp keeps 40 x kUnroll x 32 bytes in
// flight.  The matched point and normal are read through a row stride, so
// the wrapper passes views of the search payload ([..., 6] rows) uncopied.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kSums = 27;
constexpr int kUnroll = 4;

struct Row {
  float px, py, pz, qx, qy, qz, nx, ny, nz, w;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ pts, long long ps,
                                        const float* __restrict__ q, long long qs,
                                        const float* __restrict__ n, long long ns,
                                        const float* __restrict__ w, long long row) {
  const float* p = pts + row * ps;
  const float* qq = q + row * qs;
  const float* nn = n + row * ns;
  return Row{p[0], p[1], p[2], qq[0], qq[1], qq[2], nn[0], nn[1], nn[2], w[row]};
}

__device__ __forceinline__ void accumulate(float (&acc)[kSums], const Row& r) {
  const float J[6] = {
      r.nx,
      r.ny,
      r.nz,
      __fsub_rn(__fmul_rn(r.py, r.nz), __fmul_rn(r.pz, r.ny)),
      __fsub_rn(__fmul_rn(r.pz, r.nx), __fmul_rn(r.px, r.nz)),
      __fsub_rn(__fmul_rn(r.px, r.ny), __fmul_rn(r.py, r.nx)),
  };
  const float res = __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(r.px, r.qx), r.nx),
                                        __fmul_rn(__fsub_rn(r.py, r.qy), r.ny)),
                              __fmul_rn(__fsub_rn(r.pz, r.qz), r.nz));
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float wj = __fmul_rn(r.w, J[i]);
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, J[j]));
      ++k;
    }
    acc[21 + i] = __fadd_rn(acc[21 + i], __fmul_rn(wj, res));
  }
}

__global__ void __launch_bounds__(kThreads)
p2pl_sums_kernel(const float* __restrict__ pts, long long ps, const float* __restrict__ q,
                 long long qs, const float* __restrict__ n, long long ns,
                 const float* __restrict__ w, float* __restrict__ out, long long lanes, int m) {
  const long long lane = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (lane >= lanes) return;  // a whole warp leaves together
  const int t = threadIdx.x & 31;
  const long long base = lane * static_cast<long long>(m);
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  for (int i0 = t; i0 < m; i0 += 32 * kUnroll) {
    Row rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 32 * u;
      if (i < m) rows[u] = load_row(pts, ps, q, qs, n, ns, w, base + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + 32 * u < m) accumulate(acc, rows[u]);
    }
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
    }
  }
  // After the xor tree every thread holds all 27 sums; thread k writes sum k.
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    if (t == k) v = acc[k];
  }
  if (t < kSums) out[lane * kSums + t] = v;
}

}  // namespace

// pts, q, n: float32 rows of 3, row r of lane l at (l * m + r) * stride
// floats (ps, qs, ns >= 3, the last dim contiguous); w [lanes, m] float32,
// contiguous; writes out [lanes, 27] float32.  Launches on ``stream`` and
// returns cudaGetLastError(); lanes <= 0 launches nothing (m <= 0 writes
// zeros).
extern "C" int t3t_p2pl_sums(const float* pts, long long ps, const float* q, long long qs,
                             const float* n, long long ns, const float* w, float* out,
                             long long lanes, int m, cudaStream_t stream) {
  if (lanes <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p2pl_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      pts, ps, q, qs, n, ns, w, out, lanes, m);
  return static_cast<int>(cudaGetLastError());
}
