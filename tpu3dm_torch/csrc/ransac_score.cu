// RANSAC inlier counts from the rank-15 bilinear score.
//
// Replaces the TPU kernel tpu3dm/ops/ransac_score.py:_score_kernel.  In the
// port it scores every hypothesis chunk of registration/hypotheses.py:
// fit_score_gathers, where the JAX package let XLA fuse the same function.
//
// For pair lane b, hypothesis k (features H[b, k, :16], e[b, k] = |t_k|^2) and
// correspondence n (F[b, n, :16], c[b, n] = |p_n|^2 + |q_n|^2):
//   counts[b, k] = #{ n : (H_k . F_n + c_n) + e_k < thr  and  mask[b, n] }
// which is #{ n : |R_k p_n + t_k - q_n|^2 < thr }.  The dot is an fp32 fmaf
// chain over the 16 features in order, then + c, then + e: the order of the
// plain version (H @ F^T + c) + e, up to the dot's summation order.
//
// The TPU kernel tiles (k, n) on a grid whose n axis runs in order and
// carries the counts in VMEM from one n-tile to the next.  Hopper blocks run
// in no order, so the n axis becomes a loop inside the block: one thread per
// hypothesis keeps its H row (16 registers) and its count in registers, the
// lane's correspondences stream through shared memory (F rows as four float4
// broadcasts; c with the mask folded in as +inf), and each count is written
// once, with no atomics.
//
// What bounds it on the H100.  On the main path (approx_score) the wrapper's
// caller has rounded H and F to bf16, so the function is a bf16 product with
// fp32 accumulation: its least time is set by the bf16 tensor cores (32 flops
// per entry), the fp32 epilogue (+ c + e, the compare) and ~0.7 GB moved at
// B=2048, K=4096, N=1024.  This kernel instead runs the product on the fp32
// CUDA cores, 16 FMAs per entry (a product of two bf16 values is exact in
// fp32), and stays well above that bound.  The way to it is a wgmma route: bf16 tiles of H and F, the
// fp32 accumulator started at c_n + e_k, and the compare and count on the
// accumulator fragments.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // correspondences staged per pass: 32 KB of F + 2 KB of c

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ H, const float* __restrict__ e,
             const float* __restrict__ F, const float* __restrict__ c,
             const unsigned char* __restrict__ mask, float thr,
             int* __restrict__ counts, int K, int N) {
  __shared__ float4 f4[kTile * 4];
  __shared__ float sc[kTile];
  const int lane = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const size_t hk = static_cast<size_t>(lane) * K + (k < K ? k : 0);

  float h[16];
  const float4* H4 = reinterpret_cast<const float4*>(H) + hk * 4;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 r = H4[v];
    h[4 * v] = r.x;
    h[4 * v + 1] = r.y;
    h[4 * v + 2] = r.z;
    h[4 * v + 3] = r.w;
  }
  const float ek = e[hk];

  const float4* F4 = reinterpret_cast<const float4*>(F);
  int count = 0;
  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    const size_t first = static_cast<size_t>(lane) * N + base;
    __syncthreads();
    for (int x = threadIdx.x; x < n * 4; x += kThreads) f4[x] = F4[first * 4 + x];
    for (int r = threadIdx.x; r < n; r += kThreads) {
      sc[r] = mask[first + r] ? c[first + r] : CUDART_INF_F;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 f = f4[4 * r + v];
        acc = __fmaf_rn(h[4 * v], f.x, acc);
        acc = __fmaf_rn(h[4 * v + 1], f.y, acc);
        acc = __fmaf_rn(h[4 * v + 2], f.z, acc);
        acc = __fmaf_rn(h[4 * v + 3], f.w, acc);
      }
      const float d2 = __fadd_rn(__fadd_rn(acc, sc[r]), ek);
      count += d2 < thr ? 1 : 0;
    }
  }
  if (k < K) counts[hk] = count;
}

}  // namespace

// H [B, K, 16], e [B, K], F [B, N, 16], c [B, N] float32 and mask [B, N]
// bool (one byte each), contiguous, H and F 16-byte aligned; writes
// counts [B, K] int32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_ransac_score(const float* H, const float* e, const float* F,
                                const float* c, const unsigned char* mask, float thr,
                                int* counts, int B, int K, int N, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  score_kernel<<<grid, kThreads, 0, stream>>>(H, e, F, c, mask, thr, counts, K, N);
  return static_cast<int>(cudaGetLastError());
}
