// RANSAC inlier counts from the rank-15 bilinear score: two routes.
//
// Both replace the TPU kernel tpu3dm/ops/ransac_score.py:_score_kernel.  In
// the port they score every hypothesis chunk of registration/hypotheses.py:
// fit_score_gathers, where the JAX package let XLA fuse the same function.
//
// For pair lane b, hypothesis k (features H[b, k, :16], e[b, k] = |t_k|^2) and
// correspondence n (F[b, n, :16], c[b, n] = |p_n|^2 + |q_n|^2):
//   counts[b, k] = #{ n : (H_k . F_n + c_n) + e_k < thr  and  mask[b, n] }
// which is #{ n : |R_k p_n + t_k - q_n|^2 < thr }: the order of the plain
// version (H @ F^T + c) + e, up to the dot's summation order.  The TPU kernel
// tiles (k, n) on a grid whose n axis runs in order and carries the counts
// in VMEM from one n-tile to the next.  Hopper blocks run in no order, so on
// both routes the n axis is a loop inside the block and each count is
// written once, with no atomics.
//
// t3t_ransac_score_bf16: H and F in bf16 (approx_score, the main path:
// hypotheses.py rounds both, as the JAX package's bf16-in, fp32-accumulate
// dot does).  The product is exact in fp32, so the function is a bf16
// tensor-core product with fp32 accumulation, and what bounds it on the
// H100 is not the product (0.28 ms at the dense bf16 rate for B = 2048,
// K = 4096, N = 1024) but its fp32 epilogue (two adds and the compare a
// entry) and the bytes (H, e, counts).  The design: a block takes one lane
// and a slab of 512 hypotheses, and stages the lane's VALID correspondences
// into shared memory, compacted in index order (warp ballot + popc prefix,
// compact.cuh) and padded to a multiple of 8 rows with c = +inf, so masked
// rows (about two thirds on the mutual path) cost nothing.  Each warp keeps
// four m16 tiles of H as mma.sync A fragments in registers with their e_k,
// and walks the lane's compacted rows 8 at a time:
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 from a zero accumulator,
// then d2 = (acc + c_n) + e_k and count += d2 < thr (a NaN or inf from a
// degenerate fit compares false, as in the plain version).  The 16 features
// sit in the fragments' k slots in a fixed permutation (the dot does not
// depend on it): thread (group g, index t) holds features 4t .. 4t + 3 of
// its rows, so every A or B fragment is one 8-byte load, and a warp's B load
// reads 256 contiguous bytes of shared memory: no bank conflict and no
// ldmatrix.  The four threads of a quad hold a row's partial counts; two
// __shfl_xor_sync sum them.  H moves 32 B a hypothesis (64 B in fp32).  The
// tensor core's sum of the 16 products rounds differently from an fmaf
// chain, so a count may differ from the plain version's only where d2 lies
// within that rounding of thr (chip_smoke.py and the card tests bracket it).
//
// t3t_ransac_score: H and F in fp32 (approx_score=False, and the large
// path's one-lane two-mode score), the first design, kept for exact fp32
// inputs, which a bf16 tensor-core product cannot take: one thread per
// hypothesis keeps its H row (16 registers) and its count in registers; the
// lane's correspondences stream through shared memory (F rows as four
// float4 broadcasts; c with the mask folded in as +inf) through an fp32
// fmaf chain over the 16 features in order, then + c, then + e.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "compact.cuh"

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

// ---------------------------------------------------------------- bf16 --

constexpr int kBfThreads = 256;  // 8 warps
constexpr int kMTiles = 4;       // m16 tiles of hypotheses a warp
constexpr int kSlab = kBfThreads / 32 * kMTiles * 16;  // hypotheses a block: 512
constexpr int kBfTile = 1024;    // correspondences staged per pass: 32 KB of F + 4 KB of c

// D = A B with a zero accumulator: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col).
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// H rows are 4 x uint2 (16 bf16), F rows 2 x uint4.  In the fragments,
// thread (g = lane / 4, t = lane % 4) holds features 4t .. 4t + 3 of a row:
// the first pair in the k slots 2t, 2t + 1, the second in 2t + 8, 2t + 9.
__global__ void __launch_bounds__(kBfThreads)
score_bf16_kernel(const uint2* __restrict__ H, const float* __restrict__ e,
                  const uint4* __restrict__ F, const float* __restrict__ c,
                  const unsigned char* __restrict__ mask, float thr,
                  int* __restrict__ counts, int K, int N) {
  constexpr int MT = kMTiles;
  __shared__ uint4 fs[kBfTile * 2];  // compacted F rows
  __shared__ float cs[kBfTile];      // their c, +inf in the padding
  __shared__ int warp_counts[kBfThreads / 32];
  const int lane = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int row0 = blockIdx.x * kSlab + warp * MT * 16;

  // Rows row0 + 16 m + g (h = 0) and + 8 (h = 1): A fragments, e and counts.
  unsigned a[MT][4];
  float ek[MT][2];
  int cnt[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = min(row0 + 16 * m + g + 8 * h, K - 1);  // rows past K compute, unwritten
      const size_t hk = static_cast<size_t>(lane) * K + k;
      const uint2 v = H[hk * 4 + tq];
      a[m][h] = v.x;
      a[m][h + 2] = v.y;
      ek[m][h] = e[hk];
      cnt[m][h] = 0;
    }
  }

  const uint4* lF = F + static_cast<size_t>(lane) * N * 2;
  const float* lc = c + static_cast<size_t>(lane) * N;
  const unsigned char* lm = mask + static_cast<size_t>(lane) * N;
  const uint2* fs2 = reinterpret_cast<const uint2*>(fs);
  for (int base = 0; base < N; base += kBfTile) {
    const int n = min(kBfTile, N - base);
    int nv = 0;  // valid rows of this tile, compacted in index order
    for (int r0 = 0; r0 < n; r0 += kBfThreads) {
      const int j = r0 + threadIdx.x;
      const bool keep = j < n && lm[base + j];
      int kept;
      const int slot = nv + compact_slot(keep, warp_counts, &kept);  // syncs: the last tile is read
      if (keep) {
        const size_t src = static_cast<size_t>(base) + j;
        fs[2 * slot] = lF[2 * src];
        fs[2 * slot + 1] = lF[2 * src + 1];
        cs[slot] = lc[src];
      }
      nv += kept;
    }
    const int padded = (nv + 7) & ~7;
    if (nv + static_cast<int>(threadIdx.x) < padded) {
      const int slot = nv + threadIdx.x;
      fs[2 * slot] = make_uint4(0u, 0u, 0u, 0u);
      fs[2 * slot + 1] = make_uint4(0u, 0u, 0u, 0u);
      cs[slot] = CUDART_INF_F;  // never counts
    }
    __syncthreads();
    for (int n0 = 0; n0 < padded; n0 += 8) {
      const uint2 b = fs2[(n0 + g) * 4 + tq];  // column n0 + g
      const float2 cc = *reinterpret_cast<const float2*>(&cs[n0 + 2 * tq]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float d[4];
        mma_16816(d, a[m], b.x, b.y);
        // d[0], d[1]: row g, columns n0 + 2t, + 1; d[2], d[3]: row g + 8.
        cnt[m][0] += (__fadd_rn(__fadd_rn(d[0], cc.x), ek[m][0]) < thr) +
                     (__fadd_rn(__fadd_rn(d[1], cc.y), ek[m][0]) < thr);
        cnt[m][1] += (__fadd_rn(__fadd_rn(d[2], cc.x), ek[m][1]) < thr) +
                     (__fadd_rn(__fadd_rn(d[3], cc.y), ek[m][1]) < thr);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = cnt[m][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int k = row0 + 16 * m + g + 8 * h;
      if (tq == 0 && k < K) counts[static_cast<size_t>(lane) * K + k] = v;
    }
  }
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

// H [B, K, 16] and F [B, N, 16] bf16, e [B, K] and c [B, N] float32, mask
// [B, N] bool (one byte each), contiguous, H and F 16-byte aligned; writes
// counts [B, K] int32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_ransac_score_bf16(const void* H, const float* e, const void* F,
                                     const float* c, const unsigned char* mask, float thr,
                                     int* counts, int B, int K, int N, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((K + kSlab - 1) / kSlab, B);
  score_bf16_kernel<<<grid, kBfThreads, 0, stream>>>(
      static_cast<const uint2*>(H), e, static_cast<const uint4*>(F), c, mask, thr, counts, K, N);
  return static_cast<int>(cudaGetLastError());
}
