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
// t3t_ransac_score: H and F in fp32 (approx_score=False at 2048 lanes, and
// the large path's one-lane two-mode score: K 4096, N 8192, ~2,600 valid),
// for exact fp32 inputs, which a bf16 tensor-core product cannot take (and
// the port keeps TF32 off).  What bounds it on the H100: operations, 19
// fp32 instructions an entry (16 FMAs, the adds of c and e, the compare)
// over every hypothesis and the lane's VALID correspondences.  The design:
//   - only valid rows: a block lists its lane's valid correspondences in
//     index order (compact.cuh:list_rows) and copies their F rows and c into
//     shared memory in tiles of kRows, double-buffered by cp.async (the next
//     tile in flight while this one is computed);
//   - a register tile: a block takes kHyps hypotheses, kHypThreads threads
//     across them, kHypsPerThread a thread (H rows, e and counts in
//     registers), so one row's 4 broadcast float4 loads and its c feed
//     4 x 16 FMAs; the block's kRowGroups groups of kHypThreads threads take
//     every kRowGroups-th row of a tile, and their counts are summed in
//     shared memory at the end;
//   - the card filled at few lanes: lanes x hypothesis tiles blocks fill it
//     at 2048 lanes, but one lane gives 16 blocks, so there a cluster of up
//     to 8 blocks shares a hypothesis tile, block s taking the s-th of
//     nsplit equal shares of the listed rows, and the blocks' partial counts
//     are summed through distributed shared memory (integer sums: exact in
//     any order, so the counts do not depend on the split): one launch, no
//     memset, no atomics.  No block leaves early, so every block reaches
//     both cluster.sync().
// Each entry keeps the first design's arithmetic: one fmaf chain over the 16
// features in order from 0, then + c, then + e, then < thr (a NaN or inf
// from a degenerate fit compares false), so its d2 keeps its bits.  Chosen
// on the H100 with the ptxas report and a variant timer (PERF.md): 4
// hypotheses a thread and 64 threads across them (119 registers, no
// spills) ran fastest at one lane and at 2048 lanes, ahead of 2 a thread x
// 128 threads, then 4 x 32 and 2 x 64 (about even at one lane, a third
// slower at 2048 lanes); 8 a thread spills and passes 48 KB of static
// shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "compact.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kHypsPerThread = 4;                    // MT
constexpr int kHypThreads = 64;                      // threads across a block's hypotheses
constexpr int kRowGroups = kThreads / kHypThreads;   // groups of threads across rows
constexpr int kHyps = kHypThreads * kHypsPerThread;  // hypotheses a block: 256
constexpr int kRows = 256;       // listed rows a staged tile: 16 KB of F + 1 KB of c
constexpr int kListCap = 2048;   // listed rows a block holds at once
constexpr int kMaxSplit = 8;     // blocks of a cluster: the portable maximum
constexpr int kSMs = 132;
static_assert(kThreads % kHypThreads == 0 && kHypThreads % 32 == 0, "whole warps a row group");
static_assert(kHyps <= kThreads, "one thread sums each hypothesis's counts");

// Copy listed rows list[first + r], r < n, of the lane's F (4 float4 a row)
// and c into fs and cs.  Issues cp.async copies: the caller commits them.
__device__ __forceinline__ void stage_rows(float4* __restrict__ fs, float* __restrict__ cs,
                                           const float4* __restrict__ lF,
                                           const float* __restrict__ lc,
                                           const int* __restrict__ list, int first, int n) {
  for (int x = threadIdx.x; x < 4 * n; x += kThreads) {
    cp_async16(fs + x, lF + 4 * static_cast<size_t>(list[first + (x >> 2)]) + (x & 3));
  }
  for (int r = threadIdx.x; r < n; r += kThreads) cp_async4(cs + r, lc + list[first + r]);
}

// Grid (hypothesis tiles x nsplit, lanes), clusters of (nsplit, 1, 1).
__global__ void __launch_bounds__(kThreads, 2)
score_kernel(const float* __restrict__ H, const float* __restrict__ e,
             const float* __restrict__ F, const float* __restrict__ c,
             const unsigned char* __restrict__ mask, float thr,
             int* __restrict__ counts, int K, int N) {
  constexpr int MT = kHypsPerThread;
  __shared__ float4 fs[2][kRows * 4];           // two tiles of listed F rows
  __shared__ float cs[2][kRows];                // and their c
  __shared__ int list[kListCap];                // listed rows of this part
  __shared__ int group_counts[kRowGroups][kHyps];
  __shared__ int block_counts[kHyps];           // read by the cluster
  __shared__ int warp_counts[kThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const size_t lane = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.x / nsplit) * kHyps;
  const int h = threadIdx.x % kHypThreads;  // hypotheses k0 + m * kHypThreads + h
  const int g = threadIdx.x / kHypThreads;  // rows g, g + kRowGroups, ... of a tile

  float hv[MT][16], ek[MT];
  int cnt[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int k = min(k0 + m * kHypThreads + h, K - 1);  // rows past K compute, unwritten
    const size_t hk = lane * K + k;
    const float4* H4 = reinterpret_cast<const float4*>(H) + hk * 4;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 r = H4[v];
      hv[m][4 * v] = r.x;
      hv[m][4 * v + 1] = r.y;
      hv[m][4 * v + 2] = r.z;
      hv[m][4 * v + 3] = r.w;
    }
    ek[m] = e[hk];
    cnt[m] = 0;
  }

  const float4* lF = reinterpret_cast<const float4*>(F) + lane * N * 4;
  const float* lc = c + lane * N;
  const unsigned char* lm = mask + lane * N;
  // This block's share: positions [lo, hi) of the lane's listed rows.
  const int nv = count_rows(lm, N, warp_counts);
  const int lo = static_cast<int>(static_cast<long long>(nv) * split / nsplit);
  const int hi = static_cast<int>(static_cast<long long>(nv) * (split + 1) / nsplit);
  for (int p = lo; p < hi; p += kListCap) {
    // list_rows' first barrier comes before its first write: every thread
    // is done with the last part's tiles and list by then.
    const int n = min(kListCap, hi - p);
    list_rows(lm, N, p, p + n, list, warp_counts);
    __syncthreads();  // list
    const int n_tiles = (n + kRows - 1) / kRows;
    stage_rows(fs[0], cs[0], lF, lc, list, 0, min(kRows, n));
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      cp_async_wait<0>();  // tile t has landed (this thread's copies)
      __syncthreads();      // everyone's copies, and everyone is done with tile t - 1
      if (t + 1 < n_tiles) {
        stage_rows(fs[buf ^ 1], cs[buf ^ 1], lF, lc, list, (t + 1) * kRows,
                   min(kRows, n - (t + 1) * kRows));
        cp_async_commit();
      }
      const int rows = min(kRows, n - t * kRows);
      const float4* f4 = fs[buf];
      const float* ct = cs[buf];
      for (int r = g; r < rows; r += kRowGroups) {
        const float4 f0 = f4[4 * r], f1 = f4[4 * r + 1], f2 = f4[4 * r + 2], f3 = f4[4 * r + 3];
        const float cr = ct[r];
        const float fv[16] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                              f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float acc = 0.f;
#pragma unroll
          for (int x = 0; x < 16; ++x) acc = __fmaf_rn(hv[m][x], fv[x], acc);
          const float d2 = __fadd_rn(__fadd_rn(acc, cr), ek[m]);
          cnt[m] += d2 < thr ? 1 : 0;
        }
      }
    }
  }

  // The row groups' counts, then (split) the cluster's, summed once each.
#pragma unroll
  for (int m = 0; m < MT; ++m) group_counts[g][m * kHypThreads + h] = cnt[m];
  __syncthreads();
  const int j = threadIdx.x;  // the block's hypothesis k0 + j
  int total = 0;
  if (j < kHyps) {
#pragma unroll
    for (int w = 0; w < kRowGroups; ++w) total += group_counts[w][j];
  }
  int* out = counts + lane * K + k0 + j;
  if (nsplit == 1) {
    if (j < kHyps && k0 + j < K) *out = total;
    return;
  }
  if (j < kHyps) block_counts[j] = total;
  cluster.sync();
  if (j < kHyps && j % nsplit == split && k0 + j < K) {
    int sum = 0;
    for (int r = 0; r < nsplit; ++r) sum += cluster.map_shared_rank(block_counts, r)[j];
    *out = sum;
  }
  cluster.sync();  // no block leaves while another may read its block_counts
}

// Blocks of a cluster for `blocks` clusters (hypothesis tiles x lanes):
// enough to put two blocks on every SM, a power of two up to 8, and no share
// under 256 rows.
int score_split(long long blocks, int N) {
  int nsplit = 1;
  while (nsplit < kMaxSplit && blocks * nsplit < 2 * kSMs && 2 * nsplit * 256 <= N) nsplit *= 2;
  return nsplit;
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
  const long long tiles = (static_cast<long long>(K) + kHyps - 1) / kHyps;
  const int nsplit = score_split(tiles * B, N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * nsplit), static_cast<unsigned>(B), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, score_kernel, H, e, F, c, mask, thr, counts,
                                             K, N);
  if (err != cudaSuccess) return static_cast<int>(err);
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
