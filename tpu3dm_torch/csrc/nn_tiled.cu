// Tiled top-1 nearest neighbour of one query set among one target set.
//
// Replaces the two TPU kernels behind tpu3dm/ops/nn.py:nn_search_pallas, the
// search that nn_search takes above DENSE_MAX_ENTRIES (16M entries):
//
//   t3t_nn_tiled_smalld  <-  _nn_kernel_smalld (d < 8; built for d = 3, the
//     only width of the port's paths: the 3-D searches of the large-cloud
//     path, donor normals at 1,000,448 x 1024 or x 8192 targets, and the
//     downsampled ICP and evaluation at 8192 x 8192):
//       d2(i, j) = bias[j] + sum_k (q[i, k] - t[j, k])^2
//     bias is 0 for a valid target and BIG for a masked one, so d2 is the
//     true squared distance.  sqdist3.cuh rounds each step on its own in the
//     plain version's order (tpu3dm_torch/ops/nn.py:nn_search_dense), so the
//     two agree bit for bit.  A masked query (JAX leaves its result
//     unspecified) is not computed: it gets idx 0 and d2 = BIG.
//
//   t3t_nn_tiled_wide  <-  _nn_kernel (8 <= d <= 64: the FPFH searches of
//     nn_mutual at 8192 x 8192 x 33):
//       p(i, j) = tsq[j] - 2 (q_i . t_j)
//     with tsq = |t_j|^2, or BIG for a masked target, as one fmaf(-2, dot,
//     tsq) after a dot that is one fmaf chain over k in order; the plain
//     version's is a cuBLAS fp32 product, so the two agree up to the dot's
//     summation order.  The wrapper adds |q_i|^2 and clamps at 0 after the
//     search, as nn_search_pallas does.  At d = 33, the only wide width of
//     the port's paths, it runs fpfh_search.cuh (the FPFH tile over listed
//     valid rows, the targets split across a cluster) and takes both masks:
//     a masked query is not computed (idx 0, p = BIG).  Other widths run
//     nn_wide.cuh over every row.
//
// Both keep, per query, the running minimum and its FIRST index: a strict `<`
// over ascending targets, which is the TPU kernel's rule (first argmin inside
// a tile, strict `<` across tiles in order) and torch.argmin's.
//
// Design.  The TPU kernels carry the running best across the sequential
// target axis of their grid in VMEM.  Hopper blocks run in no order.
//
// smalld.  What bounds it on the H100: operations, 9 fp32 instructions a
// valid entry (3 subtractions, 3 squares, 2 adds, the compare) against a few
// MB moved.  Its two shapes pull apart: 1,000,448 queries x 1024 targets
// (A's donor normals, 761 valid) and 8192 x 8192 (B's downsampled ICP,
// 6750 x 6891 valid, 136 launches a call).  The kernel of lane_nn.cu
// (kernel 1) serves both: a block takes a tile of queries, each thread R of
// them in registers with their running (min, argmin), and stages only the
// valid targets, compacted in index order into shared x, y, z and index
// arrays (stage_valid: four rows a thread a round, all loaded before the
// block-wide prefix, so a round waits on memory once): three broadcast
// loads serve R entries, and masked targets cost nothing.  Masked queries
// are compacted out of the tile (compact.cuh), so a tile past the valid
// rows computes nothing.  The best valid d2 equals the plain version's
// biased minimum while it is below BIG; otherwise the query runs the biased
// loop (biased_search), so the kernel is exact in every case.  At 1M
// queries a tile is 1024 queries (R = 8, 128 threads, one block a tile).
// At 8192 queries that is 8 blocks for 132 SMs, so there a tile is 128
// queries (R = 2, 64 threads) and a cluster of up to 8 blocks shares it,
// each block searching one slice of the targets; the blocks merge their
// (d2, index) through distributed shared memory in slice order with a
// strict `<`, which is the first index of the row's minimum: one launch,
// no scratch in device memory, no atomics.  Chosen on the H100 by a
// variant timer at both shapes (PERF.md): at 8192 queries R = 2 with 64
// or 128 threads ran ahead of R = 4 and of R = 1 or 8, and four rows a
// thread a staging round ahead of one; at 1M queries R = 8 and R = 4 with
// 128 threads ran alike, ahead of 64 threads.
//
// wide does d + 1 per entry (d FMAs, then one fmaf of the -2 scale with
// tsq; 8192^2 x 33: 2.2e9 FMAs against 2 MB moved).  At d = 33 the design
// is fpfh_search.cuh's, which says what it does about that bound (PERF.md,
// on the H100: from 0.4062 ms at 11.6% of the bound on B's 8192^2, where
// the 64 x 64 tiles of nn_wide.cuh filled 128 blocks of 8 warps and
// computed masked rows).  Other widths keep nn_wide.cuh (4 x 4 register
// tiles, every row).
// No tensor cores: the contract is fp32 (TF32 is off in the port).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "compact.cuh"
#include "fpfh_search.cuh"
#include "nn_wide.cuh"
#include "sqdist3.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- smalld --

constexpr int kSmallTile = 1024;  // targets staged per pass: 16 KB of (x, y, z, index)
constexpr int kMaxSplit = 8;      // blocks of a cluster: the portable maximum

// The valid rows of t[base, base + n) (mask null: every row), in index
// order, into sx, sy, sz and their indices into sj from slot 0; returns how
// many.  Each thread takes 4 consecutive rows a round and loads all of them
// before the block-wide prefix (a warp shuffle scan, then the warps' counts
// through warp_counts), so a round of 4 * THREADS rows waits on memory
// once.  Every thread of the block calls it; two barriers a round, the
// first before any write, so a caller may still be reading the last tile.
template <int THREADS>
__device__ __forceinline__ int stage_valid(const float* __restrict__ t,
                                           const unsigned char* __restrict__ mask, int base,
                                           int n, float* sx, float* sy, float* sz, int* sj,
                                           int* warp_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nv = 0;
  for (int r0 = 0; r0 < n; r0 += 4 * THREADS) {
    const int j0 = r0 + 4 * static_cast<int>(threadIdx.x);
    float v[12];
    bool keep[4];
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      keep[k] = j < n && (mask == nullptr || mask[base + j]);
      const size_t g = static_cast<size_t>(base) + min(j, n - 1);
      v[3 * k] = t[3 * g];
      v[3 * k + 1] = t[3 * g + 1];
      v[3 * k + 2] = t[3 * g + 2];
      c += keep[k] ? 1 : 0;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_counts[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int cw = warp_counts[w];
      before += w < warp ? cw : 0;
      total += cw;
    }
    __syncthreads();
    int slot = nv + before + incl - c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (keep[k]) {
        sx[slot] = v[3 * k];
        sy[slot] = v[3 * k + 1];
        sz[slot] = v[3 * k + 2];
        sj[slot] = base + j0 + k;
        ++slot;
      }
    }
    nv += total;
  }
  return nv;
}

// One cluster of S blocks takes a tile of Q = R * THREADS query rows; block
// `split` of it searches the split-th of S equal slices of the target rows.
// The grid is (S * tiles) along x, a cluster of (S, 1, 1).
template <int R, int THREADS>
__global__ void __launch_bounds__(THREADS)
nn_smalld_kernel(const float* __restrict__ q, const float* __restrict__ t,
                 const unsigned char* __restrict__ qmask, const unsigned char* __restrict__ tmask,
                 float* __restrict__ d2_out, int* __restrict__ idx_out, int M, int N) {
  constexpr int Q = R * THREADS;
  __shared__ float sx[kSmallTile], sy[kSmallTile], sz[kSmallTile];  // compacted valid targets
  __shared__ int sj[kSmallTile];                                    // and their indices
  __shared__ int qrow[Q];                                           // the tile's valid queries
  __shared__ float part_d[Q];  // this block's best of each listed query, read by the cluster
  __shared__ int part_j[Q];
  __shared__ int warp_counts[THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tile0 = static_cast<int>(blockIdx.x / nsplit) * Q;

  // The tile's valid query rows, in index order; split 0 writes the masked ones.
  int nq = 0;
  for (int r0 = 0; r0 < Q; r0 += THREADS) {
    const int i = tile0 + r0 + static_cast<int>(threadIdx.x);
    const bool live = i < M;
    const bool keep = live && (qmask == nullptr || qmask[i]);
    int kept;
    const int slot = nq + compact_slot(keep, warp_counts, &kept);
    if (keep) qrow[slot] = i;
    if (live && !keep && split == 0) {
      d2_out[i] = kBig;
      idx_out[i] = 0;
    }
    nq += kept;
  }
  if (nq == 0) return;  // the same tile, so the same exit, in every block of the cluster
  __syncthreads();

  float qx[R], qy[R], qz[R], best[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = qrow[min(static_cast<int>(threadIdx.x) + r * THREADS, nq - 1)];  // extra slots compute, unwritten
    qx[r] = q[3 * static_cast<size_t>(i)];
    qy[r] = q[3 * static_cast<size_t>(i) + 1];
    qz[r] = q[3 * static_cast<size_t>(i) + 2];
    best[r] = CUDART_INF_F;
    best_j[r] = 0;
  }

  // This block's slice of the targets, staged a tile at a time, valid rows only.
  const int lo = static_cast<int>(static_cast<long long>(N) * split / nsplit);
  const int hi = static_cast<int>(static_cast<long long>(N) * (split + 1) / nsplit);
  for (int base = lo; base < hi; base += kSmallTile) {
    const int n = min(kSmallTile, hi - base);
    const int nv = stage_valid<THREADS>(t, tmask, base, n, sx, sy, sz, sj, warp_counts);
    __syncthreads();
    for (int s = 0; s < nv; ++s) {
      const float tx = sx[s], ty = sy[s], tz = sz[s];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float acc = sq_dist3(qx[r], qy[r], qz[r], tx, ty, tz);
        if (acc < best[r]) {  // strict: ties keep the smaller index
          best[r] = acc;
          best_j[r] = sj[s];
        }
      }
    }
  }

  // Merge the cluster's slices: each block finishes a share of the listed
  // queries, reading every block's best in slice order (ascending indices,
  // strict `<`: the first index of the row's minimum).
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = static_cast<int>(threadIdx.x) + r * THREADS;
    if (s < nq) {
      part_d[s] = best[r];
      part_j[s] = best_j[r];
    }
  }
  cluster.sync();
  for (int s = split * THREADS + static_cast<int>(threadIdx.x); s < nq; s += nsplit * THREADS) {
    Best b{CUDART_INF_F, 0};
    for (int k = 0; k < nsplit; ++k) {
      const float d = cluster.map_shared_rank(part_d, k)[s];
      if (d < b.d2) {
        b.d2 = d;
        b.j = cluster.map_shared_rank(part_j, k)[s];
      }
    }
    const size_t i = qrow[s];
    if (!(b.d2 < kBig)) b = biased_search(q[3 * i], q[3 * i + 1], q[3 * i + 2], t, tmask, N);
    d2_out[i] = fmaxf(b.d2, 0.f);
    idx_out[i] = b.j;
  }
  cluster.sync();  // no block leaves while another may read its part_d / part_j
}

template <int R, int THREADS>
cudaError_t launch_smalld(const float* q, const float* t, const unsigned char* qmask,
                          const unsigned char* tmask, float* d2, int* idx, int M, int N,
                          int nsplit, cudaStream_t stream) {
  constexpr int Q = R * THREADS;
  const long long tiles = (static_cast<long long>(M) + Q - 1) / Q;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * nsplit), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nn_smalld_kernel<R, THREADS>, q, t, qmask, tmask, d2, idx, M,
                            N);
}

// ------------------------------------------------------------------ wide --

__global__ void __launch_bounds__(kWideThreads)
nn_wide_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const float* __restrict__ tsq, float* __restrict__ part_out,
               int* __restrict__ idx_out, int M, int N, int D) {
  nn_wide_block(q, t, tsq, part_out, idx_out, M, N, D, blockIdx.x * kWideTile);
}

}  // namespace

// q [M, 3], t [N, 3] float32, contiguous; qmask [M] and tmask [N] one byte a
// row, nonzero for a valid row, or null for every row valid.  Writes, for each
// valid query, d2 [M] float32 (the true squared distance, clamped at 0) and
// idx [M] int32, and BIG and 0 for a masked query.  Launches on ``stream``
// and returns cudaGetLastError().
extern "C" int t3t_nn_tiled_smalld(const float* q, const float* t, const unsigned char* qmask,
                                   const unsigned char* tmask, float* d2, int* idx, int M, int N,
                                   cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  // Enough query tiles to fill the card: one block a tile of 1024 queries.
  // Fewer: tiles of 128 queries, the target axis split over a cluster of up
  // to 8 blocks (no slice under 256 targets) until ~4 blocks an SM are busy.
  constexpr int kSMs = 132;
  cudaError_t err;
  if (M >= 2 * kSMs * 1024) {
    err = launch_smalld<8, 128>(q, t, qmask, tmask, d2, idx, M, N, 1, stream);
  } else {
    const int tiles = (M + 127) / 128;
    int nsplit = (4 * kSMs + tiles - 1) / tiles;
    nsplit = std::max(1, std::min({nsplit, kMaxSplit, N / 256}));
    err = launch_smalld<2, 64>(q, t, qmask, tmask, d2, idx, M, N, nsplit, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// q [M, d], t [N, d], tsq [N] float32, contiguous, 8 <= d <= 64, tsq BIG at
// masked targets; qmask [M] and tmask [N] one byte a row (null: every row
// valid), read at d = 33 only.  Writes part [M] = min_j (tsq[j] - 2 q.t_j)
// float32 and idx [M] int32 (at d = 33: idx 0 and part BIG at a masked
// query).  Launches on ``stream`` and returns cudaGetLastError(), or
// cudaErrorInvalidValue where d is out of range or N >= 2^30.
extern "C" int t3t_nn_tiled_wide(const float* q, const float* t, const float* tsq,
                                 const unsigned char* qmask, const unsigned char* tmask,
                                 float* part, int* idx, int M, int N, int d,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kWideMaxD || N >= kPartTag) return static_cast<int>(cudaErrorInvalidValue);
  if (d == fpfh::kD) {
    return static_cast<int>(launch_fpfh_search(q, t, tsq, qmask, tmask, part, idx, 1, M, N,
                                               stream));
  }
  const int grid = (M + kWideTile - 1) / kWideTile;
  nn_wide_kernel<<<grid, kWideThreads, 0, stream>>>(q, t, tsq, part, idx, M, N, d);
  return static_cast<int>(cudaGetLastError());
}
