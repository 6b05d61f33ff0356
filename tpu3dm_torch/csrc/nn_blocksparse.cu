// Block-sparse top-1 3-D nearest neighbour.
//
// Replaces the TPU kernel tpu3dm/ops/nn_sparse.py:_sparse_nn_kernel (wrapper
// nn_search_blocksparse), the correspondence search of every full-resolution
// ICP iteration of registration/large.py.
//
// Both clouds are KD-sorted and padded to a multiple of ``block`` rows.  Query
// block i visits the w target blocks table[i, 0..w-1] in rank order (the
// candidates of ops/nn_sparse.py:candidate_blocks).  For each query q and
// visited target row t (with tsq = |t|^2, huge for SPARSE_PAD sentinel rows):
//   p = tsq - 2 ((q0 t0 + q1 t1) + q2 t2)
// every product, sum and difference rounded on its own (no FMA contraction),
// in the order of the plain version (tpu3dm_torch/ops/nn_sparse.py:
// nn_search_table_plain), so the two agree bit for bit.  The running minimum
// keeps the first row within a block and the earlier-ranked block across
// blocks: one strict `<` over the visits in order, row by row, which is the
// TPU kernel's rule (first row of a tile's minimum, strict `<` across grid
// steps).  idx = table[i, jj] * block + row.  The wrapper adds |q|^2 and
// clamps at 0, as nn_search_blocksparse does.  Sentinel queries get finite
// garbage that callers mask.  cert_lb is not computed here: candidate_blocks
// returns it.
//
// Design.  On the TPU a scalar-prefetched [nqb * w] table drives the
// BlockSpec index maps and a (query block, visit) grid carries the running
// best in VMEM.  Here one CUDA block takes one query block, reads its own w
// table entries from global memory and, visit by visit, copies the candidate
// target block (block x (x, y, z, tsq) = 8 KB at block 512, packed by the
// wrapper) into shared memory; each thread keeps its queries' running best in
// registers and writes it once.
//
// What bounds it on the H100: operations.  At 1,000,448 x 1,000,448 points,
// block 512 and w 8 it evaluates 4.1e9 entries of 7 fp32 operations, against
// ~36 MB moved (queries, packed targets, table, outputs).  Every thread of a
// warp reads the same staged target, so shared memory serves each entry as a
// broadcast; an 8 KB block leaves room for several resident blocks per SM.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxQpt = 4;  // queries per thread: block <= 2048

__global__ void __launch_bounds__(kMaxThreads)
blocksparse_kernel(const float* __restrict__ q, const float4* __restrict__ t4,
                   const int* __restrict__ table, float* __restrict__ part_out,
                   int* __restrict__ idx_out, int block, int w) {
  extern __shared__ float4 tile[];  // [block]
  const size_t qb = blockIdx.x;
  const int qpt = (block + blockDim.x - 1) / blockDim.x;

  float qx[kMaxQpt], qy[kMaxQpt], qz[kMaxQpt], best[kMaxQpt];
  int best_j[kMaxQpt];
#pragma unroll
  for (int a = 0; a < kMaxQpt; ++a) {
    const int r = threadIdx.x + a * blockDim.x;
    const bool live = a < qpt && r < block;
    const size_t g = qb * block + (live ? r : 0);
    qx[a] = live ? q[3 * g] : 0.f;
    qy[a] = live ? q[3 * g + 1] : 0.f;
    qz[a] = live ? q[3 * g + 2] : 0.f;
    best[a] = CUDART_INF_F;
    best_j[a] = 0;
  }

  for (int jj = 0; jj < w; ++jj) {
    const int tb = table[qb * w + jj];
    __syncthreads();
    for (int x = threadIdx.x; x < block; x += blockDim.x) {
      tile[x] = t4[static_cast<size_t>(tb) * block + x];
    }
    __syncthreads();
    for (int row = 0; row < block; ++row) {
      const float4 p = tile[row];
#pragma unroll
      for (int a = 0; a < kMaxQpt; ++a) {
        if (a < qpt) {
          const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx[a], p.x), __fmul_rn(qy[a], p.y)),
                                        __fmul_rn(qz[a], p.z));
          const float d = __fsub_rn(p.w, __fmul_rn(2.f, cross));
          if (d < best[a]) {  // strict: earlier row, earlier-ranked block
            best[a] = d;
            best_j[a] = tb * block + row;
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxQpt; ++a) {
    const int r = threadIdx.x + a * blockDim.x;
    if (a < qpt && r < block) {
      const size_t g = qb * block + r;
      part_out[g] = best[a];
      idx_out[g] = best_j[a];
    }
  }
}

}  // namespace

// q [nqb * block, 3] float32, t4 [ntb * block] float4 (x, y, z, |t|^2),
// table [nqb, w] int32 of target block indices, all contiguous, block <= 2048;
// writes part [nqb * block] = min (tsq - 2 q.t) float32 and idx int32.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_nn_blocksparse(const float* q, const float* t4, const int* table,
                                  float* part, int* idx, int nqb, int block, int w,
                                  cudaStream_t stream) {
  if (nqb <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (block <= 0 || block > kMaxThreads * kMaxQpt) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block < kMaxThreads ? block : kMaxThreads;
  const size_t smem = static_cast<size_t>(block) * sizeof(float4);
  blocksparse_kernel<<<nqb, threads, smem, stream>>>(
      q, reinterpret_cast<const float4*>(t4), table, part, idx, block, w);
  return static_cast<int>(cudaGetLastError());
}
