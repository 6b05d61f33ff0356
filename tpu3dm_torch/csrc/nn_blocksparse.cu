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
// the three products and two sums rounded on their own (no FMA contraction),
// in the order of the plain version (tpu3dm_torch/ops/nn_sparse.py:
// nn_search_table_plain), then fmaf(-2, cross, tsq): 2 * cross is exact, so
// its one rounding is that of tsq - 2 * cross, and the two agree bit for
// bit.  The running minimum keeps the first row within a block and the
// earlier-ranked block across blocks: one strict `<` over the visits in
// order, row by row, which is the TPU kernel's rule (first row of a tile's
// minimum, strict `<` across grid steps).  A thread carries the position
// jj * block + row of its best and forms idx = table[i, jj] * block + row once
// at the end.  The wrapper adds |q|^2 and clamps at 0, as
// nn_search_blocksparse does.  Sentinel queries get finite garbage that
// callers mask.  cert_lb is not computed here: candidate_blocks returns it.
//
// What bounds it on the H100: operations.  At 1,000,448 x 1,000,448 points,
// block 512 and w 8 it evaluates 4.1e9 entries of 7 fp32 operations, against
// ~36 MB moved (queries, packed targets, table, outputs).  An entry costs 9
// instructions here (the 7, then a compare and two selects for the running
// (min, position)), and the earlier design (one query a thread) also paid a
// 128-bit shared load an entry, at the issue rate, not the arithmetic, set
// its pace (27% of the bound).
//
// Design.  On the TPU a scalar-prefetched [nqb * w] table drives the
// BlockSpec index maps and a (query block, visit) grid carries the running
// best in VMEM.  Here a CUDA block takes kQB rows of one query block (the
// whole block at the path's 512), reads its w table entries and walks the
// visits in steps of kChunk target rows (x, y, z, tsq as one float4, packed
// by the wrapper).  Each thread keeps kR queries in registers with their
// running best, so one broadcast float4 load serves kR entries.  The steps
// are double-buffered: cp.async copies step s + 1 into the other buffer
// while step s is computed, one barrier a step.  Chosen on the H100 by a
// variant timer at the path's shape (PERF.md): 4 queries a thread ran ahead
// of 2 and of 8; half a query block a CUDA block (3908 blocks, a shorter
// last wave) with 256-row steps ran about as fast, mixed sizes (256 and
// 512) behind.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"

namespace {

constexpr int kR = 4;                // queries a thread
constexpr int kQB = 512;             // query rows a CUDA block
constexpr int kThreads = kQB / kR;
constexpr int kChunk = 512;          // target rows a step: 8 KB, two buffers

__global__ void __launch_bounds__(kThreads)
blocksparse_kernel(const float* __restrict__ q, const float4* __restrict__ t4,
                   const int* __restrict__ table, float* __restrict__ part_out,
                   int* __restrict__ idx_out, int block, int w) {
  __shared__ __align__(16) float4 buf[2][kChunk];
  const int parts = (block + kQB - 1) / kQB;  // CUDA blocks a query block
  const size_t qb = blockIdx.x / parts;
  const int row0 = static_cast<int>(blockIdx.x % parts) * kQB;
  const int* visits = table + qb * w;

  float qx[kR], qy[kR], qz[kR], best[kR];
  int pos[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = min(row0 + static_cast<int>(threadIdx.x) + r * kThreads, block - 1);
    const size_t g = qb * block + row;  // rows past the block compute, unwritten
    qx[r] = q[3 * g];
    qy[r] = q[3 * g + 1];
    qz[r] = q[3 * g + 2];
    best[r] = CUDART_INF_F;
    pos[r] = 0;
  }

  // Step s: rows [c * kChunk, c * kChunk + n) of visit jj = s / steps_a_visit.
  const int steps_a_visit = (block + kChunk - 1) / kChunk;
  const int steps = w * steps_a_visit;
  auto stage = [&](int s) {
    const int jj = s / steps_a_visit;
    const int first = (s % steps_a_visit) * kChunk;
    const int n = min(kChunk, block - first);
    const float4* src = t4 + static_cast<size_t>(visits[jj]) * block + first;
    for (int x = threadIdx.x; x < n; x += kThreads) cp_async16(&buf[s & 1][x], src + x);
    cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();  // step s has landed (this thread's copies)
    __syncthreads();      // ... every thread's, and step s - 1's buffer is free
    if (s + 1 < steps) stage(s + 1);
    const int first = (s % steps_a_visit) * kChunk;
    const int n = min(kChunk, block - first);
    const int base = (s / steps_a_visit) * block + first;
    const float4* tile = buf[s & 1];
    for (int x = 0; x < n; ++x) {
      const float4 p = tile[x];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx[r], p.x), __fmul_rn(qy[r], p.y)),
                                      __fmul_rn(qz[r], p.z));
        const float d = fmaf(-2.f, cross, p.w);
        if (d < best[r]) {  // strict: earlier row, earlier-ranked block
          best[r] = d;
          pos[r] = base + x;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = row0 + static_cast<int>(threadIdx.x) + r * kThreads;
    if (row < block) {
      const size_t g = qb * block + row;
      part_out[g] = best[r];
      idx_out[g] = visits[pos[r] / block] * block + pos[r] % block;
    }
  }
}

}  // namespace

// q [nqb * block, 3] float32, t4 [ntb * block] float4 (x, y, z, |t|^2),
// table [nqb, w] int32 of target block indices, all contiguous, t4 16-byte
// aligned; writes part [nqb * block] = min (tsq - 2 q.t) float32 and idx
// int32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int t3t_nn_blocksparse(const float* q, const float* t4, const int* table,
                                  float* part, int* idx, int nqb, int block, int w,
                                  cudaStream_t stream) {
  if (nqb <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = static_cast<long long>(nqb) * ((block + kQB - 1) / kQB);
  blocksparse_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      q, reinterpret_cast<const float4*>(t4), table, part, idx, block, w);
  return static_cast<int>(cudaGetLastError());
}
