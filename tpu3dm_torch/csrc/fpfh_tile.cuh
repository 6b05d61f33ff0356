// The 33-D FPFH tile of the kernels lane_mutual.cu (t3t_lane_mutual,
// kernel 2) and, through fpfh_search.cuh, nn_tiled.cu (t3t_nn_tiled_wide at
// d = 33, kernel 5) and lane_nn.cu (t3t_lane_nn_wide at d = 33, kernel 7).
//
// A block of kThreads threads computes, for one pair lane, the dot products
// of a tile of kTile query rows with tiles of kTile target rows.  Only the
// lane's VALID rows are computed: list_rows lists them in index order
// (warp shuffle prefix, compact.cuh), a tile takes the next kTile of
// that list, and a row keeps its original index through the list, so "first
// index" is still the original order.  Each entry's dot is one fmaf chain
// over k = 0 .. 32 in order from 0, which is the arithmetic of the earlier
// two-pass lane_mutual.cu and of nn_wide.cuh; the callers end it as those
// did, so a valid entry keeps its bits.
//
// Layout.  A tile is staged transposed, sh[k * kStride + c] = row c's
// feature k, so that a thread reads its 8 rows (or 8 columns) of feature k
// as two float4 broadcasts.  Thread (ty, tx) = (tid / 16, tid % 16) holds
// the 8 x 8 entries of rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3} and
// the same columns of tx: each k then costs 4 shared loads for 64 FMAs, and
// the 8 threads of a load phase read 8 consecutive float4s (no bank
// conflict).  The stride kTile + 8 keeps the staging stores free of bank
// conflicts too: a warp copies 4 features x 8 rows, and rows k and k + 1
// sit 8 banks apart.
//
// Copies are cp.async, 4 bytes an element (a 33-float row is 4-byte
// aligned only), and the target tiles are double-buffered: tile t + 1 is in
// flight while tile t is computed, one barrier a tile (sweep_targets).  A
// tile position past the list gets zero features and an infinite norm:
// every entry it makes is +inf, never below a minimum.
//
// Chosen on the H100 with the ptxas report and timed variants (PERF.md):
// 8 x 8 entries a thread take 127 registers, two blocks an SM, no spills.
// The fully unrolled k loop ran ahead of unrolling it by 11, 3 or 1, ahead
// of one block an SM, of two barriers a tile and of a row update that took
// the minimum of 8 entries first; three target buffers (18 KB more shared
// memory) and a warp of 4 x 8 threads (fewer distinct float4s a load) ran
// about as fast.
//
// Dynamic shared memory over 48 KB: the entry points set the kernel's
// cudaFuncAttributeMaxDynamicSharedMemorySize before launching.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "compact.cuh"

namespace fpfh {

constexpr int kD = 33;                      // FPFH width
constexpr int kThreads = 256;               // 16 x 16 threads, 8 x 8 entries each
constexpr int kTile = 128;                  // query rows of a tile, target rows of a tile
constexpr int kHalf = kTile / 2;
constexpr int kStride = kTile + 8;          // floats a staged feature row
constexpr int kTileFloats = kD * kStride;   // one staged tile
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;               // the part of a masked query row (ops/nn.py:BIG)
static_assert(kTile == 16 * 8, "16 threads x 8 rows span a tile");
static_assert((kTile / 8) % kWarps == 0, "a warp stages whole groups of 8 rows");
static_assert((kTileFloats * 4) % 16 == 0, "tiles stay float4 aligned");

// A float's bits as an int whose signed order is the float's order (NaN
// aside), so a shared-memory atomicMin on ints takes a float minimum.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Position in a tile of a thread's row (or column) e = 0 .. 7.
__device__ __forceinline__ int tile_pos(int t, int e) {
  return (e >> 2) * kHalf + t * 4 + (e & 3);
}

// Stage rows order[first + c], c < kTile, of rows [*, kD] transposed into
// sh, and their squared norms sq[order[first + c]] into sq_sh[c] (skipped
// for a null sq_sh); positions at or past count get zero features and an
// infinite norm.  Issues cp.async copies: the caller commits them.
__device__ __forceinline__ void stage_tile(float* __restrict__ sh, float* __restrict__ sq_sh,
                                           const float* __restrict__ rows,
                                           const float* __restrict__ sq,
                                           const int* __restrict__ order, int first, int count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane >> 3;  // feature k0 + kq of a group of four
#pragma unroll
  for (int h = 0; h < kTile / 8 / kWarps; ++h) {
    const int c = (warp + h * kWarps) * 8 + (lane & 7);
    const int s = first + c;
    if (s < count) {
      const float* src = rows + static_cast<size_t>(order[s]) * kD;
#pragma unroll
      for (int k0 = 0; k0 < kD; k0 += 4) {
        if (k0 + kq < kD) cp_async4(sh + (k0 + kq) * kStride + c, src + k0 + kq);
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kD; k0 += 4) {
        if (k0 + kq < kD) sh[(k0 + kq) * kStride + c] = 0.f;
      }
    }
  }
  if (sq_sh != nullptr && threadIdx.x < kTile) {
    const int s = first + threadIdx.x;
    if (s < count) {
      cp_async4(sq_sh + threadIdx.x, sq + order[s]);
    } else {
      sq_sh[threadIdx.x] = CUDART_INF_F;
    }
  }
}

// acc[a][b] = the dot of query row tile_pos(ty, a) of qs with target row
// tile_pos(tx, b) of ts: one fmaf chain over k in order, from 0.
__device__ __forceinline__ void tile_dot(const float* __restrict__ qs, const float* __restrict__ ts,
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    const float4 q0 = *reinterpret_cast<const float4*>(qs + k * kStride + ty * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(qs + k * kStride + kHalf + ty * 4);
    const float4 t0 = *reinterpret_cast<const float4*>(ts + k * kStride + tx * 4);
    const float4 t1 = *reinterpret_cast<const float4*>(ts + k * kStride + kHalf + tx * 4);
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = __fmaf_rn(qv[a], tv[b], acc[a][b]);
  }
}

// Eight values of a staged norm array at a thread's rows (or columns).
__device__ __forceinline__ void load8(const float* __restrict__ sq_sh, int t, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(sq_sh + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(sq_sh + kHalf + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// A row's running (min, first argmin) over the values d[0 .. 7] of columns
// tile_pos(tx, b) + first, which ascend in b: strict `<`, so the smaller
// index keeps a tie.
__device__ __forceinline__ void row_update(const float (&d)[8], int tx, int first, float& best,
                                           int& best_j) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (d[b] < best) {
      best = d[b];
      best_j = first + tile_pos(tx, b);
    }
  }
}

// Merge the running bests of the 16 threads (a half-warp) that share a
// row: the smaller value, then the smaller index.
__device__ __forceinline__ void row_merge(float& best, int& best_j) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov < best || (ov == best && oj < best_j)) {
      best = ov;
      best_j = oj;
    }
  }
}

// Sweep the staged query tile qs over every target tile of the list
// tj[0 .. nvb): t_rows / t_sq are the lane's target rows and norms; ts and
// tsq hold two tiles each.  The caller has issued the query tile's copies
// (committed or not): the first tile's wait covers them.  For each tile, in
// target order: epi(acc, tsq of the tile, first list position of the tile).
// Tile t + 1 is copied while tile t is computed, into the buffer of tile
// t - 1: one barrier a tile.
template <class Epi>
__device__ __forceinline__ void sweep_targets(const float* __restrict__ qs, float* __restrict__ ts,
                                              float* __restrict__ tsq,
                                              const float* __restrict__ t_rows,
                                              const float* __restrict__ t_sq,
                                              const int* __restrict__ tj, int nvb, Epi&& epi) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_tiles = (nvb + kTile - 1) / kTile;
  stage_tile(ts, tsq, t_rows, t_sq, tj, 0, nvb);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // everyone's copies, and everyone is done with tile t - 1
    if (t + 1 < n_tiles) {
      stage_tile(ts + (buf ^ 1) * kTileFloats, tsq + (buf ^ 1) * kTile, t_rows, t_sq, tj,
                 (t + 1) * kTile, nvb);
      cp_async_commit();
    }
    float acc[8][8];
    tile_dot(qs, ts + buf * kTileFloats, ty, tx, acc);
    epi(acc, tsq + buf * kTile, t * kTile);
  }
  __syncthreads();  // the caller may restage qs and ts
}

}  // namespace fpfh
