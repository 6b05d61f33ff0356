// Mutual nearest neighbour over 33-D FPFH features per pair lane.
//
// Replaces the TPU kernel tpu3dm/ops/nn_lane.py:_lane_mutual_kernel (the
// correspondence stage of registration/fused.py with nn_impl="lane").
//
// For pair lane b, query row i (features a_i) and target column j (b_j):
//   d2(i, j) = fmaf(-2, a_i . b_j, asq[i] + bsq[j])
// with asq / bsq the squared norms (BIG, 1e30, at masked rows and columns)
// and the dot one fmaf chain over k = 0 .. 32.  Per valid query row the
// outputs are idx = the first argmin over j of d2(i, j) and mutual =
// d2(i, idx) <= colmin[idx], colmin[j] = min_i d2(i, j) over EVERY query row
// of the lane; a masked row gets idx 0 and mutual false.  Always fp32, as
// the TPU kernel is.
//
// Two more routes of the same kernel serve the JAX package's XLA
// correspondence searches of registration/fused.py (ops/nn.py:
// nn_mutual_mask and nn_mutual_vals, which no Pallas kernel computes):
//   - approx (bf16 feature inputs, fp32 accumulation): the wrapper passes
//     bf16-rounded features in fp32 tensors and the norms of the unrounded
//     ones.  A product of two bf16 values is exact in fp32, so the fmaf
//     chain is that dot, summed in this kernel's order;
//   - t3t_lane_mutual_bf16_cross (nn_impl="values_b16": the cross stored as
//     bf16): the dot is rounded to bf16 (to nearest even) before its
//     fmaf(-2, ., asq + bsq).  Doubling a bf16 value is exact, so the entry
//     is (asq + bsq) - 2 bf16(dot) with one rounding, as JAX computes it.
//
// The TPU kernel gets global column minima by keeping a whole lane resident
// in VMEM.  Here one block owns one lane, so its column minima are exact
// without a second pass or global atomics:
//   - it lists the lane's valid query rows and valid target rows in index
//     order (compact.cuh:list_rows) and computes only those entries:
//     a masked query row's entries are >= BIG - 2 |a||b| and cannot lower a
//     valid column's minimum, and a masked column never wins a row.  A lane
//     with no valid target lists every target instead (their bsq is BIG),
//     so the biased entries decide there, as in the plain version;
//   - it loops over tiles of 128 listed query rows, and for each sweeps
//     every tile of 128 listed targets (fpfh_tile.cuh:sweep_targets: 8 x 8
//     entries a thread, the next target tile copied while this one is
//     computed).  Each entry is computed once and feeds both tests, so a
//     true mutual pair always passes d2(i, idx) <= colmin[idx];
//   - a row's (min, first argmin) stays in registers over the sweep, then
//     the 16 threads of the row merge it and write it to shared memory;
//   - a tile's column minima (over the thread's 8 rows, then the two rows
//     of threads of a warp) fold into colmin in shared memory by atomicMin
//     on order-preserving int bits (min is exact in any order);
//   - once every query tile is done, each valid row reads colmin at its
//     pick and writes idx and mutual.
// The lists (12 bytes a query row, 8 a target row) sit in shared memory
// beside the ~54 KB of tiles up to ~8,600 rows a side; a larger lane keeps
// them in a device-memory scratch that the wrapper allocates, so no row
// count is refused.
//
// What bounds it on the H100: operations.  At B = 2048, Na = Nb = 1024 and
// ~70% valid rows a side, ~1.06e9 valid entries of 35 fp32 instructions (33
// FMAs, the norms' add, the -2 scale's FMA) against ~0.3 GB of valid rows.
// Each entry is computed once, for its row and its column alike, and only
// listed rows are: ~1.15x the valid entries (tiles of 128 listed rows)
// where two passes over every entry would compute ~4x.  An entry costs its
// 35 instructions, two minima and 1/16 of a shared load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fpfh_tile.cuh"

namespace {

using namespace fpfh;

// 4-byte words of a lane's lists: a listed row's best d2 and pick, the
// listed query rows, the listed targets and the column minima.
__host__ __device__ constexpr size_t list_words(int Na, int Nb) {
  return 3 * static_cast<size_t>(Na) + 2 * static_cast<size_t>(Nb);
}

// Dynamic shared memory: the query tile, two target tiles and their norms,
// then (without a scratch) the lane's lists.
__host__ __device__ constexpr size_t smem_bytes(size_t words) {
  return 4 * (3 * static_cast<size_t>(kTileFloats + kTile) + words);
}

// A dot as the bf16 cross stores it: rounded to bf16, to nearest even.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kScratch: the lists live in scratch [B, list_words] in device memory
// (lanes whose lists do not fit in shared memory), else in shared memory.
// kCrossBf16: round each dot to bf16 before its entry is formed.
template <bool kScratch, bool kCrossBf16>
__global__ void __launch_bounds__(kThreads, 2)
lane_mutual_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ asq, const float* __restrict__ bsq,
                   const unsigned char* __restrict__ mask_a,
                   const unsigned char* __restrict__ mask_b, int* __restrict__ idx_out,
                   unsigned char* __restrict__ mutual_out, int* __restrict__ scratch, int Na,
                   int Nb) {
  extern __shared__ float4 dyn[];
  float* qs = reinterpret_cast<float*>(dyn);    // [kTileFloats] the query tile
  float* ts = qs + kTileFloats;                 // [2][kTileFloats] target tiles
  float* qsq = ts + 2 * kTileFloats;            // [kTile]
  float* tsq = qsq + kTile;                     // [2][kTile]
  float* rbest = kScratch                       // [Na] a listed row's best d2
      ? reinterpret_cast<float*>(scratch + blockIdx.x * list_words(Na, Nb))
      : tsq + 2 * kTile;
  int* rpick = reinterpret_cast<int*>(rbest + Na);  // [Na] its target list position
  int* qi = rpick + Na;                         // [Na] listed query rows
  int* tj = qi + Na;                            // [Nb] listed targets
  int* colkey = tj + Nb;                        // [Nb] colmin as order_key bits
  __shared__ int warp_counts[kWarps];

  const size_t lane = blockIdx.x;
  const float* la = a + lane * Na * kD;
  const float* lb = b + lane * Nb * kD;
  const float* lasq = asq + lane * Na;
  const float* lbsq = bsq + lane * Nb;
  const unsigned char* lma = mask_a == nullptr ? nullptr : mask_a + lane * Na;
  const unsigned char* lmb = mask_b == nullptr ? nullptr : mask_b + lane * Nb;
  int* lidx = idx_out + lane * Na;
  unsigned char* lmut = mutual_out + lane * Na;
  const int tid = threadIdx.x;

  if (lma != nullptr) {
    for (int i = tid; i < Na; i += kThreads) {
      if (!lma[i]) {
        lidx[i] = 0;
        lmut[i] = 0;
      }
    }
  }
  const int nva = list_rows(lma, Na, 0, Na, qi, warp_counts);
  int nvb = list_rows(lmb, Nb, 0, Nb, tj, warp_counts);
  if (nvb == 0) {  // no valid target: every target, at its BIG norm
    for (int j = tid; j < Nb; j += kThreads) tj[j] = j;
    nvb = Nb;
  }
  for (int j = tid; j < Nb; j += kThreads) colkey[j] = order_key(CUDART_INF_F);
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;
  const bool col_writer = (tid & 31) < 16;  // one of the warp's two rows of threads
  for (int q0 = 0; q0 < nva; q0 += kTile) {
    stage_tile(qs, qsq, la, lasq, qi, q0, nva);
    float best[8];
    int best_j[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      best[e] = CUDART_INF_F;
      best_j[e] = 0;
    }
    sweep_targets(qs, ts, tsq, lb, lbsq, tj, nvb,
                  [&](float (&acc)[8][8], const float* tsq_t, int first) {
      float qn[8], tn[8];
      load8(qsq, ty, qn);
      load8(tsq_t, tx, tn);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float dot = kCrossBf16 ? bf16_round(acc[r][c]) : acc[r][c];
          acc[r][c] = __fmaf_rn(-2.0f, dot, __fadd_rn(qn[r], tn[c]));
        }
        row_update(acc[r], tx, first, best[r], best_j[r]);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float m = acc[0][c];
#pragma unroll
        for (int r = 1; r < 8; ++r) m = fminf(m, acc[r][c]);
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        const int j = first + tile_pos(tx, c);
        if (col_writer && j < nvb) atomicMin(colkey + j, order_key(m));
      }
    });
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      row_merge(best[r], best_j[r]);
      const int s = q0 + tile_pos(ty, r);
      if (tx == 0 && s < nva) {
        rbest[s] = best[r];
        rpick[s] = best_j[r];
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < nva; s += kThreads) {
    const int i = qi[s], p = rpick[s];
    lidx[i] = tj[p];
    lmut[i] = rbest[s] <= key_value(colkey[p]) ? 1 : 0;
  }
}

// The host side of both entry points: kCrossBf16 picks the route.
template <bool kCrossBf16>
int launch_mutual(const float* a, const float* b, const float* asq, const float* bsq,
                  const unsigned char* mask_a, const unsigned char* mask_b, int* idx,
                  unsigned char* mutual, int* scratch, int B, int Na, int Nb,
                  cudaStream_t stream) {
  if (B <= 0 || Na <= 0 || Nb <= 0) return static_cast<int>(cudaSuccess);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(scratch == nullptr ? list_words(Na, Nb) : 0);
  if (smem + 64 > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scratch == nullptr ? lane_mutual_kernel<false, kCrossBf16>
                                   : lane_mutual_kernel<true, kCrossBf16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, stream>>>(a, b, asq, bsq, mask_a, mask_b, idx, mutual, scratch, Na,
                                        Nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [B, Na, 33], b [B, Nb, 33], asq [B, Na], bsq [B, Nb] float32, contiguous,
// the norms BIG at masked rows; mask_a [B, Na] and mask_b [B, Nb] bool (one
// byte each; null: every row valid); scratch null, or int32 [B, 3 Na + 2 Nb]
// for lanes whose lists do not fit in shared memory (12 bytes a query row
// and 8 a target row besides ~54 KB of tiles).  Writes idx [B, Na] int32
// and mutual [B, Na] bool.  One block a lane; launches on ``stream`` and
// returns cudaGetLastError(), or cudaErrorInvalidValue where the lists do
// not fit in shared memory and no scratch is given.
extern "C" int t3t_lane_mutual(const float* a, const float* b, const float* asq, const float* bsq,
                               const unsigned char* mask_a, const unsigned char* mask_b, int* idx,
                               unsigned char* mutual, int* scratch, int B, int Na, int Nb,
                               cudaStream_t stream) {
  return launch_mutual<false>(a, b, asq, bsq, mask_a, mask_b, idx, mutual, scratch, B, Na, Nb,
                              stream);
}

// The same contract, each dot rounded to bf16 before its entry is formed.
extern "C" int t3t_lane_mutual_bf16_cross(const float* a, const float* b, const float* asq,
                                          const float* bsq, const unsigned char* mask_a,
                                          const unsigned char* mask_b, int* idx,
                                          unsigned char* mutual, int* scratch, int B, int Na,
                                          int Nb, cudaStream_t stream) {
  return launch_mutual<true>(a, b, asq, bsq, mask_a, mask_b, idx, mutual, scratch, B, Na, Nb,
                             stream);
}
