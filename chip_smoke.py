"""Drive tpu3dm_torch's main path on one NVIDIA GPU and hold every kernel
against its plain PyTorch version.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ok line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of tpu3dm_torch/csrc (one nvcc per source) and
     its host C++ library (the host compiler), all started together;
  3. preprocess the 8 benchmark pairs (make_benchmark_pair(20000, seed=s,
     sigma=0.01), s = 0..7) on the card, pad them to the shared capacity
     and tile them to 2048 pair lanes, as bench.py does; the full-resolution
     normals of the 16 clouds timed on their own (CUDA events), and those
     of lanes 0-3's source clouds against the same on the CPU;
  4. each kernel against its plain version at the main path's shapes (2048
     lanes, M = N = 1024, K = 4096), every lane jittered and thinned on its
     own so that no two lanes hold the same data, with kernel, plain and
     library-yardstick times and each kernel's bound (a kernel redesigned in
     this round also prints its parent commit's time, from PERF.md, beside
     its own): kernels 1-2, kernel 7
     (the 33-D forward NN of path C; 2 and 7 also timed as the launch alone,
     without the wrapper's norms), kernel 1 at the rescue's verification
     shape (VERIFY_CANDIDATES moved sources a lane), both bit-equal to the
     plain version, and the score's bf16 tensor-core route on bf16 H and F
     (counts inside the float64 bracket of its rounding, >= 99.9% equal,
     never more than 1 apart), then its fp32 route on the same values in
     fp32 tensors (the "ransac_score" row, as this path ran it before);
     kernel 2 on bf16-rounded features with the fp32 norms (path E's
     search, row "lane_mutual_approx") and its bf16-cross entry on the same
     (path F4's, "lane_mutual_bf16_cross"), both bit-equal to their plain
     versions (an in-order sum of exact products); the score's fp32 route at
     the rescore shape (128 fp32 hypotheses a lane over all 1024 rows, row
     "ransac_score_rescore", inside the fp32 float64 bracket); the
     ordered-row-sum kernel (row "row_sums", a port-only repair) at the
     ICP's [2048, 27, 1024] rows, bit-equal to its plain version;
  5. the main path: fused_register_step over the 2048 lanes (4096
     hypotheses, 8 point-to-plane ICP iterations with 4 solves per NN
     search, bf16 score), launch counts zeroed just before and read just
     after (2 lane_nn_smalld, 1 lane_mutual, 1 bf16 score); every lane
     gated (rotation < 2 deg, RMSE < 0.1 against its T_true); 4 lanes
     checked against the same step on the CPU; pairs/s and stage times;
  6. one profiled step: the device's busy and idle share, ops by name;
  6b. path C: the same step with mutual_filter=False and the batched alias
     rescue (3 restarts, 6 modes, 8 verification solves), launch counts
     zeroed just before and read just after, every lane gated, lanes 0-3
     against the CPU, pairs/s, stage times, peak memory, one profiled step;
     path D: the rescue with the mutual filter, gated and timed once;
  6c. path E, the new main path: fused_register_step over the same 2048
     lanes at bench.py's settings (the default nn_impl "values_pk": bf16
     feature cross, f16 ICP payload; approx_features, bf16 score, 4096
     hypotheses, 8 ICP iterations / 4 solves a search), launch counts zeroed
     just before and read just after (1 lane_mutual, 2 lane_nn_smalld, 1 bf16
     score), every lane gated, lanes 0-3 against the CPU, pairs/s (median of
     3), stages, peak memory, one profiled step;
     path F, batch.py's options on the same lanes, each step counted and
     gated: F1 two-stage scoring (score_subset=256, rescore_top=128: the bf16
     score at the subset shape, then the fp32 route at [2048, 128, 1024]),
     F2 sample_mode="gather", F3 the rescue (3 restarts) on values_pk, F4
     nn_impl="values_b16" (kernel 2's bf16-cross entry);
  6d. path G: ransac_pair_step with the adaptive budget (4096 + up to 12288
     hypotheses) on 256 lanes whose correspondences are shuffled to ~10%
     inliers: extra chunks run (> 0 required), lanes 0-3 against the CPU
     with the same extra bits;
     path H: escalated_register_step on 256 lanes at the stream's settings
     (8 modes, 4096 + up to 12288 hypotheses, 149 probes a lane with path
     E's poses as init_T, turned 90 deg about z on the odd lanes so their
     election must drop the init_T probe), counted, gated, lanes 0-1
     against the CPU;
  6d'. paths Q1 and Q5 (batched), the pair-sharded mesh (parallel/): Q1
     batched_register over the main path's 2048 lanes at bench's settings
     (4096 hypotheses, 8 ICP iterations / 4 solves a search, bf16 score,
     values_pk with fp32 features: JAX's knobs) on meshes of 1, 2 and 4
     pair shards on the card (the device repeated), counted, every pair
     bit-equal across the meshes and to a direct fused_register_step on the
     same bits, every lane gated, pairs/s for each mesh; Q5 batched_ransac on
     the 4x1 mesh over the same lanes' correspondences (the fp32 score),
     counted, bit-equal to one ransac_pair_step over all lanes; Q6 (with
     several cards) Q1 with a shard a card, else one line saying so;
  6e. path I, the batch API (registration/batch.py) at bench.py's
     distinct-pair width: I1 preprocess_points_batch of the 16 clouds
     (full_normals=False), cold and warm, each cloud's down normals and
     features bit-equal to phase 3's per-cloud preprocess_points where the
     capacities match (inside the CPU tests' bounds elsewhere), clouds 0-1
     against the CPU; I2 register_pairs_batched over the 8 pairs tiled to
     2048 (bucket_multiple 256, batch.py's defaults: 4096 hypotheses, 8 ICP
     iterations / 2 solves a search, bf16 score, values_pk), launch counts
     zeroed before and read after each bucket (1 lane_mutual, 4
     lane_nn_smalld, 1 bf16 score), every pair gated, pairs 0-3 against the
     CPU, pairs 0-7 alone against the whole call, pairs/s (median of 3
     resolved calls), launch against resolve time, peak memory; I3
     register_sources_to_target: 8 moved, re-noised copies of pair 0's
     source tiled to 2048 against one ResidentTarget, gated, equal to
     register_pairs_batched on the same pairs and bits; I4 checkpoint
     resume of 64 pairs (no launch), the device voxel grid equal to the
     host grid, noise sigma 0.05 (padding rows 0), down_features_dense on
     the 16 clouds against the CPU; Q2 I2's call again over a 4x1 mesh,
     counted, bit-equal to I2;
  6f. path S, the disk-to-result stream (registration/stream.py) at
     bench.py's stream settings: S1 stream_register_pairs over a fresh
     384-pair manifest cycling the arch, plate and scan families (20,000
     points, sigma 0.01, written to a temporary directory and removed),
     fuse_device=True, window 128, down_cap 896, 4096 hypotheses, 8 ICP
     iterations / 4 solves a search, bf16 score, 3 rescue restarts, the
     symmetry-probe retry with measure_warm; launch counts zeroed before and
     read after (kernels 1, 2 and the bf16 score > 0 required), each
     window's time and host ingest, steady and fresh pairs/s, the retry's
     pairs and seconds, peak memory, stream_quality (its gate required) and
     the gate per family, then S1 again without the retry (each pair over
     2 deg before or after the retry); S2 the first 128 pairs at window 64,
     equal to S1 within 1e-6; S3 the first 32 pairs on the generic path,
     within 0.5 deg and 0.02 of S1; S4 pairs 0-2 on the CPU with the same
     bits, within the CPU agreement limit; S5 window 1's 256 clouds: batched
     dense features equal to per-cloud ones bit for bit, both timed; then
     measure_fused_device_rate and one profiled window;
  6g. path V, the serving tier (serve/): a RegistrationServer on loopback
     port 0 at ServeConfig() on the card, prewarmed at caps 768 and 1024,
     takes 512 requests from 8 client threads (half inline base64 pairs of
     the 8 benchmark pairs, half path specs of 16 moved copies of pair 0's
     source against that source as one shared target PLY), at
     pipeline_depth 0 and then 1: every response ok and gated, req/s,
     latency p50 / p95, queue / pack / device ms, micro-batch size,
     shared-target requests and launches a micro-batch (kernels 1, 2, the
     bf16 score and row_sums > 0 required); the engine alone on the same
     requests (8 waiting clients, then all at once) and one profiled
     micro-batch; request 0 alone bit-equal to request 0 of a 128-request
     flood; Q2 64 of the flood's requests through ServeEngine(mesh=4x1),
     counted, none on the resident route, every response ok and gated, the
     inline requests bit-equal to the same requests without the mesh;
  6h. path P, the single-pair pipeline: register_files on pair 0's two
     PLYs at voxel 0.3 with restarts 1 and 4, cold and warm, launch counts
     zeroed before and read after each call (the fp32 score and kernel 4
     > 0 required), the profiler's stage times, each call gated; restarts
     1 again on the CPU with the same bits, within the CPU limit; Q5
     sharded_ransac (100,000 hypotheses, the fp32 score) on a 1x4 block
     mesh over the same pair's correspondences, counted, its pose refined by
     P's ICP and gated;
  6j. paths M1-M3, multi-way registration (multiway/posegraph.py) at
     run_multiway_benchmark's settings: M1 256 views of a 20,000-point arch
     (rand_T(k), sigma 0.01), preprocess_points_batch(full_normals=False)
     at voxel 0.3, register_multiway_batched over the 256 chain + loop
     edges (chunks of 128, rescue_restarts 2, robust_delta 0.1, 20
     edgewise pose-graph iterations), one cold and three warm calls with
     one bit set, launch counts zeroed before the first warm call and read
     after it (kernels 1, 2, the bf16 score and row_sums > 0 required),
     warm s and edges/s, the pose graph's share of a call, every edge gated
     (< 2 deg against its true relative transform), edges 0-3 against the
     CPU, the pose graph solved on the CPU from the card's edges against
     the card's poses, edge 0 alone bit-equal to edge 0 in its chunk, the
     warm calls bit-equal; M2 the same on the first 16 views (the dense
     jacfwd solve), every pose gated too, one profiled call; M3
     register_multiway on 4 views with full-resolution normals into a
     checkpoint directory, one edge record deleted, run again, bit-equal
     (the fp32 score and kernel 4 > 0 required); Q2 M1's call again over
     a 4x1 mesh, counted, edges and poses bit-equal;
  6k. path R: preprocess_points_batch on the 16 clouds with the feature
     routes that skip the shared scan (both caps 0; fpfh_max_nn 0;
     normal_radius_mult 6), cold and warm, clouds 0-1 against the CPU;
  6l. path K: run_all_crash_tests on the card, all eight cases passing
     (the fp32 score > 0 required), then kernel 3's fp32 route against its
     plain version on every chunk the suite's RANSAC cases score;
  6m. the card tests (pytest --noconftest on tests/test_torch_kernels.py:
     the ordered-row-sum kernel bit-equal to its plain version, one pair of
     the fused step bit-equal at 1, 2, 8 and 128 pairs, the Horn refit at
     1-64 fits, the kNN features at 1, 16 and 256 clouds, the pose-graph
     solves' determinism, the crash suite, batched_register on four pair
     shards of one card bit-equal to one shard);
  7. the large-cloud path, register_arrays_large on make_benchmark_pair(
     1_000_000, seed=0, sigma=0.002) (bench.py's large phase): path A at
     voxel 0.3, path B at voxel 0.1, each twice (cold, warm) with the launch
     counts zeroed just before and read just after each call, each call
     gated as bench.py gates it (rotation < 2 deg, alignment RMSE < 0.01
     against T_true), then once more stage by stage; one profiled call of A;
  7b. Q3 ring_nn_search on a 1x4 block mesh on the card: d = 3 on path A's
     1,000,448-row clouds (kernel 4 in each of the 16 ring steps) and d = 33
     on 32,768 random features with 5% of the rows masked (kernel 5), each
     against nn_search on the whole arrays (every valid index equal, d2
     within rtol = atol = 1e-5) and one ring step's shape against the
     kernel's plain version; Q4 register_arrays_large(mesh=1x4) at path A's
     settings with the block-sparse ring (kernel 6, its first ring step
     against the plain version) and the dense ring (kernel 4), cold and
     warm, counted, gated, within MESH_LARGE_GAP of path A's pose; Q6 (with
     several cards) Q4 with a shard a card;
  8. kernels 3-6 against their plain versions at those paths' shapes: the
     fp32 RANSAC score of B's first hypothesis chunk (the
     "ransac_score_fp32_1lane" row: one lane, 4096 hypotheses, its
     correspondences, no bf16 rounding: the fp32 route, which paths A and B
     launch and the bf16 one never), the tiled 3-D search
     at 1,000,448 x 1024 (A's donor normals) and 8192 x 8192 (B's
     downsampled ICP, with its query mask), the tiled 33-D search at 8192 x
     8192 (B's forward FPFH search, with its query mask), the block-sparse
     search at 1,000,448 x 1,000,448 with the candidate table of A's first
     full-resolution ICP iteration; the fp32 score and the two searches
     with a query mask are also timed as the launch alone;
  9. path A at 40,000 points on the card and on the CPU (plain versions)
     with the same sample bits: rotation within 0.5 deg, translation 0.02;
 10. one JSON line of per-kernel numbers, a row per kernel and shape, each
     naming its shape (launches: kernels 1, 2 and the bf16 score from the
     fused step's counted call, the fp32 score's two rows and 4-6 from path
     B's warm call, 7 from path C's counted call, the approx and bf16-cross
     rows of kernel 2 from paths E and F4, the rescore row from F1; each
     row also lists its launches on every path, path I as "I" (I2's counted
     call, all buckets), "I3", "S" (S1's counted run), "V" (the depth-0
     flood), "P" and "P4" (path P's warm calls), "M1", "M2" (a warm call),
     "M3" (the first run), "R" (the three warm calls), "K" (the suite),
     and the mesh paths' counted calls "Q1", "Q2I", "Q2V", "Q2M", "Q3a",
     "Q3f", "Q4s", "Q4d", "Q5b", "Q5s" (and "Q6", "Q6s", "Q6d")), then the
     ok line, last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

LANES = 2048
PAIRS = 8
N_POINTS = 20_000
HYPOTHESES = 4096
ICP_ITERS = 8
ICP_SOLVES_PER_NN = 4
# Path I: batch.py's own default, 2 solves a search (4 searches a bucket).
BATCH_SOLVES_PER_NN = 2
# Path C / D: the rescue's production settings (bench.py's robustness config).
RESCUE_RESTARTS = 3
RESCUE_MODES = 6
VERIFY_ITERS = 8
# Candidates a lane verifies after the dedup: min(R * modes, modes + 4).
VERIFY_CANDIDATES = min(RESCUE_RESTARTS * RESCUE_MODES, RESCUE_MODES + 4)
# Paths E-H: bench.py's two-stage scoring knobs, the stream's escalation
# (stream.py: 8 modes, 4096 + up to 16384 hypotheses) and the adaptive
# budget's lanes.
SUBSET, RESCORE_TOP = 256, 128
ADAPT_ITERATIONS = 16384
HARD_LANES = 256
ESCALATION_MODES = 8
ALIAS_DEG = 90.0  # path H's odd lanes: init_T turned this far from path E's pose
KEEP_CORRESPONDENCES = 0.22  # path G: rows that keep their match; the rest shuffled
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): HBM3
# bandwidth; fp32 outside the tensor cores, 67 TFLOP/s counting an FMA as two
# flops, so fp32 instructions (an FMA, an add, a multiply, a subtraction each
# one) issue at half that rate; bf16 tensor cores with fp32 accumulation.
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2
PEAK_BF16_FLOPS = 989e12


# Kernel -> (its CUDA source, the TPU kernel it replaces).
SOURCES = {
    "lane_nn_smalld": ("tpu3dm_torch/csrc/lane_nn.cu", "tpu3dm/ops/nn_lane.py:74"),
    "lane_mutual": ("tpu3dm_torch/csrc/lane_mutual.cu", "tpu3dm/ops/nn_lane.py:135"),
    "ransac_score_bf16": ("tpu3dm_torch/csrc/ransac_score.cu", "tpu3dm/ops/ransac_score.py:124"),
    "ransac_score": ("tpu3dm_torch/csrc/ransac_score.cu", "tpu3dm/ops/ransac_score.py:124"),
    "ransac_score_fp32_1lane": ("tpu3dm_torch/csrc/ransac_score.cu",
                                "tpu3dm/ops/ransac_score.py:124"),
    "nn_tiled_smalld": ("tpu3dm_torch/csrc/nn_tiled.cu", "tpu3dm/ops/nn.py:138"),
    "nn_tiled_smalld_8192": ("tpu3dm_torch/csrc/nn_tiled.cu", "tpu3dm/ops/nn.py:138"),
    "nn_tiled_wide": ("tpu3dm_torch/csrc/nn_tiled.cu", "tpu3dm/ops/nn.py:169"),
    "nn_blocksparse": ("tpu3dm_torch/csrc/nn_blocksparse.cu", "tpu3dm/ops/nn_sparse.py:199"),
    "lane_nn_wide": ("tpu3dm_torch/csrc/lane_nn.cu", "tpu3dm/ops/nn_lane.py:100"),
    "lane_mutual_approx": ("tpu3dm_torch/csrc/lane_mutual.cu", "tpu3dm/ops/nn_lane.py:135"),
    "lane_mutual_bf16_cross": ("tpu3dm_torch/csrc/lane_mutual.cu",
                               "tpu3dm/ops/nn_lane.py:135"),
    "ransac_score_rescore": ("tpu3dm_torch/csrc/ransac_score.cu",
                             "tpu3dm/ops/ransac_score.py:124"),
}
# Kernels that replace no TPU kernel: (CUDA source, what the row's
# "replaces" says).  row_sums orders the fused step's row sums, a port-only
# repair of batch-size dependence (XLA's reductions on the TPU never had it).
PORT_ONLY_SOURCES = {
    "row_sums": ("tpu3dm_torch/csrc/row_sums.cu",
                 "none: port-only repair (the row sums of tpu3dm/registration/fused.py:127)"),
}
# A row that times a kernel at a second shape or on other inputs, and that
# kernel's name.
ROW_KERNEL = {"ransac_score_fp32_1lane": "ransac_score", "nn_tiled_smalld_8192": "nn_tiled_smalld",
              "lane_mutual_approx": "lane_mutual", "ransac_score_rescore": "ransac_score"}
# The path whose counted call gives a row its launches (other rows: their
# kernel's path in main's row_path, else the fused path).
ROW_PATH = {"lane_mutual_approx": "E", "lane_mutual_bf16_cross": "F4",
            "ransac_score_rescore": "F1"}
# Rows of the kernels redesigned last, and the time (ms) PERF.md section 6
# gives the commit before the redesign, on an NVIDIA H100 80GB HBM3 at 700 W.
# Printed beside the row's own time, never put into the kernels JSON line.
PARENT_MS = {"nn_tiled_wide": 0.4062, "ransac_score_fp32_1lane": 0.4431, "ransac_score": 10.0308}
# Launches of the fused step's counted call: the correspondence search, one
# score chunk (approx_score: bf16), one 3-D search every ICP_SOLVES_PER_NN
# iterations.
FUSED_LAUNCHES = {"lane_mutual": 1, "ransac_score_bf16": 1, "ransac_score": 0,
                  "lane_nn_smalld": -(-ICP_ITERS // ICP_SOLVES_PER_NN)}
LARGE_KERNELS = ("nn_tiled_smalld", "nn_tiled_wide", "nn_blocksparse")
# Path S: bench.py's stream phase (bench.py:487-517): a fresh mixed manifest
# of arch / plate / scan pairs, window 128, every cloud at down_cap 896.
STREAM_PAIRS = 384
STREAM_WINDOW = 128
STREAM_CAP = 896
STREAM_GENERIC_PAIRS = 32

# The large-cloud path: bench.py's large phase (make_benchmark_pair(1M, seed=0,
# sigma=0.002), block 512, w 8, 4 restarts, point-to-plane) at two voxel
# sizes, each with the kernels it must launch; its gate is bench.py's.
LARGE_POINTS = 1_000_000
LARGE_PATHS = (
    ("A", 0.3, ("ransac_score", "nn_tiled_smalld", "nn_blocksparse")),
    ("B", 0.1, ("ransac_score", "nn_tiled_smalld", "nn_tiled_wide", "nn_blocksparse")),
)
# Path V: the serving tier (serve/) at ServeConfig's defaults: SERVE_CLIENTS
# client threads send SERVE_REQUESTS requests, half inline pairs of the
# PAIRS benchmark pairs, half path specs of SERVE_SOURCES moved copies of
# pair 0's source against that source as one shared target PLY; then one
# request alone against the same request first in a SERVE_FLOOD flood.
SERVE_REQUESTS = 512
SERVE_CLIENTS = 8
SERVE_SOURCES = 16
SERVE_FLOOD = 128
SERVE_CAPS = [768, 1024]
SERVE_KERNELS = ("lane_mutual", "lane_nn_smalld", "ransac_score_bf16", "row_sums")
# Path P: register_files on two arch PLYs at voxel 0.3, restarts 1 and 4.
PIPELINE_RESTARTS = (1, 4)
PIPELINE_KERNELS = ("ransac_score", "nn_tiled_smalld")
# Paths M1-M3: multi-way registration at run_multiway_benchmark's settings
# (tpu3dm/apps/benchmark.py:384-476): 256 views (M1, the edgewise pose
# graph), 16 (M2, the dense one), and register_multiway on 4 (M3).
MULTIWAY_CLOUDS = 256
MULTIWAY_SMALL = 16
MULTIWAY_POINTS = 20_000
MULTIWAY_RESCUE = 2
MULTIWAY_ROBUST = 0.1
MULTIWAY_KERNELS = ("lane_mutual", "lane_nn_smalld", "ransac_score_bf16", "row_sums")
MULTIWAY_FULL_KERNELS = ("ransac_score", "nn_tiled_smalld")
RESUME_CLOUDS = 4
# The pose graph solved on the card and on the CPU from the same edges.
PG_AGREE_DEG, PG_AGREE_T = 1.0, 0.1
# Path R: configurations whose features run without the shared kNN scan.
FEATURE_ROUTES = (
    ("uncapped", {"normal_max_nn": 0, "fpfh_max_nn": 0}),
    ("fpfh_uncapped", {"fpfh_max_nn": 0}),
    ("unshared_capped", {"normal_radius_mult": 6.0}),
)
# Paths Q1-Q6: the device mesh (parallel/).  On one card a mesh repeats the
# device (make_mesh(n_pair, n_block, devices=[cuda:0] * k)), so the shard
# split, the ring shifts, the ordered sums and the election run for real;
# Q6 reruns Q1 and Q4 with a shard a card where the machine has several.
MESH_PAIR_SHAPES = ((1, 1), (2, 1), (4, 1))  # Q1's meshes
MESH_N = 4  # Q2's pair axis; Q3-Q5's block axis
MESH_SERVE_REQUESTS = 64  # Q2's serving engine
MESH_KERNELS = ("lane_mutual", "lane_nn_smalld", "ransac_score_bf16", "row_sums")
RING_FEATURES = 32_768  # Q3 at d = 33: 8192^2 entries a ring step on 4 shards
RING_MASKED = 0.05  # the share of masked rows of Q3's features
RING_TOL = 1e-5  # Q3's d2 bound: rtol = atol of JAX's own ring test (tests/test_parallel.py:43)
# Q4: the sharded refinement against path A's single-device one.  Both start
# from the same coarse pose (the same bits) and converge on the same 1M-point
# clouds to Open3D's 1e-6 fitness / RMSE test; they differ by the order of the
# ordered sums and, on the dense ring, by the exact search against the
# candidate-bounded one, so the poses may stop an iteration apart near the
# optimum.  A twentieth of the large gate (2 deg, 0.01) holds them.
MESH_LARGE_GAP_DEG, MESH_LARGE_GAP_T = 0.1, 5e-4
# The card tests of the batch-size repair and the mesh, run by pytest in the
# card-test phase.
CARD_TESTS = "row_sums or batch_size or cloud_count or pose_graph or crash or mesh"
LARGE_GATE_ROT_DEG = 2.0
LARGE_GATE_RMSE = 0.01
AGREE_POINTS = 40_000  # path A on the card against the CPU, same sample bits


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The larger of bytes over the memory rate and, for each (operations,
    peak rate) of ``work``, operations over that rate."""
    times = [n_bytes / PEAK_HBM_BYTES] + [ops / rate for ops, rate in work]
    return max(times) * 1e3, ("bytes" if times[0] >= max(times) else "operations")


def fused_gate(T_gpu, T_true, mu, M2):
    """bench.py's per-lane gate: rotation error (deg) and closed-form
    alignment RMSE over the source, for [B, 4, 4] poses."""
    T = T_gpu.double().cpu().numpy()
    if not (np.isfinite(T).all() and T.shape == T_true.shape):
        fail("non-finite or misshapen transforms")
    M = T[:, :3, :3] @ np.swapaxes(T_true[:, :3, :3], 1, 2)
    rot = np.degrees(np.arccos(np.clip((np.trace(M, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    A = T[:, :3, :3] - T_true[:, :3, :3]
    bb = T[:, :3, 3] - T_true[:, :3, 3]
    rmse = np.sqrt(np.maximum(
        np.einsum("bij,bjk,bik->b", A, M2, A) + 2 * np.einsum("bi,bij,bj->b", bb, A, mu)
        + (bb * bb).sum(1), 0.0))
    return rot, rmse


def apart(Ta, Tb):
    """Rotation (deg, from ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), exact near
    0) and largest translation gap between two [B, 4, 4] pose sets."""
    Ta, Tb = Ta.double().cpu().numpy(), Tb.double().cpu().numpy()
    fro = np.linalg.norm(Ta[:, :3, :3] - Tb[:, :3, :3], axis=(1, 2))
    rot = np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))
    return float(rot.max()), float(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max())


def profile_report(fn, label: str) -> None:
    """One profiled call of ``fn`` (torch.profiler): device busy and idle share
    of its device span, and the device ops that take the time, by name: the
    top 12 and every kernel of the port's own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"profile {label}: the profiler recorded no device ops; busy share not measured")
        return
    busy, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s0, s1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # The top 12, then the port's own kernels below them (csrc's __global__
    # functions all live in anonymous namespaces).
    shown = ranked[:12] + [kv for kv in ranked[12:] if kv[0].startswith("(anonymous namespace)::")]
    log(f"profile {label}: {len(spans)} device ops over a {span / 1e3:.2f} ms device span, "
        f"busy {busy / 1e3:.2f} ms ({busy / span:.1%}), idle {1 - busy / span:.1%}")
    for name, us in shown:
        log(f"  {us / 1e3:8.3f} ms {us / busy:6.1%}  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import tpu3dm_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 3

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.csrc import KERNELS, build, reset_launch_counts
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.ops import nn as tnn
    from tpu3dm_torch.ops import nn_lane, ransac_score
    from tpu3dm_torch.ops.compact import compaction_permutation
    from tpu3dm_torch.parallel.multipair import (
        draw_bits,
        f32_square,
        ransac_pair_step,
    )
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration import hypotheses as hyp
    from tpu3dm_torch.registration.fused import (
        _pn_center,
        fused_register_step,
        icp_polish,
        correspondences,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # --- 2. build ---------------------------------------------------------
    t0 = time.time()
    reports = build()
    log(f"build: {time.time() - t0:.1f} s for {sorted(reports) or 'cached libraries'}")
    for src, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    # --- 3. data ------------------------------------------------------------
    cfg = PipelineConfig.with_voxel_size(0.3)
    t0 = time.time()
    clouds, fulls, raw, trues, moments = [], [], [], [], []
    for s in range(PAIRS):
        sp, tp, T = make_benchmark_pair(N_POINTS, seed=s, sigma=0.01)
        ps, pt = preprocess_points(sp, cfg.preprocess), preprocess_points(tp, cfg.preprocess)
        clouds.append((ps.down, pt.down))
        fulls += [ps.full, pt.full]
        raw.append(sp)
        trues.append(T)
        moments.append((sp.mean(0), sp.T @ sp / sp.shape[0]))
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    cap = max(max(a.capacity, b.capacity) for a, b in clouds)
    counts = [int(c.mask.sum()) for pair in clouds for c in pair]
    log(f"preprocess: {2 * PAIRS} clouds in {ingest_s:.2f} s (first CUDA use included); "
        f"down counts {min(counts)}-{max(counts)}, shared capacity {cap}")
    full_normals_check(fulls, raw[:4], cfg.preprocess)
    del fulls

    def padded(which: int, attr: str) -> torch.Tensor:
        rows = []
        for pair in clouds:
            x = getattr(pair[which], attr)
            pad = torch.zeros((cap - x.shape[0],) + x.shape[1:], dtype=x.dtype, device=dev)
            rows.append(torch.cat([x, pad]))
        base = torch.stack(rows)
        return base.repeat((LANES // PAIRS,) + (1,) * (base.ndim - 1)).contiguous()

    attrs = ("points", "features", "mask", "normals")
    src = {a: padded(0, a) for a in attrs}
    tgt = {a: padded(1, a) for a in attrs}
    T_true = np.tile(np.stack(trues), (LANES // PAIRS, 1, 1))
    m_s = hyp.sample_row_count(cap, HYPOTHESES)
    bits = draw_bits((LANES, 1, m_s), torch.Generator().manual_seed(0))
    step_kw = dict(
        dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
        ransac_iterations=HYPOTHESES, ransac_batch=HYPOTHESES,
        icp_iterations=ICP_ITERS, icp_solves_per_nn=ICP_SOLVES_PER_NN,
        approx_score=True, approx_features=False, nn_impl="lane", rescue_restarts=0,
    )

    def run_step(lanes=slice(None), device=None, bits=bits, **kw):
        args = [d[a][lanes] for d in (src, tgt) for a in attrs]
        if device == "cpu":
            args = [x.cpu() for x in args]
        return fused_register_step(*args, bits[lanes], device=device, **{**step_kw, **kw})

    # --- 4. kernels against their plain versions ---------------------------
    # At the main path's shapes, all LANES lanes.  The lanes tile PAIRS pairs,
    # so each lane gets its own jitter and drops its own ~5% of points: a
    # kernel that reads another lane's data then disagrees with its plain
    # version.
    gen = torch.Generator(device=dev).manual_seed(1)

    def jitter(x: torch.Tensor, scale: float) -> torch.Tensor:
        return (x + scale * torch.randn(x.shape, generator=gen, device=dev)).contiguous()

    def thin(mask: torch.Tensor) -> torch.Tensor:
        return mask & (torch.rand(mask.shape, generator=gen, device=dev) > 0.05)

    def lane_counts(mask: torch.Tensor) -> torch.Tensor:
        return mask.sum(-1).double()

    results = {}

    # Kernel 1: 3-D NN, the ICP search at convergence (source moved by T_true).
    frame_c = _pn_center(tgt["points"], tgt["mask"])
    T_c = torch.as_tensor(T_true, dtype=torch.float32, device=dev).clone()
    T_c[:, :3, 3] += torch.einsum("bij,bj->bi", T_c[:, :3, :3], frame_c) - frame_c
    sm, tm = thin(src["mask"]), thin(tgt["mask"])
    tp = jitter(tgt["points"] - frame_c[:, None], 1e-3)
    q = jitter(se3.apply(T_c, src["points"] - frame_c[:, None]), 1e-3)
    d2k, idxk = nn_lane.nn_search_lane(q, tp, sm, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(q, tp, sm, tm)
    torch.cuda.synchronize()
    idx_agree = (idxk == idxp)[sm].float().mean().item()
    d2_err = (d2k - d2p).abs()[sm].max().item()
    if idx_agree < 1.0 or d2_err > 0.0:
        fail(f"lane_nn_smalld: picks equal on {idx_agree:.6%}, max |d2| error {d2_err:.3g} "
             f"(exact expected)")
    far = torch.where(tm[..., None], tp, torch.full_like(tp, 1e9))
    b, m, n = q.shape[0], q.shape[1], tp.shape[1]
    nq, nt = lane_counts(sm), lane_counts(tm)
    # Needed work: valid queries x valid targets, 9 fp32 instructions each (3
    # subtractions, 3 squares, 2 adds, the compare); bytes: valid rows, the
    # target mask, and d2 and idx of every query.
    results["lane_nn_smalld"] = dict(
        agree=idx_agree, max_abs_err=d2_err,
        ms=cuda_ms(lambda: nn_lane.nn_search_lane(q, tp, sm, tm), 10),
        plain_ms=cuda_ms(lambda: nn_lane.nn_search_lane_plain(q, tp, sm, tm), 2),
        library_ms=cuda_ms(lambda: torch.cdist(q, far).argmin(-1), 2),
        bound=bound_ms(12 * (nq.sum() + nt.sum()).item() + b * n + 8 * b * m,
                       (9.0 * (nq * nt).sum().item(), PEAK_FP32_OPS)),
        shape=f"{b} lanes x {m} queries x {n} targets, d 3",
    )
    del d2k, idxk, d2p, idxp, far

    # Kernel 2: mutual 33-D FPFH NN.
    fa, fb = jitter(src["features"], 0.05), jitter(tgt["features"], 0.05)
    idxk, mutk = nn_lane.nn_mutual_mask_lane(fa, fb, sm, tm)
    idxp, mutp = nn_lane.nn_mutual_lane_plain(fa, fb, sm, tm)
    torch.cuda.synchronize()
    agree = ((idxk == idxp) & (mutk == mutp))[sm].float().mean().item()

    def pick_d2(idx):  # float64 distance of each row to its pick
        g = torch.gather(fb.double(), 1, idx.long()[..., None].expand(-1, -1, 33))
        return ((fa.double() - g) ** 2).sum(-1)

    mut_err = (pick_d2(idxk) - pick_d2(idxp)).abs()[sm].max().item()
    if agree < 0.999:
        fail(f"lane_mutual disagrees with its plain version on {1 - agree:.4%} of rows")
    far = torch.where(tm[..., None], fb, torch.full_like(fb, 1e9))

    def mutual_library():
        d = torch.cdist(fa, far)
        idx = d.argmin(-1)
        return d.amin(-1) <= torch.gather(d.amin(-2), -1, idx)

    na, nb = fa.shape[1], fb.shape[1]
    # Needed work: valid rows x valid columns, 35 fp32 instructions each (33
    # FMAs, the norms' add, one FMA of the -2 scale); bytes: valid feature rows, both
    # masks, and idx and mutual of every row.
    results["lane_mutual"] = dict(
        agree=agree, max_abs_err=mut_err,
        ms=cuda_ms(lambda: nn_lane.nn_mutual_mask_lane(fa, fb, sm, tm), 5),
        plain_ms=cuda_ms(lambda: nn_lane.nn_mutual_lane_plain(fa, fb, sm, tm), 2),
        library_ms=cuda_ms(mutual_library, 2),
        bound=bound_ms(132 * (nq.sum() + nt.sum()).item() + b * (na + nb) + 5 * b * na,
                       (35.0 * (nq * nt).sum().item(), PEAK_FP32_OPS)),
        shape=f"{b} lanes x {na} x {nb}, d 33",
    )
    # The launch alone, on the wrapper's norms (two torch.sum passes over the
    # features, which the row's ms includes).
    asq, bsq = tnn._sq_norms(fa, sm), tnn._sq_norms(fb, tm)
    results["lane_mutual"]["launch_ms"] = cuda_ms(lambda: nn_lane.LANE_MUTUAL.launch(
        dev, fa.data_ptr(), fb.data_ptr(), asq.data_ptr(), bsq.data_ptr(), sm.data_ptr(),
        tm.data_ptr(), idxk.data_ptr(), mutk.data_ptr(), None, b, na, nb), 5)
    del idxk, mutk, idxp, mutp, far, asq, bsq

    # Kernel 2 on the inputs of the other routes: bf16-rounded features with
    # the fp32 features' norms (approx_features, path E) and the same with
    # the cross rounded to bf16 (values_b16, path F4).  Every product of
    # bf16 values is exact in fp32, so the plain version's in-order sum is
    # the kernel's fmaf chain: picks and masks must be equal.
    fa16, fb16 = tnn.bf16_round(fa), tnn.bf16_round(fb)
    far16 = torch.where(tm[..., None], fb16, torch.full_like(fb16, 1e9))

    def mutual_library_bf16():  # cdist on the rounded features
        d = torch.cdist(fa16, far16)
        idx = d.argmin(-1)
        return d.amin(-1) <= torch.gather(d.amin(-2), -1, idx)

    # Work: 35 fp32 instructions an entry as kernel 2; the bf16-cross entry
    # adds the rounding to bf16 and back (37).
    for row, cross, ops in (("lane_mutual_approx", False, 35.0),
                            ("lane_mutual_bf16_cross", True, 37.0)):
        def call(cross=cross):
            return nn_lane.nn_mutual_mask_batched(fa, fb, sm, tm, approx=True, cross_bf16=cross)

        def plain(cross=cross):
            return nn_lane.nn_mutual_lane_plain(fa, fb, sm, tm, approx=True, cross_bf16=cross)

        idxk, mutk = call()
        idxp, mutp = plain()
        torch.cuda.synchronize()
        agree = ((idxk == idxp) & (mutk == mutp))[sm].float().mean().item()
        if agree < 1.0 or not torch.equal(mutk, mutp):
            fail(f"{row}: picks and masks equal on {agree:.6%} of valid rows (bit-equal expected)")
        results[row] = dict(
            agree=agree, max_abs_err=(pick_d2(idxk) - pick_d2(idxp)).abs()[sm].max().item(),
            ms=cuda_ms(call, 5), plain_ms=cuda_ms(plain, 1),
            library_ms=cuda_ms(mutual_library_bf16, 2),
            bound=bound_ms(132 * (nq.sum() + nt.sum()).item() + b * (na + nb) + 5 * b * na,
                           (ops * (nq * nt).sum().item(), PEAK_FP32_OPS)),
            shape=f"{b} lanes x {na} x {nb}, d 33, bf16-rounded features"
                  + (", cross rounded to bf16" if cross else ""),
        )
        del idxk, mutk, idxp, mutp
    del fa16, fb16, far16

    # Kernel 7: the 33-D forward NN per lane (path C's correspondences), on
    # the same jittered, thinned features.
    d2k, idxk = nn_lane.nn_search_lane(fa, fb, sm, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(fa, fb, sm, tm)
    torch.cuda.synchronize()
    agree, excess = wide_pick_check(fa, fb, tm, sm, idxk, idxp)
    wide_err = (d2k - d2p).abs()[sm].max().item()
    if agree < 0.999 or excess > 0.0:
        fail(f"lane_nn_wide: picks equal on {agree:.4%} of rows, a pick {excess:.3g} beyond "
             f"the fp32 error bound of the float64 minimum")
    tsq = torch.where(tm, torch.sum(fb * fb, -1), 1e30)

    def wide_library():  # one tsq - 2 q.t product and its argmin, chunked over lanes
        for sl in tnn.lane_slices(b, na * nb):
            torch.baddbmm(tsq[sl, None, :], fa[sl], fb[sl].transpose(1, 2), alpha=-2.0).argmin(-1)

    # Needed work: valid rows x valid columns, 34 fp32 instructions each (33
    # FMAs, then one FMA of the -2 scale with |t|^2); bytes: valid feature
    # rows, the target mask, d2 and idx of every row.
    results["lane_nn_wide"] = dict(
        agree=agree, max_abs_err=wide_err,
        ms=cuda_ms(lambda: nn_lane.nn_search_lane(fa, fb, sm, tm), 5),
        plain_ms=cuda_ms(lambda: nn_lane.nn_search_lane_plain(fa, fb, sm, tm), 2),
        library_ms=cuda_ms(wide_library, 2),
        bound=bound_ms(132 * (nq.sum() + nt.sum()).item() + b * nb + 8 * b * na,
                       (34.0 * (nq * nt).sum().item(), PEAK_FP32_OPS)),
        shape=f"{b} lanes x {na} x {nb}, d 33",
    )
    # The launch alone, on the wrapper's tsq (the row's ms adds it and |q|^2).
    results["lane_nn_wide"]["launch_ms"] = cuda_ms(lambda: nn_lane.LANE_NN_WIDE.launch(
        dev, fa.data_ptr(), fb.data_ptr(), tsq.data_ptr(), sm.data_ptr(), tm.data_ptr(),
        d2k.data_ptr(), idxk.data_ptr(), b, na, nb, 33), 5)
    del d2k, idxk, d2p, idxp, tsq

    # Kernel 1 at the rescue's verification shape: VERIFY_CANDIDATES poses a
    # lane near the true one, each moving the lane's jittered source; the
    # C x M moved points are C x M query rows of the lane.
    cv = VERIFY_CANDIDATES
    xi = 0.02 * torch.randn((LANES, cv, 6), generator=gen, device=dev)
    Tv = se3.exp_se3(xi) @ T_c[:, None]
    qv = jitter(se3.apply(Tv, (src["points"] - frame_c[:, None])[:, None]).reshape(LANES, cv * m, 3),
                1e-3)
    d2k, idxk = nn_lane.nn_search_lane(qv, tp, None, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(qv, tp, None, tm)
    torch.cuda.synchronize()
    smv = sm.repeat(1, cv)
    v_agree = (idxk == idxp)[smv].float().mean().item()
    v_err = (d2k - d2p).abs()[smv].max().item()
    if v_agree < 1.0 or v_err > 0.0:
        fail(f"lane_nn_smalld at {cv} candidates a lane: picks equal on {v_agree:.6%}, "
             f"max |d2| error {v_err:.3g} (exact expected)")
    farv = torch.where(tm[..., None], tp, torch.full_like(tp, 1e9))

    def verify_library():
        for sl in tnn.lane_slices(b, cv * m * n):
            torch.cdist(qv[sl], farv[sl]).argmin(-1)

    v_ms = cuda_ms(lambda: nn_lane.nn_search_lane(qv, tp, None, tm), 10)
    v_plain = cuda_ms(lambda: nn_lane.nn_search_lane_plain(qv, tp, None, tm), 1)
    v_lib = cuda_ms(verify_library, 1)
    v_bound = bound_ms(12 * (cv * nq.sum() + nt.sum()).item() + b * n + 8 * b * cv * m,
                       (9.0 * cv * (nq * nt).sum().item(), PEAK_FP32_OPS))
    results["lane_nn_smalld"].update(
        ms_verification=v_ms, bound_ms_verification=v_bound[0],
        shape_verification=f"{b} lanes x {cv * m} queries ({cv} candidates) x {n} targets, d 3")
    log(f"kernel lane_nn_smalld at the verification shape ({LANES} lanes x {cv} candidates x {m} "
        f"queries against {n} targets): picks equal {v_agree:.6f}, max |d2| err {v_err:.3g}; "
        f"kernel {v_ms:.4f} ms, plain {v_plain:.4f} ms, library {v_lib:.4f} ms, bound "
        f"{v_bound[0]:.4f} ms ({v_bound[1]})")
    del d2k, idxk, d2p, idxp, qv, farv, Tv, xi, smv

    # Kernel 3: the RANSAC score of one 4096-hypothesis chunk, built from the
    # lanes' own correspondences as ransac_pair_step builds it (centred
    # correspondences, roll sampler, triangle-frame fits, H and F rounded to
    # bf16 tensors, as approx_score passes them: the bf16 route).
    qa, valid = correspondences(fa, fb, sm, tm, tp)
    p = jitter(src["points"] - frame_c[:, None], 1e-3)
    w = valid.float()[..., None]
    c0 = ((p + qa) * 0.5 * w).sum(-2) / w.sum(-2).clamp_min(1.0)
    p = torch.where(valid[..., None], p - c0[:, None], 0.0)
    qa = torch.where(valid[..., None], qa - c0[:, None], 0.0)
    ga, gb, gc = hyp.rolled_sample_gathers(
        bits[:, 0].to(dev), torch.cat([p, qa], -1), valid.sum(-1), HYPOTHESES,
        rank_to_idx=compaction_permutation(valid))
    R, t, _ = hyp.fit3_frames(ga[..., :3], gb[..., :3], gc[..., :3],
                              ga[..., 3:], gb[..., 3:], gc[..., 3:])
    H, e = hyp.hypothesis_features_planar(R, t)
    F, c = ransac_score.corres_features(p, qa)
    # Path F1's exact rescore: RESCORE_TOP fp32 hypotheses a lane over every row.
    H32, e32, F32 = H[:, :RESCORE_TOP].contiguous(), e[:, :RESCORE_TOP].contiguous(), F.contiguous()
    H = H.to(torch.bfloat16).contiguous()
    F = F.to(torch.bfloat16).contiguous()
    c, e, v = c.contiguous(), e.contiguous(), valid.contiguous()
    del qa, p, w, ga, gb, gc, R, t, fa, fb

    thr = f32_square(cfg.ransac.dist_thresh)
    ck = ransac_score.score_features(H, e, F, c, v, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, v, thr)
    sure, near = ransac_score.score_count_bracket(H, e, F, c, v, thr, ransac_score.BF16_MMA_REL)
    torch.cuda.synchronize()
    diff = (ck - cp).abs()
    exact = (diff == 0).float().mean().item()
    outside = int(((ck < sure) | (ck > sure + near)).sum())
    log(f"kernel ransac_score_bf16: {int((near > 0).sum())} hypotheses with entries within "
        f"BF16_MMA_REL of the threshold, {outside} kernel counts outside the float64 bracket")
    if diff.max().item() > 1 or exact < 0.999 or outside:
        fail(f"ransac_score_bf16: counts equal on {exact:.4%} of hypotheses, max difference "
             f"{diff.max().item()}, {outside} outside the float64 bracket")
    # The fp32 route on the same values in fp32 tensors, as this path ran it
    # before the bf16 route: the "ransac_score" row keeps that meaning.
    Hf, Ff = H.float(), F.float()
    cf = ransac_score.score_features(Hf, e, Ff, c, v, thr)
    torch.cuda.synchronize()
    f_diff = (cf - cp).abs()
    f_exact = (f_diff == 0).float().mean().item()
    if f_diff.max().item() > 1 or f_exact < 0.999:
        fail(f"ransac_score (fp32 route, bf16 values): max difference {f_diff.max().item()}")
    k, nn_ = H.shape[1], F.shape[1]
    Ft = Ff.transpose(-1, -2)

    def score_library():  # one fp32 [b, k, n] tensor (34 GB at full size), in place
        d2 = torch.baddbmm(c[:, None, :], Hf, Ft).add_(e[:, :, None])
        return d2.masked_fill_(~v[:, None, :], float("inf")).lt_(thr).sum(-1)

    nv = lane_counts(v).sum().item()
    # Needed work: every hypothesis x the lane's valid correspondences.  The
    # bf16 route: a bf16 tensor-core product with fp32 accumulation (16
    # multiply-adds, 32 flops) and an fp32 epilogue of three instructions
    # ((acc + c_n) + e_k, then the compare).  The fp32 route: 19 fp32
    # instructions (16 FMAs, the adds of c and e, the compare).  Bytes: H
    # (32 B a row in bf16, 64 in fp32), e and the counts in full, valid rows
    # of F and c, the mask.
    work = ((32.0 * k * nv, PEAK_BF16_FLOPS), (3.0 * k * nv, PEAK_FP32_OPS))
    library_ms = cuda_ms(score_library, 2)
    shape = f"{b} lanes x K {k} x N {nn_} ({nv:.0f} valid rows)"
    results["ransac_score_bf16"] = dict(
        agree=exact, max_abs_err=float(diff.max().item()),
        ms=cuda_ms(lambda: ransac_score.score_features(H, e, F, c, v, thr), 10),
        plain_ms=cuda_ms(lambda: ransac_score.score_features_plain(H, e, F, c, v, thr), 2),
        library_ms=library_ms,
        bound=bound_ms(b * k * (32 + 4 + 4) + 36 * nv + b * nn_, *work),
        shape=f"{shape}, bf16 H and F",
    )
    results["ransac_score"] = dict(
        agree=f_exact, max_abs_err=float(f_diff.max().item()),
        ms=cuda_ms(lambda: ransac_score.score_features(Hf, e, Ff, c, v, thr), 5),
        plain_ms=cuda_ms(lambda: ransac_score.score_features_plain(Hf, e, Ff, c, v, thr), 2),
        library_ms=library_ms,
        bound=bound_ms(b * k * (64 + 4 + 4) + 68 * nv + b * nn_, (19.0 * k * nv, PEAK_FP32_OPS)),
        shape=f"{shape}, fp32 H and F holding bf16 values",
    )
    r, rf = results["ransac_score_bf16"], results["ransac_score"]
    log(f"kernel ransac_score_bf16: bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); the fp32 "
        f"route on the same values in fp32 tensors{parent_note('ransac_score')}: kernel "
        f"{rf['ms']:.4f} ms, bound {rf['bound'][0]:.4f} ms ({rf['bound'][1]})")
    del H, e, F, Ft, Hf, Ff, ck, cp, cf, diff, f_diff, sure, near
    results["ransac_score_rescore"] = rescore_case(H32, e32, F32, c, v, thr)
    del H32, e32, F32, c, v
    results["row_sums"] = row_sums_case(dev, cap)
    torch.cuda.empty_cache()
    for name, r in results.items():
        launch = f" (the launch alone {r['launch_ms']:.4f} ms)" if "launch_ms" in r else ""
        log(f"kernel {name}{parent_note(name)}: agree {r['agree']:.6f}, "
            f"max abs err {r['max_abs_err']:.3g}; "
            f"{LANES} lanes: kernel {r['ms']:.4f} ms{launch}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")

    # --- 5. main path -----------------------------------------------------
    torch.cuda.reset_peak_memory_stats()  # the kernel phase's yardsticks are not the step's
    run_step()  # warm-up: allocator, cuBLAS handles, module loads
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    T_gpu, fit, rmse = run_step()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    if any(launches[k] != n for k, n in FUSED_LAUNCHES.items()):
        fail(f"the fused path launched {launches}, expected {FUSED_LAUNCHES}")

    mu = np.tile(np.stack([mo[0] for mo in moments]), (LANES // PAIRS, 1))
    M2 = np.tile(np.stack([mo[1] for mo in moments]), (LANES // PAIRS, 1, 1))
    rot, rmse_true = fused_gate(T_gpu, T_true, mu, M2)
    if rot.max() >= 2.0 or rmse_true.max() >= 0.1:
        fail(f"quality gate: worst lane rot {rot.max():.3f} deg, rmse {rmse_true.max():.4f}")

    ref_lanes = slice(0, 4)
    T_cpu, _, _ = run_step(ref_lanes, device="cpu")
    ref_rot, ref_t = apart(T_gpu[ref_lanes], T_cpu)
    if ref_rot >= 0.5 or ref_t >= 0.02:
        fail(f"GPU and CPU runs of lanes 0-3 differ: rot {ref_rot:.4f} deg, t {ref_t:.4g}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        run_step()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    step_s = float(np.median(times))

    # Stage times: the step's three stages, each ended by a synchronize.
    def staged():
        marks = [time.time()]
        fc = _pn_center(tgt["points"], tgt["mask"])
        sp_ = (src["points"] - fc[:, None]).contiguous()
        tp_ = (tgt["points"] - fc[:, None]).contiguous()
        qa, valid = correspondences(src["features"], tgt["features"], src["mask"],
                                           tgt["mask"], tp_)
        torch.cuda.synchronize()
        marks.append(time.time())
        Tr, _ = ransac_pair_step(sp_, qa, valid, bits, dist_thresh=cfg.ransac.dist_thresh,
                                 iterations=HYPOTHESES, batch_size=HYPOTHESES, approx_score=True)
        torch.cuda.synchronize()
        marks.append(time.time())
        icp_polish(Tr, sp_, src["mask"], tp_, tgt["mask"], tgt["normals"],
                   icp_thresh=cfg.icp.dist_thresh, icp_iterations=ICP_ITERS,
                   icp_solves_per_nn=ICP_SOLVES_PER_NN)
        torch.cuda.synchronize()
        marks.append(time.time())
        return np.diff(marks) * 1e3

    stages = np.median(np.stack([staged() for _ in range(3)]), axis=0)
    log(f"main path: {LANES} lanes ({PAIRS} pairs, cap {cap}), {HYPOTHESES} hypotheses, "
        f"{ICP_ITERS} ICP iterations / {ICP_SOLVES_PER_NN} solves per search: "
        f"step {step_s * 1e3:.1f} ms median of 3 -> {LANES / step_s:.1f} pairs/s "
        f"(counted run {first_s * 1e3:.1f} ms); stages: correspondences {stages[0]:.1f} ms, "
        f"ransac {stages[1]:.1f} ms, icp {stages[2]:.1f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"quality: worst lane rot {rot.max():.4f} deg, rmse {rmse_true.max():.5f}, "
        f"fitness min {fit.min().item():.3f}, icp rmse max {rmse.max().item():.4f}; "
        f"lanes 0-3 vs CPU: rot {ref_rot:.4f} deg, t {ref_t:.3g}; launches {launches}")

    # Device timeline of one step (torch.profiler): busy share, and the device
    # ops that take the time, summed by name.
    profile_report(run_step, "main path")

    # --- 6b. paths C and D: the batched alias rescue -------------------------
    torch.cuda.empty_cache()
    rescue_launches = rescue_paths(run_step, src, tgt, T_true, mu, M2, cfg, m_s)

    # --- 6c-6d. paths E-H: the default route, batch.py's options, the
    # adaptive budget and the escalation ---------------------------------------
    torch.cuda.empty_cache()
    values_launches, T_e = values_paths(src, tgt, T_true, mu, M2, cfg, step_kw, bits)
    torch.cuda.empty_cache()
    hard_launches = hard_paths(src, tgt, T_true, mu, M2, cfg, T_e)
    del T_e

    # --- 6n. paths Q1 and Q5 (batched): the pair-sharded mesh ----------------
    torch.cuda.empty_cache()
    mesh_launches = mesh_pair_paths(dev, cfg, src, tgt, bits, T_true, mu, M2)

    # --- 6e. path I: the batch API (registration/batch.py) -------------------
    del src, tgt
    torch.cuda.empty_cache()
    batch_launches = batch_paths(dev, cfg, clouds, trues, moments)

    # --- 6f. path S: the disk-to-result stream (registration/stream.py) ------
    torch.cuda.empty_cache()
    stream_launches = stream_paths(dev, cfg)

    # --- 6g-6h. paths V and P: the serving tier and the single-pair pipeline --
    torch.cuda.empty_cache()
    serve_launches = serve_paths(dev, cfg)
    torch.cuda.empty_cache()
    pipeline_launches = pipeline_paths(dev, cfg)

    # --- 6j-6l. paths M1-M3, R and K: multi-way registration, the feature
    # routes without the shared scan, the crash suite ----------------------------
    torch.cuda.empty_cache()
    multiway_launches = multiway_paths(dev, cfg)
    torch.cuda.empty_cache()
    route_launches = feature_route_paths(dev, cfg)
    crash_launches = crash_paths(dev)

    # --- 6m. the card tests (pytest) ------------------------------------------
    card_tests()

    # --- 7-10. the large-cloud path -----------------------------------------
    torch.cuda.empty_cache()
    large_launches = large_phases(dev, results)
    by_path = {"fused": launches, **rescue_launches, **values_launches, **hard_launches,
               **batch_launches, **stream_launches, **serve_launches, **pipeline_launches,
               **multiway_launches, **route_launches, **crash_launches, **mesh_launches,
               **large_launches}
    # Kernels 1, 2 and the bf16 score: launches of the fused path's counted
    # step; the fp32 score and 4-6: of path B; 7: of path C.
    row_path = {"ransac_score": "B", "lane_nn_wide": "C",
                **{name: "B" for name in LARGE_KERNELS}}

    # --- 11. report -------------------------------------------------------
    kernels = []
    for name, r in results.items():
        kern = ROW_KERNEL.get(name, name)
        path = ROW_PATH.get(name, row_path.get(kern, "fused"))
        source, replaces = {**SOURCES, **PORT_ONLY_SOURCES}[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][kern],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
            # A kernel whose module a path had not imported yet was launched 0 times.
            "launches_by_path": {path: counts.get(kern, 0) for path, counts in by_path.items()},
        }
        row.update({key: r[key] for key in ("launch_ms", "ms_verification",
                                            "bound_ms_verification", "shape_verification")
                    if key in r})
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def parent_note(name: str) -> str:
    """The time before the redesign of a row in PARENT_MS, for its log line."""
    if name not in PARENT_MS:
        return ""
    return f" (before the redesign {PARENT_MS[name]:.4f} ms, PERF.md section 6)"


def full_normals_check(fulls, raw_sources, pp) -> None:
    """The full-resolution normals of the main path's clouds: their card
    time (CUDA events, estimate_normals or estimate_normals_capped as
    preprocess_points picks it), and the source clouds of lanes 0-3 again
    on the CPU.  Held to the CPU tests' tolerance (tests/test_torch_
    preprocess.py): |n_card . n_cpu| > 0.9999 on >= 99% of valid rows, a
    positive dot on every row more than ~6 deg from perpendicular to the
    outward direction, masked rows 0."""
    import torch

    from tpu3dm_torch.core.cloud import from_numpy
    from tpu3dm_torch.preprocess.normals import estimate_normals, estimate_normals_capped

    def normals(pc):
        if pp.full_normal_max_nn > 0:
            return estimate_normals_capped(pc, pp.normal_radius, max_nn=pp.full_normal_max_nn)
        return estimate_normals(pc, pp.normal_radius)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    start.record()
    for pc in fulls:
        normals(pc)
    end.record()
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = sum(int(pc.mask.sum()) for pc in fulls)
    worst_share, worst_dot = 1.0, 1.0
    for i, pts in enumerate(raw_sources):
        card = fulls[2 * i]
        cpu = normals(from_numpy(pts, device="cpu"))
        m = card.mask.cpu().numpy()
        nc, nh = card.normals.cpu().numpy(), cpu.normals.numpy()
        p = card.points.cpu().numpy()
        dots = (nc * nh).sum(1)
        u = p - p[m].mean(0)
        u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
        decided = m & (np.abs((nh * u).sum(1)) > 0.1)
        worst_share = min(worst_share, float((np.abs(dots[m]) > 0.9999).mean()))
        worst_dot = min(worst_dot, float(dots[decided].min()))
        if not (np.all(nc[~m] == 0) and np.isfinite(nc).all()):
            fail(f"full normals of cloud {2 * i}: non-finite, or non-zero at masked rows")
    which = (f"the nearest {pp.full_normal_max_nn}" if pp.full_normal_max_nn > 0
             else "every neighbour")
    log(f"full-resolution normals: {len(fulls)} clouds, {n} points, {which} "
        f"in radius {pp.normal_radius:g}: card {start.elapsed_time(end):.2f} ms (CUDA events), "
        f"{wall * 1e3:.2f} ms host clock; lanes 0-3 sources vs CPU: |dot| > 0.9999 on "
        f">= {worst_share:.6f} of valid rows, least decided dot {worst_dot:.6f}")
    if worst_share < 0.99 or worst_dot <= 0.0:
        fail("full-resolution normals on the card disagree with the CPU run")


def wide_pick_check(q, t, tmask, qmask, idx_kernel, idx_plain) -> tuple[float, float]:
    """Kernel 7 against its plain version where the kernel's fmaf chain and
    the plain version's cuBLAS product may round differently.  Returns the
    share of valid rows whose picks are equal, and the largest amount (0 when
    none) by which a kernel pick's float64 distance exceeds the row's float64
    minimum over valid targets by more than twice the fp32 error of an
    entry, gamma_37 * 2 (|q|^2 + max_j |t_j|^2): 37 rounded steps (33 FMAs,
    the scale, the subtraction, the add of |q|^2, the clamp) on terms of
    total size at most 2 (|q|^2 + |t_j|^2)."""
    import torch

    from tpu3dm_torch.ops.nn import lane_slices

    agree = (idx_kernel == idx_plain)[qmask].float().mean().item()
    excess = 0.0
    for sl in lane_slices(q.shape[0], q.shape[1] * t.shape[1]):
        qd, td = q[sl].double(), t[sl].double()
        qsq, tsq = (qd * qd).sum(-1), (td * td).sum(-1)
        d = qsq[..., None] + tsq[:, None, :] - 2.0 * torch.bmm(qd, td.transpose(1, 2))
        d = d.masked_fill(~tmask[sl][:, None, :], float("inf"))
        pick = torch.gather(d, -1, idx_kernel[sl].long()[..., None])[..., 0]
        tmax = torch.where(tmask[sl], tsq, 0.0).amax(-1)
        bound = 2.0 * 37 * 2.0 ** -24 * 2.0 * (qsq + tmax[:, None])
        over = (pick - d.amin(-1) - bound)[qmask[sl]]
        if over.numel():
            excess = max(excess, over.max().item())
    return agree, excess


def rescue_paths(run_step, src, tgt, T_true, mu, M2, cfg, m_s) -> dict:
    """Paths C (mutual_filter=False) and D (mutual) of fused_register_step
    with the batched alias rescue over the LANES lanes: launch counts zeroed
    just before each path's counted call and read just after, every lane
    gated.  Path C is also checked against the CPU on lanes 0-3, timed,
    staged and profiled; D is timed once.  Returns {"C": counts, "D": counts}."""
    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.fused import (
        _pn_center,
        correspondences,
        icp_polish,
        rescue_candidates,
        verify_elect,
    )

    R = RESCUE_RESTARTS
    bits = draw_bits((LANES, R, 1, m_s), torch.Generator().manual_seed(3))
    n_icp_searches = -(-ICP_ITERS // ICP_SOLVES_PER_NN)

    def step(mutual, lanes=slice(None), device=None):
        return run_step(lanes, device, bits, mutual_filter=mutual, rescue_restarts=R,
                        rescue_modes=RESCUE_MODES, verify_iters=VERIFY_ITERS)

    def staged(mutual):
        """The step's four stages, each ended by a synchronize (ms)."""
        marks = [time.time()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.time())

        fc = _pn_center(tgt["points"], tgt["mask"])
        sp_ = (src["points"] - fc[:, None]).contiguous()
        tp_ = (tgt["points"] - fc[:, None]).contiguous()
        qa, valid = correspondences(src["features"], tgt["features"], src["mask"], tgt["mask"],
                                    tp_, mutual_filter=mutual)
        mark()
        cands, ccounts = rescue_candidates(
            sp_, qa, valid, bits, dist_thresh=cfg.ransac.dist_thresh, iterations=HYPOTHESES,
            batch_size=HYPOTHESES, approx_score=True, rescue_modes=RESCUE_MODES)
        mark()
        Tr, _ = verify_elect(cands, ccounts, sp_, src["mask"], tp_, tgt["mask"], tgt["normals"],
                             dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
                             verify_iters=VERIFY_ITERS, rescue_modes=RESCUE_MODES)
        mark()
        icp_polish(Tr, sp_, src["mask"], tp_, tgt["mask"], tgt["normals"],
                   icp_thresh=cfg.icp.dist_thresh, icp_iterations=ICP_ITERS,
                   icp_solves_per_nn=ICP_SOLVES_PER_NN)
        mark()
        return np.diff(marks) * 1e3

    out = {}
    for name, mutual in (("C", False), ("D", True)):
        step(mutual)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        T_gpu, fit, _ = step(mutual)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = {k: v.launches for k, v in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        # One correspondence search, one score launch a restart (one chunk
        # each), 8 annealed solves + 1 grading search over all candidates,
        # then the ICP polish's searches.
        expect = {"lane_mutual": int(mutual), "lane_nn_wide": int(not mutual),
                  "ransac_score_bf16": R, "ransac_score": 0,
                  "lane_nn_smalld": VERIFY_ITERS + 1 + n_icp_searches}
        if any(counts[k] != v for k, v in expect.items()):
            fail(f"path {name} launches {counts}, expected {expect}")
        rot, rmse_true = fused_gate(T_gpu, T_true, mu, M2)
        if rot.max() >= 2.0 or rmse_true.max() >= 0.1:
            fail(f"path {name} quality gate: worst lane rot {rot.max():.3f} deg, "
                 f"rmse {rmse_true.max():.4f}")
        line = (f"path {name} (rescue {R} restarts x {RESCUE_MODES} modes, {VERIFY_ITERS} "
                f"verification solves, mutual_filter={mutual}): {LANES} lanes, counted call "
                f"{first_s * 1e3:.1f} ms; worst lane rot {rot.max():.4f} deg, rmse "
                f"{rmse_true.max():.5f}, fitness min {fit.min().item():.3f}; peak memory "
                f"{peak:.2f} GiB; launches { {k: v for k, v in counts.items() if v} }")
        out[name] = counts
        if mutual:
            log(line)
            continue
        T_cpu, _, _ = step(mutual, slice(0, 4), "cpu")
        ref_rot, ref_t = apart(T_gpu[:4], T_cpu)
        if ref_rot >= 0.5 or ref_t >= 0.02:
            fail(f"path {name}: GPU and CPU runs of lanes 0-3 differ: rot {ref_rot:.4f} deg, "
                 f"t {ref_t:.4g}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            step(mutual)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        step_s = float(np.median(times))
        stages = np.median(np.stack([staged(mutual) for _ in range(3)]), axis=0)
        log(line)
        log(f"path {name}: step {step_s * 1e3:.1f} ms median of 3 -> {LANES / step_s:.1f} "
            f"pairs/s; stages (ms, synchronized, median of 3): correspondences "
            f"{stages[0]:.1f}, RANSAC restarts {stages[1]:.1f}, dedup + verification + election "
            f"{stages[2]:.1f}, ICP polish {stages[3]:.1f}; lanes 0-3 vs CPU: rot "
            f"{ref_rot:.4f} deg, t {ref_t:.3g}")
        profile_report(lambda: step(mutual), f"path {name}")
    return out


def rescore_case(H, e, F, c, v, thr) -> dict:
    """Kernel 3's fp32 route at path F1's rescore shape (RESCORE_TOP fp32
    hypotheses a lane over every row), held as fp32_score_case holds it:
    both counts of every hypothesis inside the FP32_CHAIN_REL float64
    bracket, >= 99.9% equal, never more than 1 apart."""
    import torch

    from tpu3dm_torch.ops import ransac_score

    ck = ransac_score.score_features(H, e, F, c, v, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, v, thr)
    sure, near = ransac_score.score_count_bracket(H, e, F, c, v, thr, ransac_score.FP32_CHAIN_REL)
    torch.cuda.synchronize()
    outside = sum(int(((x < sure) | (x > sure + near)).sum()) for x in (ck, cp))
    diff = (ck - cp).abs()
    exact = (diff == 0).float().mean().item()
    if outside or exact < 0.999 or int(diff.max()) > 1:
        fail(f"ransac_score at the rescore shape: counts equal on {exact:.4%}, max difference "
             f"{int(diff.max())}, {outside} outside the float64 bracket")
    b, k, n = H.shape[0], H.shape[1], F.shape[1]
    nv = float(v.sum())
    Ft = F.transpose(-1, -2)

    def score_library():
        d2 = torch.baddbmm(c[:, None, :], H, Ft).add_(e[:, :, None])
        return d2.masked_fill_(~v[:, None, :], float("inf")).lt_(thr).sum(-1)

    # 19 fp32 instructions per hypothesis x valid row; bytes: H, e and the
    # counts in full, valid rows of F and c, the mask.
    r = dict(
        agree=exact, max_abs_err=float(diff.max()),
        ms=cuda_ms(lambda: ransac_score.score_features(H, e, F, c, v, thr), 10),
        plain_ms=cuda_ms(lambda: ransac_score.score_features_plain(H, e, F, c, v, thr), 2),
        library_ms=cuda_ms(score_library, 2),
        bound=bound_ms(b * k * (64 + 4 + 4) + 68 * nv + b * n, (19.0 * k * nv, PEAK_FP32_OPS)),
        shape=f"{b} lanes x K {k} x N {n} ({nv:.0f} valid rows), fp32 H and F (the rescore)",
    )
    log(f"kernel ransac_score at the rescore shape: counts equal {exact:.6f}, "
        f"{int((near > 0).sum())} hypotheses near the threshold, {outside} outside the bracket")
    return r


def counted(label: str, fn, expect: dict) -> tuple:
    """One call of ``fn`` with the launch counts zeroed just before and read
    just after; ``expect`` maps a kernel to its count (an int, or a callable
    that checks the count).  Returns (fn's result, counts, wall s, peak GiB)."""
    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: v.launches for k, v in KERNELS.items()}
    for k, want in expect.items():
        if not (want(counts[k]) if callable(want) else counts[k] == want):
            fail(f"{label} launched {counts}, expected {expect} ({k})")
    return out, counts, wall, torch.cuda.max_memory_allocated() / 2**30


def gate_lanes(label: str, T, T_true, mu, M2) -> str:
    """Every lane inside bench.py's gate (< 2 deg, RMSE < 0.1); returns the
    worst lane, for the log."""
    rot, rmse = fused_gate(T, T_true, mu, M2)
    if rot.max() >= 2.0 or rmse.max() >= 0.1:
        fail(f"{label} quality gate: worst lane rot {rot.max():.3f} deg, rmse {rmse.max():.4f}")
    return f"worst lane rot {rot.max():.4f} deg, rmse {rmse.max():.5f}"


def agree_cpu(label: str, T_gpu, T_cpu) -> str:
    """The card's poses against the CPU run's: rotation < 0.5 deg,
    translation < 0.02."""
    rot, t = apart(T_gpu, T_cpu)
    if rot >= 0.5 or t >= 0.02:
        fail(f"{label}: GPU and CPU runs differ: rot {rot:.4f} deg, t {t:.4g}")
    return f"rot {rot:.4f} deg, t {t:.3g}"


def values_paths(src, tgt, T_true, mu, M2, cfg, step_kw, bits) -> tuple[dict, object]:
    """Path E (fused_register_step at bench.py's settings, the default
    nn_impl) and the four steps of path F over the LANES lanes.  Returns
    ({path: launch counts}, path E's poses)."""
    import torch

    from tpu3dm_torch.parallel.multipair import draw_bits, ransac_pair_step
    from tpu3dm_torch.registration.fused import (
        _pn_center,
        correspondences,
        fused_register_step,
        icp_polish,
    )

    attrs = ("points", "features", "mask", "normals")
    kw_e = {k: v for k, v in step_kw.items() if k != "nn_impl"}  # the default route
    kw_e["approx_features"] = True
    n_icp = -(-ICP_ITERS // ICP_SOLVES_PER_NN)

    def step(lanes=slice(None), device=None, bits=bits, **kw):
        args = [d[a][lanes] for d in (src, tgt) for a in attrs]
        if device == "cpu":
            args = [x.cpu() for x in args]
        return fused_register_step(*args, bits[lanes], device=device, **{**kw_e, **kw})

    def staged():
        marks = [time.time()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.time())

        fc = _pn_center(tgt["points"], tgt["mask"])
        sp_ = (src["points"] - fc[:, None]).contiguous()
        tp_ = (tgt["points"] - fc[:, None]).contiguous()
        qa, valid = correspondences(src["features"], tgt["features"], src["mask"], tgt["mask"],
                                    tp_, approx=True)
        mark()
        Tr, _ = ransac_pair_step(sp_, qa, valid, bits, dist_thresh=cfg.ransac.dist_thresh,
                                 iterations=HYPOTHESES, batch_size=HYPOTHESES, approx_score=True)
        mark()
        icp_polish(Tr, sp_, src["mask"], tp_, tgt["mask"], tgt["normals"],
                   icp_thresh=cfg.icp.dist_thresh, icp_iterations=ICP_ITERS,
                   icp_solves_per_nn=ICP_SOLVES_PER_NN, f16_payload=True)
        mark()
        return np.diff(marks) * 1e3

    out = {}
    step()  # warm-up of this route's eager ops
    (T_e, fit, rmse), counts, first_s, peak = counted("path E", step, {
        "lane_mutual": 1, "lane_mutual_bf16_cross": 0, "ransac_score_bf16": 1,
        "ransac_score": 0, "lane_nn_smalld": n_icp})
    out["E"] = counts
    worst = gate_lanes("path E", T_e, T_true, mu, M2)
    T_cpu, _, _ = step(slice(0, 4), "cpu")
    ref = agree_cpu("path E lanes 0-3", T_e[:4], T_cpu)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    step_s = float(np.median(times))
    stages = np.median(np.stack([staged() for _ in range(3)]), axis=0)
    log(f"path E (default nn_impl values_pk, approx_features, bf16 score, {HYPOTHESES} "
        f"hypotheses, {ICP_ITERS} ICP iterations / {ICP_SOLVES_PER_NN} solves a search): "
        f"{LANES} lanes, step {step_s * 1e3:.1f} ms median of 3 -> {LANES / step_s:.1f} pairs/s "
        f"(counted call {first_s * 1e3:.1f} ms); stages (ms, synchronized, median of 3): "
        f"correspondences {stages[0]:.1f}, ransac {stages[1]:.1f}, icp {stages[2]:.1f}; peak "
        f"memory {peak:.2f} GiB; {worst}, fitness min {fit.min().item():.3f}, icp rmse max "
        f"{rmse.max().item():.4f}; lanes 0-3 vs CPU: {ref}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    profile_report(step, "path E")

    gen = torch.Generator().manual_seed(5)
    m_s = bits.shape[-1]
    n_r = RESCUE_RESTARTS
    cases = (
        ("F1", "score_subset=256, rescore_top=128",
         dict(score_subset=SUBSET, rescore_top=RESCORE_TOP), bits,
         {"lane_mutual": 1, "ransac_score_bf16": 1, "ransac_score": 1, "lane_nn_smalld": n_icp}),
        ("F2", 'sample_mode="gather"', dict(sample_mode="gather"),
         draw_bits((LANES, 1, HYPOTHESES, 2), gen),
         {"lane_mutual": 1, "ransac_score_bf16": 1, "ransac_score": 0, "lane_nn_smalld": n_icp}),
        ("F3", f"rescue {n_r} restarts x {RESCUE_MODES} modes on values_pk",
         dict(rescue_restarts=n_r, rescue_modes=RESCUE_MODES, verify_iters=VERIFY_ITERS),
         draw_bits((LANES, n_r, 1, m_s), gen),
         {"lane_mutual": 1, "ransac_score_bf16": n_r, "ransac_score": 0,
          "lane_nn_smalld": VERIFY_ITERS + 1 + n_icp}),
        ("F4", 'nn_impl="values_b16"', dict(nn_impl="values_b16"), bits,
         {"lane_mutual": 0, "lane_mutual_bf16_cross": 1, "ransac_score_bf16": 1,
          "lane_nn_smalld": n_icp}),
    )
    for name, what, kw, b_, expect in cases:
        (T, fit, _), counts, wall, peak = counted(f"path {name}", lambda: step(bits=b_, **kw),
                                                  expect)
        out[name] = counts
        log(f"path {name} ({what}): {LANES} lanes, counted call {wall * 1e3:.1f} ms, peak "
            f"memory {peak:.2f} GiB; {gate_lanes(f'path {name}', T, T_true, mu, M2)}, fitness "
            f"min {fit.min().item():.3f}; launches { {k: v for k, v in counts.items() if v} }")
    return out, T_e


def hard_paths(src, tgt, T_true, mu, M2, cfg, T_e) -> dict:
    """Path G (the adaptive budget on HARD_LANES lanes of shuffled
    correspondences) and path H (the escalation on HARD_LANES lanes from path
    E's poses).  Returns {"G": counts, "H": counts}."""
    import torch

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.parallel.multipair import (
        draw_bits,
        extra_chunk_count,
        f32_square,
        ransac_pair_step,
    )
    from tpu3dm_torch.registration.fused import (
        _pn_center,
        correspondences,
        escalated_register_step,
    )
    from tpu3dm_torch.registration.hypotheses import sample_row_count

    n = HARD_LANES
    lanes = slice(0, n)
    dev = src["points"].device
    cap = src["points"].shape[1]
    n_extra = extra_chunk_count(HYPOTHESES, ADAPT_ITERATIONS, HYPOTHESES)
    gen = torch.Generator().manual_seed(6)
    out = {}

    # --- G: lanes whose correspondences mostly lost their match ---------------
    fc = _pn_center(tgt["points"][lanes], tgt["mask"][lanes])
    sp_ = (src["points"][lanes] - fc[:, None]).contiguous()
    tp_ = (tgt["points"][lanes] - fc[:, None]).contiguous()
    qa, valid = correspondences(src["features"][lanes], tgt["features"][lanes],
                                src["mask"][lanes], tgt["mask"][lanes], tp_, approx=True)
    keep = torch.rand(valid.shape, generator=gen).to(dev) < KEEP_CORRESPONDENCES
    perm = torch.argsort(torch.rand(valid.shape, generator=gen), dim=1).to(dev)
    qs = torch.where(keep[..., None], qa, torch.gather(qa, 1, perm[..., None].expand(-1, -1, 3)))
    T_c = torch.as_tensor(T_true[:n], dtype=torch.float32, device=dev).clone()
    T_c[:, :3, 3] += torch.einsum("bij,bj->bi", T_c[:, :3, :3], fc) - fc
    thr = f32_square(cfg.ransac.dist_thresh)
    inl = (torch.sum((se3.apply(T_c, sp_) - qs) ** 2, -1) < thr) & valid
    share = inl.sum(-1).float() / valid.sum(-1).clamp_min(1).float()
    m_s = sample_row_count(cap, HYPOTHESES)
    bits_g = draw_bits((n, 1, m_s), gen)
    extra_g = draw_bits((n, n_extra, m_s), gen)
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, iterations=HYPOTHESES, batch_size=HYPOTHESES,
              approx_score=True, adapt_iterations=ADAPT_ITERATIONS)
    (Tg, cg), counts, wall, _ = counted("path G", lambda: ransac_pair_step(
        sp_, qs, valid, bits_g, extra_bits=extra_g, **kw), {"ransac_score_bf16": lambda c: c > 1})
    out["G"] = counts
    extras = counts["ransac_score_bf16"] - 1
    Tc, cc = ransac_pair_step(*(x[:4].cpu() for x in (sp_, qs, valid)), bits_g[:4],
                              extra_bits=extra_g[:4], **kw)
    ref = agree_cpu("path G lanes 0-3", Tg[:4], Tc)
    rot, _ = fused_gate(Tg, T_c.cpu().numpy(), np.zeros((n, 3)), np.zeros((n, 3, 3)))
    log(f"path G (adaptive budget, {HYPOTHESES} + up to {n_extra} x {HYPOTHESES} hypotheses, "
        f"{KEEP_CORRESPONDENCES:.0%} of rows keep their match): {n} lanes, inlier share "
        f"{share.min().item():.3f}-{share.max().item():.3f} (mean {share.mean().item():.3f}); "
        f"extra chunks run {extras}; counted call {wall * 1e3:.1f} ms; elected support "
        f"{(cg.float() / valid.sum(-1).float()).min().item():.3f}-"
        f"{(cg.float() / valid.sum(-1).float()).max().item():.3f}; worst lane rot vs T_true "
        f"{rot.max():.3f} deg (RANSAC only, no ICP); lanes 0-3 vs CPU: {ref}, counts "
        f"{cg[:4].tolist()} / {cc.tolist()}; launches { {k: v for k, v in counts.items() if v} }")
    del sp_, tp_, qa, qs, valid, keep, perm, inl

    # --- H: the escalation at the stream's settings ---------------------------
    args = [d[a][lanes] for d, names in ((src, ("points", "features", "mask")),
                                         (tgt, ("points", "features", "mask", "normals")))
            for a in names]
    # Odd lanes start from an alias: path E's pose turned ALIAS_DEG about z
    # through the source centroid.  The gate then holds only if the
    # election drops the init_T probe for a mode or a screw-lattice probe.
    w = src["mask"][lanes].float()[..., None]
    c = (src["points"][lanes] * w).sum(1) / w.sum(1).clamp_min(1.0)
    a = np.radians(ALIAS_DEG)
    turn = torch.eye(4, device=dev).repeat(n, 1, 1)
    turn[:, :2, :2] = torch.tensor([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                                   dtype=torch.float32, device=dev)
    turn[:, :3, 3] = c - torch.einsum("bij,bj->bi", turn[:, :3, :3], c)
    init = T_e[lanes].clone()
    init[1::2] = init[1::2] @ turn[1::2]
    bits_h = draw_bits((n, 1, cap), gen)
    extra_h = draw_bits((n, n_extra, cap), gen)
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=HYPOTHESES, ransac_batch=HYPOTHESES, n_modes=ESCALATION_MODES,
              adapt_iterations=ADAPT_ITERATIONS, verify_iters=VERIFY_ITERS)

    def escalate(lanes_=slice(None), device=None):
        a = [x[lanes_] for x in args]
        if device == "cpu":
            a = [x.cpu() for x in a]
        return escalated_register_step(*a, bits_h[lanes_], init[lanes_].to(a[0].device),
                                       extra_bits=extra_h[lanes_], device=device, **kw)

    # snap, 8 annealed solves and a grading search over every probe; 6
    # polish solves and a grading search of the winner.
    n_probes = 1 + ESCALATION_MODES + 5 * ESCALATION_MODES * (ESCALATION_MODES - 1) // 2
    (T_h, fit, rmse), counts, first_s, peak = counted("path H", escalate, {
        "lane_mutual": 1, "ransac_score_bf16": lambda c: c >= 1, "ransac_score": 0,
        "lane_nn_smalld": 1 + VERIFY_ITERS + 1 + 6 + 1})
    out["H"] = counts
    worst = gate_lanes("path H", T_h, T_true[:n], mu[:n], M2[:n])
    from_init, _ = fused_gate(T_h, init.double().cpu().numpy(), mu[:n], M2[:n])
    if from_init[1::2].min() < ALIAS_DEG / 2:
        fail(f"path H: an alias lane kept its init_T ({from_init[1::2].min():.3f} deg from it)")
    torch.cuda.synchronize()
    t0 = time.time()
    escalate()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    T_cpu, _, _ = escalate(slice(0, 2), "cpu")
    ref = agree_cpu("path H lanes 0-1", T_h[:2], T_cpu)
    log(f"path H (escalation: {ESCALATION_MODES} modes, {HYPOTHESES} + up to {n_extra} x "
        f"{HYPOTHESES} hypotheses, {n_probes} probes a lane with init_T path E's pose, turned "
        f"{ALIAS_DEG:g} deg on odd lanes): {n} lanes, counted call {first_s * 1e3:.1f} ms, "
        f"second call {warm_s * 1e3:.1f} ms; peak memory {peak:.2f} GiB; {worst}; elected pose "
        f"from init_T: even lanes max {from_init[0::2].max():.3f} deg, odd (alias) lanes min "
        f"{from_init[1::2].min():.3f} deg; fitness min {fit.min().item():.3f}, rmse max "
        f"{rmse.max().item():.4f}; lanes 0-1 vs CPU: {ref}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out


def fp32_score_case(sd, td, rc) -> dict:
    """Kernel 3's fp32 route at one lane, as the two-mode RANSAC runs it: the
    first hypothesis chunk of path B's first restart (the generator
    register_arrays_large seeds with key 0), built as ransac_two_mode builds
    it.  The kernel's fmaf chain and the plain version's cuBLAS product sum
    in different orders, so a count may differ where an entry lies within
    the fp32 error of the threshold.  Held to: both counts of every
    hypothesis inside the float64 bracket of FP32_CHAIN_REL (18 rounded
    steps: 16 products, c and e); equal on >= 99.9% of hypotheses; never
    more than 1 apart.  Returns the kernel's numbers."""
    import torch

    from tpu3dm_torch.ops import ransac_score
    from tpu3dm_torch.ops.compact import compaction_permutation
    from tpu3dm_torch.parallel.multipair import draw_bits, f32_square
    from tpu3dm_torch.registration import hypotheses as hyp
    from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs
    from tpu3dm_torch.registration.ransac import chunk_count

    pairs, valid = feature_correspondences(sd, td, mutual_filter=rc.mutual_filter)
    p, q = gather_pairs(sd, td, pairs)
    order = compaction_permutation(valid)
    p, q, valid = p[order], q[order], valid[order]
    pq, F, c = hyp.prepare_correspondences(p[None], q[None])
    bits = draw_bits((chunk_count(rc.max_iterations, rc.batch_size), rc.batch_size, 2),
                     torch.Generator().manual_seed(0))[0]
    triples = hyp.sample_distinct_triples(bits.to(p.device), int(valid.sum()))[None]
    ga, gb, gc = (torch.gather(pq, 1, triples[..., k, None].expand(-1, -1, 6)) for k in range(3))
    R, t, _ = hyp.fit3_frames(ga[..., :3], gb[..., :3], gc[..., :3],
                              ga[..., 3:], gb[..., 3:], gc[..., 3:])
    H, e = hyp.hypothesis_features_planar(R, t)
    H, e, F, c, v = (x.contiguous() for x in (H, e, F, c, valid[None]))
    thr = f32_square(rc.dist_thresh)

    ck = ransac_score.score_features(H, e, F, c, v, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, v, thr)
    sure, near = ransac_score.score_count_bracket(H, e, F, c, v, thr, ransac_score.FP32_CHAIN_REL)
    torch.cuda.synchronize()
    outside = sum(int(((x < sure) | (x > sure + near)).sum()) for x in (ck, cp))
    diff = (ck - cp).abs()
    exact = (diff == 0).float().mean().item()
    k, nv = H.shape[1], float(v.sum())
    log(f"kernel ransac_score fp32 (B first RANSAC chunk): {k} hypotheses x {F.shape[1]} "
        f"correspondences ({nv:.0f} valid): counts equal on {exact:.6f}, max difference "
        f"{int(diff.max())}, {int((near > 0).sum())} hypotheses with entries within the fp32 "
        f"error of the threshold, {outside} counts outside the float64 bracket")
    if outside or exact < 0.999 or int(diff.max()) > 1:
        fail("ransac_score on fp32 inputs disagrees with its plain version beyond the "
             "threshold's rounding")
    Ft = F.transpose(-1, -2)

    def score_library():
        d2 = torch.baddbmm(c[:, None, :], H, Ft).add_(e[:, :, None])
        return d2.masked_fill_(~v[:, None, :], float("inf")).lt_(thr).sum(-1)

    # 19 fp32 instructions per hypothesis x valid correspondence (16 FMAs,
    # the adds of c and e, the compare); bytes: H, e and the counts in full,
    # valid rows of F and c, the mask.
    r = dict(
        agree=exact, max_abs_err=float(diff.max()),
        ms=cuda_ms(lambda: ransac_score.score_features(H, e, F, c, v, thr), 10),
        plain_ms=cuda_ms(lambda: ransac_score.score_features_plain(H, e, F, c, v, thr), 3),
        library_ms=cuda_ms(score_library, 3),
        bound=bound_ms(k * (64 + 4 + 4) + 68 * nv + F.shape[1], (19.0 * k * nv, PEAK_FP32_OPS)),
        shape=f"1 lane x K {k} x N {F.shape[1]} ({nv:.0f} valid rows), fp32 H and F",
    )
    # The launch alone, without the wrapper's Python (checks, the counts'
    # allocation, the stream).
    out = torch.empty_like(ck)
    r["launch_ms"] = cuda_ms(lambda: ransac_score.RANSAC_SCORE.launch(
        H.device, H.data_ptr(), e.data_ptr(), F.data_ptr(), c.data_ptr(), v.data_ptr(), thr,
        out.data_ptr(), 1, k, F.shape[1]), 10)
    log(f"kernel ransac_score fp32 (B first RANSAC chunk){parent_note('ransac_score_fp32_1lane')}: "
        f"kernel {r['ms']:.4f} ms (the launch alone {r['launch_ms']:.4f} ms), plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]})")
    return r


def features_agree(label: str, got, want) -> str:
    """Down normals and FPFH of two runs of one cloud, held to the bounds of
    tests/test_torch_preprocess.py: |dot| > 0.9999 on >= 99% of valid rows
    and > 0.9 on all, FPFH relative L1 median < 2e-3, 90th percentile
    < 1e-2, max < 0.6; equal masks, masked rows 0.  Returns the worst
    figures and whether the two were equal, for the log."""
    m = want.mask.cpu().numpy()
    if not np.array_equal(got.mask.cpu().numpy(), m):
        fail(f"{label}: masks differ")
    gn, wn = got.normals.cpu().numpy(), want.normals.cpu().numpy()
    gf, wf = got.features.cpu().numpy(), want.features.cpu().numpy()
    dots = (gn * wn).sum(1)[m]
    rel = np.abs(gf - wf).sum(1)[m] / np.maximum(np.abs(wf).sum(1)[m], 1e-30)
    if ((dots > 0.9999).mean() < 0.99 or dots.min() <= 0.9 or np.median(rel) >= 2e-3
            or np.quantile(rel, 0.9) >= 1e-2 or rel.max() >= 0.6 or gf[~m].any() or gn[~m].any()
            or not (np.isfinite(gf).all() and np.isfinite(gn).all())):
        fail(f"{label}: normals dot min {dots.min():.6f}, FPFH relative L1 median "
             f"{np.median(rel):.3g}, max {rel.max():.3g}")
    return dots.min(), rel.max(), bool(np.array_equal(gn, wn) and np.array_equal(gf, wf))


def batch_paths(dev, cfg, clouds, trues, moments) -> dict:
    """Path I: the batch API at bench.py's distinct-pair width.  I1 batched
    ingest of the main path's 16 clouds; I2 ``register_pairs_batched`` over
    the 8 pairs tiled to LANES pairs, launch counts zeroed before and read
    after each bucket; I3 ``register_sources_to_target`` with one
    ``ResidentTarget``; I4 checkpoint resume, the device voxel grid, noise
    injection and the dense features.  ``clouds`` holds phase 3's per-cloud
    down clouds (``preprocess_points`` on the card).  Returns {"I": the
    counts of I2's counted call, "I3": I3's}."""
    import dataclasses
    import tempfile

    import torch

    from tpu3dm_torch.core.cloud import from_numpy
    from tpu3dm_torch.core.se3 import exp_se3
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.multiway.checkpoint import CheckpointStore
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess import voxel
    from tpu3dm_torch.preprocess.dense import down_features_dense
    from tpu3dm_torch.preprocess.pipeline import ProcessedCloud, preprocess_points_batch
    from tpu3dm_torch.registration import batch

    pp = cfg.preprocess
    n_icp = -(-ICP_ITERS // BATCH_SOLVES_PER_NN)
    bucket_expect = {"lane_mutual": 1, "lane_mutual_bf16_cross": 0, "lane_nn_wide": 0,
                     "lane_nn_smalld": n_icp, "ransac_score_bf16": 1, "ransac_score": 0}

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    # --- I1: batched ingest ----------------------------------------------------
    raw = [c for s in range(PAIRS) for c in make_benchmark_pair(N_POINTS, seed=s, sigma=0.01)[:2]]

    def ingest(clouds_=raw, **kw):
        return preprocess_points_batch(clouds_, pp, full_normals=False, device=dev, **kw)

    procs, cold_s = synced(ingest)
    procs, warm_s = synced(ingest)
    cap_d = procs[0].down.capacity
    same_cap, exact, worst_dot, worst_rel = 0, 0, 1.0, 0.0
    def rows(pc, n):  # the first n rows of a cloud
        return pc.with_(**{f: getattr(pc, f)[:n] for f in ("points", "mask", "normals",
                                                           "features")})

    for i, pc in enumerate(procs):
        single = clouds[i // 2][i % 2]
        n = int(single.mask.sum())
        same_cap += single.capacity == cap_d
        if pc.full.points.device.type != "cpu" or pc.full.normals.any():
            fail("path I1: full_normals=False must return host clouds with zero normals")
        if pc.down.mask[n:].any() or not torch.equal(pc.down.points[:n], single.points[:n]):
            fail(f"path I1: cloud {i}'s down points differ from per-cloud preprocess_points")
        d, r, eq = features_agree(f"path I1 cloud {i} vs per-cloud", rows(pc.down, n),
                                  rows(single, n))
        if single.capacity == cap_d and not eq:
            fail(f"path I1: cloud {i}'s down normals and features differ from per-cloud "
                 f"preprocess_points at the same capacity (bit-equal expected)")
        worst_dot, worst_rel, exact = min(worst_dot, d), max(worst_rel, r), exact + eq
    cpu = preprocess_points_batch(raw[:2], pp, full_normals=False, down_cap=cap_d, device="cpu")
    cpu_note = [features_agree(f"path I1 cloud {i} card vs CPU", procs[i].down, cpu[i].down)
                for i in range(2)]
    log(f"path I1 (preprocess_points_batch, full_normals=False): {len(raw)} clouds of "
        f"{N_POINTS} points, down capacity {cap_d}: cold {cold_s * 1e3:.1f} ms, warm "
        f"{warm_s * 1e3:.1f} ms; vs per-cloud preprocess_points on the card: {same_cap} of "
        f"{len(raw)} at the same capacity (bit-equal required), {exact} equal bit for bit, "
        f"least normal dot "
        f"{worst_dot:.7f}, largest FPFH relative L1 {worst_rel:.3g}; clouds 0-1 vs CPU: "
        f"least dot {min(c[0] for c in cpu_note):.7f}, largest L1 "
        f"{max(c[1] for c in cpu_note):.3g}, equal {sum(c[2] for c in cpu_note)} of 2")

    # --- I2: register_pairs_batched over LANES pairs -----------------------------
    pairs = [(procs[2 * (j % PAIRS)], procs[2 * (j % PAIRS) + 1]) for j in range(LANES)]
    T_true = np.tile(np.stack(trues), (LANES // PAIRS, 1, 1))
    mu = np.tile(np.stack([mo[0] for mo in moments]), (LANES // PAIRS, 1))
    M2 = np.tile(np.stack([mo[1] for mo in moments]), (LANES // PAIRS, 1, 1))
    shape, _ = batch.pair_bits_shape(cap_d, ransac_iterations=HYPOTHESES)
    bits = draw_bits((LANES,) + shape, torch.Generator().manual_seed(11))
    kw = dict(pair_bits=bits, bucket_multiple=256, ransac_iterations=HYPOTHESES,
              icp_iterations=ICP_ITERS, icp_solves_per_nn=BATCH_SOLVES_PER_NN, approx_score=True)
    shared_kw = dict(kw)
    kw["device"] = dev

    def register(pairs_=pairs, **over):
        return batch.register_pairs_batched(pairs_, cfg, **{**kw, **over})

    register()  # warm-up
    per_bucket = []
    step = batch.fused_register_step

    def counted_step(*a, **k):  # the launch counts and wall time of one bucket
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        out = step(*a, **k)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        per_bucket.append((a[0].shape[1], a[0].shape[0], {n: v.launches for n, v in KERNELS.items()}))
        return out

    step_s = []

    batch.fused_register_step = counted_step
    try:
        torch.cuda.reset_peak_memory_stats()
        res, counted_s = synced(register)
    finally:
        batch.fused_register_step = step
    peak = torch.cuda.max_memory_allocated() / 2**30
    for cap, b, counts in per_bucket:
        if any(counts[k] != n for k, n in bucket_expect.items()):
            fail(f"path I2 bucket cap {cap} ({b} pairs) launched {counts}, expected {bucket_expect}")
    total = {k: sum(c[k] for _, _, c in per_bucket) for k in KERNELS}
    sizes = {cap: res.bucket_of_pair.count(cap) for cap in sorted(set(res.bucket_of_pair))}
    if sum(b for _, b, _ in per_bucket) != LANES or sorted(sizes.items()) != sorted(
            (cap, b) for cap, b, _ in per_bucket):
        fail(f"path I2: buckets {sizes} against the dispatched {per_bucket}")
    T = torch.from_numpy(res.transforms)
    worst = gate_lanes("path I2", T, T_true, mu, M2)
    cpu_pairs = [tuple(ProcessedCloud(full=None, down=c.down.with_(
        **{f: getattr(c.down, f).cpu() for f in ("points", "mask", "normals", "features")}),
        voxel_size=pp.voxel_size) for c in pr) for pr in pairs[:4]]
    ref = agree_cpu("path I2 pairs 0-3", T[:4], torch.from_numpy(
        register(cpu_pairs, pair_bits=bits[:4], device="cpu").transforms))
    # Bucket mates: pairs 0-7 alone in their buckets, against the whole call.
    alone = register(pairs[:PAIRS], pair_bits=bits[:PAIRS])
    mates_gap = float(np.abs(alone.transforms - res.transforms[:PAIRS]).max())
    if mates_gap != 0.0:
        fail(f"path I2: pairs 0-7 alone differ from the whole call by {mates_gap:.3g} "
             f"(bit-equal expected: a pair's sums do not follow its batch)")
    # Q2: the same call with its buckets split over a 4x1 mesh on the card.
    mesh = card_mesh(dev, MESH_N, 1)
    res_q, q_counts, q_wall, _ = counted(
        f"path Q2 register_pairs_batched(mesh={MESH_N}x1)", lambda: register(mesh=mesh),
        {k: (lambda n: n > 0) for k in MESH_KERNELS})
    same = (np.array_equal(res_q.transforms, res.transforms)
            and np.array_equal(res_q.ransac_fitness, res.ransac_fitness)
            and np.array_equal(res_q.icp_rmse, res.icp_rmse)
            and res_q.bucket_of_pair == res.bucket_of_pair)
    if not same:
        fail(f"path Q2: register_pairs_batched with a {MESH_N}x1 mesh differs from I2 by "
             f"{float(np.abs(res_q.transforms - res.transforms).max()):.3g} (bit-equal expected)")
    log(f"path Q2 (register_pairs_batched, I2's {LANES} pairs, mesh {MESH_N}x1 on one card): "
        f"{q_wall * 1e3:.1f} ms counted call, bit-equal to I2 without the mesh; launches "
        f"{ {k: q_counts[k] for k in MESH_KERNELS} }")
    times, launch_only, resolve_only = [], [], []
    for _ in range(3):
        pending, t_launch = synced(lambda: batch.launch_pairs_batched(pairs, cfg, **kw))
        _, t_resolve = synced(pending.resolve)
        launch_only.append(t_launch)
        resolve_only.append(t_resolve)
        times.append(t_launch + t_resolve)
    call_s = float(np.median(times))
    log(f"path I2 (register_pairs_batched, {LANES} pairs = {PAIRS} tiled, bucket_multiple 256, "
        f"{HYPOTHESES} hypotheses, {ICP_ITERS} ICP iterations / {BATCH_SOLVES_PER_NN} solves a "
        f"search, bf16 score, values_pk): buckets {sizes} (capacity: pairs); each bucket "
        f"launched {bucket_expect}; call {call_s * 1e3:.1f} ms median of 3 -> "
        f"{LANES / call_s:.1f} pairs/s (launch {np.median(launch_only) * 1e3:.1f} ms, resolve "
        f"{np.median(resolve_only) * 1e3:.1f} ms; counted call {counted_s * 1e3:.1f} ms, of "
        f"which the buckets' steps {' + '.join(f'{t * 1e3:.1f}' for t in step_s)} ms); peak "
        f"memory {peak:.2f} GiB; {worst}, fitness min {res.ransac_fitness.min():.3f}; pairs 0-3 "
        f"vs CPU: {ref}; pairs 0-7 alone vs in the call: max |T difference| {mates_gap:.3g}")
    profile_report(register, "path I2")
    out = {"I": total, "Q2I": q_counts}

    # --- I3: many sources against one resident target ----------------------------
    rng = np.random.default_rng(13)
    sp0 = raw[0]
    moves, sources_raw = [], []
    for _ in range(PAIRS):
        axis = rng.normal(size=3)
        xi = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                             axis / np.linalg.norm(axis) * np.radians(rng.uniform(10, 40))])
        M = exp_se3(torch.tensor(xi, dtype=torch.float64)).numpy()
        moves.append(M)
        sources_raw.append((sp0 @ M[:3, :3].T + M[:3, 3]
                            + rng.normal(0, 0.01, sp0.shape)).astype(np.float32))
    sources = ingest(sources_raw)
    target = batch.ResidentTarget(procs[0], device=dev)
    src_pairs = [sources[j % PAIRS] for j in range(LANES)]
    T_src = np.tile(np.stack([np.linalg.inv(M) for M in moves]), (LANES // PAIRS, 1, 1))
    mu3 = np.tile(np.stack([s.mean(0) for s in sources_raw]), (LANES // PAIRS, 1))
    M23 = np.tile(np.stack([s.T.astype(np.float64) @ s / s.shape[0] for s in sources_raw]),
                  (LANES // PAIRS, 1, 1))

    def shared():
        return batch.register_sources_to_target(src_pairs, target, cfg, **shared_kw)

    shared()  # warm-up
    reset_launch_counts()
    res3, counted3 = synced(shared)
    out["I3"] = {k: v.launches for k, v in KERNELS.items()}
    worst3 = gate_lanes("path I3", torch.from_numpy(res3.transforms), T_src, mu3, M23)
    direct = register([(s, procs[0]) for s in src_pairs])
    gap = float(np.abs(res3.transforms - direct.transforms).max())
    if gap > 1e-4 or res3.bucket_of_pair != direct.bucket_of_pair:
        fail(f"path I3: shared target and pair-batched transforms differ by {gap:.3g}")
    t3 = float(np.median([synced(shared)[1] for _ in range(3)]))
    log(f"path I3 (register_sources_to_target, {LANES} sources = {PAIRS} moved copies of pair "
        f"0's source, one ResidentTarget): call {t3 * 1e3:.1f} ms median of 3 -> "
        f"{LANES / t3:.1f} pairs/s (counted call {counted3 * 1e3:.1f} ms); {worst3}; vs "
        f"register_pairs_batched on the same pairs and bits: max |T difference| {gap:.3g}; "
        f"launches { {k: v for k, v in out['I3'].items() if v} }")

    # --- I4: checkpoint resume, device voxel grid, noise, dense features ---------
    names = [f"pair-{i}" for i in range(min(64, LANES))]
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        ck = dict(checkpoint=store, pair_names=names, pair_bits=bits[:len(names)])
        first = register(pairs[:len(names)], **ck)
        reset_launch_counts()
        again = register(pairs[:len(names)], **ck)
        launched = {k: v.launches for k, v in KERNELS.items() if v.launches}
    ck_gap = float(np.abs(again.transforms - first.transforms).max())
    if launched or again.bucket_of_pair != [-1] * len(names) or ck_gap > 1e-6:
        fail(f"path I4 resume: launches {launched}, buckets {set(again.bucket_of_pair)}, "
             f"|T difference| {ck_gap:.3g}")

    pts32 = sp0.astype(np.float32)  # the grid's input on both routes
    pc = from_numpy(pts32, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    grid = voxel.voxel_downsample(pc, pp.voxel_size)
    end.record()
    grid = voxel.compact(grid)
    host = voxel.voxel_downsample_host(pts32, pp.voxel_size, device=dev)
    if not (torch.equal(grid.points, host.points) and torch.equal(grid.mask, host.mask)):
        fail("path I4: the device voxel grid differs from the host grid")
    voxel_ms = start.elapsed_time(end)

    noisy_pp = dataclasses.replace(pp, noise_sigma=0.05)
    noisy = preprocess_points_batch(raw, noisy_pp, full_normals=False, device=dev,
                                    generator=torch.Generator().manual_seed(17))
    deltas = []
    for a, b in zip(noisy, procs):
        m = b.down.mask
        if a.down.points[~m].any() or not torch.equal(a.down.features, b.down.features):
            fail("path I4: noise moved a padding row or changed the features")
        deltas.append((a.down.points - b.down.points)[m].double().cpu())
    dn = torch.cat(deltas)
    n_noise = dn.numel()
    if abs(dn.mean().item()) > 4 * 0.05 / n_noise ** 0.5 or abs(dn.std().item() - 0.05) > 0.0025:
        fail(f"path I4: noise mean {dn.mean().item():.3g}, std {dn.std().item():.4f} for sigma 0.05")

    def dense(pc_):
        return down_features_dense(pc_, pp.normal_radius, pp.fpfh_radius,
                                   normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn)

    dense([p.down for p in procs][0])  # warm-up
    start.record()
    dense_card = [dense(p.down) for p in procs]
    end.record()
    torch.cuda.synchronize()
    dense_ms = start.elapsed_time(end)
    t0 = time.time()
    dense_cpu = [dense(p.down.with_(**{f: getattr(p.down, f).cpu() for f in
                                        ("points", "mask", "normals", "features")}))
                 for p in procs]
    dense_cpu_s = time.time() - t0
    notes = [features_agree(f"path I4 dense cloud {i}", a, b)
             for i, (a, b) in enumerate(zip(dense_card, dense_cpu))]
    log(f"path I4: checkpoint resume of {len(names)} pairs restored every pair (bucket -1), no launch, "
        f"|T difference| {ck_gap:.3g}; device voxel grid of a {N_POINTS}-point cloud equal to "
        f"the host grid ({int(grid.mask.sum())} voxels, {voxel_ms:.3f} ms CUDA events); noise "
        f"sigma 0.05 on {n_noise} coordinates: mean {dn.mean().item():.3g}, std "
        f"{dn.std().item():.5f}, padding rows 0, features unchanged; down_features_dense on "
        f"{len(procs)} clouds at capacity {cap_d}: card {dense_ms:.2f} ms (CUDA events), CPU "
        f"{dense_cpu_s * 1e3:.1f} ms; card vs CPU least normal dot "
        f"{min(n[0] for n in notes):.7f}, largest FPFH relative L1 {max(n[1] for n in notes):.3g}, "
        f"equal {sum(n[2] for n in notes)} of {len(notes)}")
    return out


def stream_paths(dev, cfg) -> dict:
    """Path S: the disk-to-result stream at bench.py's stream settings
    (bench.py:487-517).  S1 ``stream_register_pairs`` over a fresh
    STREAM_PAIRS-pair mixed manifest (fused, dense features, the retry),
    counted and gated by ``stream_quality``, and run again without the
    retry to show what the retry changed; S2 the first STREAM_WINDOW pairs
    at half the window, equal to S1 within 1e-6; S3 the first
    STREAM_GENERIC_PAIRS pairs on the generic path, within 0.5 deg and 0.02;
    S4 pairs 0-2 on the CPU, within the CPU agreement limit; S5 window 1's
    batched dense features equal to per-cloud ones, bit for bit.  Returns
    {"S": the counts of S1}."""
    import shutil
    import tempfile

    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.core.cloud import PointCloud
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess.dense import down_features_dense
    from tpu3dm_torch.registration import stream
    from tpu3dm_torch.registration.batch import pair_bits_shape

    pp = cfg.preprocess
    tmp = tempfile.mkdtemp(prefix="tpu3dm_torch_stream_")
    try:
        t0 = time.time()
        paths, trues, moments = stream.make_stream_manifest(
            tmp, STREAM_PAIRS, n_points=N_POINTS, sigma=0.01, family="mix")
        write_s = time.time() - t0
        gen = torch.Generator().manual_seed(29)
        shape, _ = pair_bits_shape(STREAM_CAP, ransac_iterations=HYPOTHESES,
                                   rescue_restarts=RESCUE_RESTARTS)
        bits = draw_bits((STREAM_PAIRS,) + shape, gen)
        retry_bits = draw_bits((STREAM_PAIRS, 1, STREAM_CAP), gen)
        retry_extra = draw_bits((STREAM_PAIRS, 3, STREAM_CAP), gen)
        kw = dict(down_cap=STREAM_CAP, ransac_iterations=HYPOTHESES, icp_iterations=ICP_ITERS,
                  icp_solves_per_nn=ICP_SOLVES_PER_NN, approx_score=True,
                  rescue_restarts=RESCUE_RESTARTS, retry_measure_warm=True,
                  retry_bits=retry_bits, retry_extra_bits=retry_extra)

        def run(n, window, device=dev, **over):
            return stream.stream_register_pairs(paths[:n], cfg, window=window,
                                                pair_bits=bits[:n], device=device,
                                                **{**kw, "fuse_device": True, **over})

        # --- S1: the stream, counted ----------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        res = run(STREAM_PAIRS, STREAM_WINDOW)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v.launches for k, v in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k in ("lane_nn_smalld", "lane_mutual", "ransac_score_bf16"):
            if counts[k] <= 0:
                fail(f"path S1 launched no {k}: {counts}")
        q = stream.stream_quality(res, trues, moments)
        rot, rmse = fused_gate(torch.from_numpy(res.transforms), np.stack(trues),
                               np.stack([m[0] for m in moments]),
                               np.stack([m[1] for m in moments]))
        fams = ("arch", "plate", "scan")
        per_family = {f: (float(rot[i::3].max()), float(rmse[i::3].max()),
                          int((rot[i::3] >= 2.0).sum()),
                          sum(1 for j in res.retry_pairs if j % 3 == i))
                      for i, f in enumerate(fams)}
        done = np.asarray(res.window_done_s)
        window_s = np.diff(np.concatenate([[0.0], done]))
        log(f"path S1 (stream_register_pairs, fused, dense features): {STREAM_PAIRS} fresh mixed "
            f"pairs of {N_POINTS} points, window {STREAM_WINDOW}, down_cap {STREAM_CAP}, "
            f"{HYPOTHESES} hypotheses, {ICP_ITERS} ICP iterations / {ICP_SOLVES_PER_NN} solves a "
            f"search, bf16 score, {RESCUE_RESTARTS} rescue restarts, the retry under fitness "
            f"0.15 (measure_warm): manifest written in {write_s:.2f} s; wall {wall:.2f} s")
        for i, (w_s, ing) in enumerate(zip(window_s, res.ingest_seconds)):
            log(f"  window {i + 1}: {res.window_pairs[i]} pairs, {w_s * 1e3:.1f} ms to its "
                f"resolve, host ingest {ing * 1e3:.1f} ms on the producer thread "
                f"({ing / w_s:.0%} of the window's time"
                f"{'; not overlapped: nothing precedes it' if i == 0 else ''})")
        log(f"  steady {res.steady_pairs_per_sec:.2f} pairs/s over windows 2-{len(done)} plus the "
            f"retry's warm run (window 1 pays first-use costs: kernel builds and CUDA "
            f"initialisation where no earlier phase paid them; no compile), fresh "
            f"{res.fresh_pairs_per_sec:.2f} pairs/s over {res.total_seconds:.2f} s; retry: "
            f"{len(res.retry_pairs)} pairs in {res.retry_seconds:.2f} s; peak memory "
            f"{peak:.2f} GiB; launches { {k: v for k, v in counts.items() if v} }")
        log(f"  stream_quality: {json.dumps(q)}")
        log("  per family (worst rot deg, worst alignment RMSE, pairs over 2 deg, retried): "
            + "; ".join(f"{f} {v[0]:.4f} / {v[1]:.5f} / {v[2]} / {v[3]}"
                        for f, v in per_family.items()))
        if not q["quality_ok"]:
            fail(f"path S1 quality gate: {q}")
        # The same stream without the retry: S1's poses before the escalation.
        before = run(STREAM_PAIRS, STREAM_WINDOW, retry_below_fitness=0.0)
        rot0, rmse0 = fused_gate(torch.from_numpy(before.transforms), np.stack(trues),
                                 np.stack([m[0] for m in moments]),
                                 np.stack([m[1] for m in moments]))
        over = {j: (float(rot0[j]), float(rot[j])) for j in range(STREAM_PAIRS)
                if max(rot0[j], rot[j]) >= 2.0}
        good = [j for j in res.retry_pairs if j not in over]
        log(f"  without the retry: {int((rot0 >= 2.0).sum())} pairs over 2 deg, worst recovered "
            f"alignment RMSE {rmse0[rot0 < 2.0].max():.5f}; pairs over 2 deg before or after the "
            f"retry (deg before -> after): "
            + (", ".join(f"{j} ({fams[j % 3]}) {a:.3f} -> {b:.3f}" for j, (a, b) in over.items())
               or "none")
            + f"; the {len(good)} other retried pairs' rotation error moved by at most "
            f"{max((abs(rot[j] - rot0[j]) for j in good), default=0):.4f} deg")

        # --- S2: window invariance ---------------------------------------------
        half = run(STREAM_WINDOW, STREAM_WINDOW // 2)
        gap = np.abs(half.transforms - res.transforms[:STREAM_WINDOW]).max(axis=(1, 2))
        bad = np.nonzero(gap > 1e-6)[0]
        for i in bad:
            log(f"  path S2 pair {i} ({fams[i % 3]}): |T difference| {gap[i]:.3g}; fitness "
                f"{res.ransac_fitness[i]:.6f} (S1) vs {half.ransac_fitness[i]:.6f}; retried "
                f"{i in res.retry_pairs} (S1) / {i in half.retry_pairs}")
        log(f"path S2 (the first {STREAM_WINDOW} pairs at window {STREAM_WINDOW // 2}): max "
            f"|T difference| to S1 {gap.max():.3g} (limit 1e-6), {len(bad)} pairs outside; "
            f"retried {len(half.retry_pairs)} (S1: "
            f"{sum(1 for j in res.retry_pairs if j < STREAM_WINDOW)} of these pairs)")
        if len(bad):
            fail(f"path S2: {len(bad)} pairs differ from S1 by more than 1e-6")

        # --- S3: the generic path ------------------------------------------------
        generic = run(STREAM_GENERIC_PAIRS, STREAM_WINDOW, fuse_device=False)
        rot3, t3 = apart(torch.from_numpy(generic.transforms),
                         torch.from_numpy(res.transforms[:STREAM_GENERIC_PAIRS]))
        log(f"path S3 (the first {STREAM_GENERIC_PAIRS} pairs, fuse_device=False: kNN features, "
            f"capacity buckets {sorted(set(generic.bucket_of_pair))}): vs S1 rot {rot3:.4f} deg, "
            f"t {t3:.3g} (limits 0.5, 0.02)")
        if rot3 >= 0.5 or t3 >= 0.02:
            g_rot, _ = fused_gate(torch.from_numpy(generic.transforms),
                                  np.stack(trues[:STREAM_GENERIC_PAIRS]),
                                  np.stack([m[0] for m in moments[:STREAM_GENERIC_PAIRS]]),
                                  np.stack([m[1] for m in moments[:STREAM_GENERIC_PAIRS]]))
            for i in range(STREAM_GENERIC_PAIRS):
                r_i, t_i = apart(torch.from_numpy(generic.transforms[i:i + 1]),
                                 torch.from_numpy(res.transforms[i:i + 1]))
                if r_i >= 0.5 or t_i >= 0.02:
                    log(f"  path S3 pair {i} ({fams[i % 3]}): rot {r_i:.4f} deg, t {t_i:.3g}; "
                        f"to the truth: S1 {rot[i]:.4f} deg, generic {g_rot[i]:.4f} deg; "
                        f"retried in S1 {i in res.retry_pairs}")
            fail(f"path S3: the generic path differs from S1 by rot {rot3:.4f} deg, t {t3:.3g}")

        # --- S4: the CPU -----------------------------------------------------------
        t0 = time.time()
        cpu = run(3, 3, device="cpu")
        note = agree_cpu("path S4 pairs 0-2", torch.from_numpy(res.transforms[:3]),
                         torch.from_numpy(cpu.transforms))
        log(f"path S4 (pairs 0-2, one of each family, fused on the CPU with the same bits, "
            f"retried {cpu.retry_pairs}): vs S1 {note}; {time.time() - t0:.1f} s")

        # --- S5: batched dense features against per-cloud --------------------------
        hosts = stream._iter_host_windows(paths[:STREAM_WINDOW], pp.voxel_size,
                                          window=STREAM_WINDOW, workers=None, down_cap=STREAM_CAP)
        _, pts, masks, _ = next(hosts)
        hosts.close()
        pts_d, masks_d = torch.from_numpy(pts).to(dev), torch.from_numpy(masks).to(dev)
        clouds = PointCloud(pts_d, masks_d, torch.zeros_like(pts_d),
                            torch.zeros(pts_d.shape[:2] + (0,), device=dev))

        def dense(pc):
            return down_features_dense(pc, pp.normal_radius, pp.fpfh_radius,
                                       normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn)

        dense(clouds)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        batched = dense(clouds)
        end.record()
        torch.cuda.synchronize()
        dense_ms = start.elapsed_time(end)
        planes = (torch.cuda.max_memory_allocated() - base) / (4 * len(pts) * STREAM_CAP ** 2)
        start.record()
        single = [dense(PointCloud(*(x[i] for x in (clouds.points, clouds.mask, clouds.normals,
                                                    clouds.features))))
                  for i in range(len(pts))]
        end.record()
        torch.cuda.synchronize()
        single_ms = start.elapsed_time(end)
        diff = max(max(float((s.normals - batched.normals[i]).abs().max()),
                       float((s.features - batched.features[i]).abs().max()))
                   for i, s in enumerate(single))
        equal = sum(torch.equal(s.normals, batched.normals[i])
                    and torch.equal(s.features, batched.features[i])
                    for i, s in enumerate(single))
        log(f"path S5 (down_features_dense on window 1's {len(pts)} clouds at capacity "
            f"{STREAM_CAP}): batched {dense_ms:.2f} ms (CUDA events), {planes:.2f} [C, M, M] fp32 "
            f"planes of temporaries at peak; per cloud {single_ms:.2f} ms "
            f"({single_ms / len(pts):.2f} ms a cloud); {equal} of {len(pts)} clouds equal bit for "
            f"bit, largest difference {diff:.3g}")
        if equal != len(pts):
            fail(f"path S5: {len(pts) - equal} clouds' batched dense features differ from "
                 f"per-cloud ones (largest difference {diff:.3g})")

        # --- the device-only rate and one profiled window --------------------------
        rate = stream.measure_fused_device_rate(
            cfg, window=STREAM_WINDOW, down_cap=STREAM_CAP, ransac_iterations=HYPOTHESES,
            icp_iterations=ICP_ITERS, icp_solves_per_nn=ICP_SOLVES_PER_NN, approx_score=True,
            rescue_restarts=RESCUE_RESTARTS, device=dev)
        log(f"path S measure_fused_device_rate (window {STREAM_WINDOW} of random clouds on the "
            f"device, features + fused step, median of 3): {rate:.2f} pairs/s")
        step = stream._FusedWindow(cfg, HYPOTHESES, ICP_ITERS, ICP_SOLVES_PER_NN, True,
                                   RESCUE_RESTARTS, rescue_modes=RESCUE_MODES,
                                   sample_mode="roll", dense_features=True)
        profile_report(lambda: step(pts_d, masks_d, bits[:STREAM_WINDOW], dev), "path S window 1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"S": counts}


def row_sums_case(dev, cap: int) -> dict:
    """The ordered-row-sum kernel (a port-only repair) at the fused step's
    ICP shape: one row a normal-equation entry, LANES x 27 rows of ``cap``
    products, held bit for bit against its plain version."""
    import torch

    from tpu3dm_torch.ops import rowsum

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((LANES, 27, cap), generator=gen, device=dev)
    got, want = rowsum.row_sums(x), rowsum.row_sums_plain(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"row_sums: the kernel differs from its plain version by up to {err:.3g} "
             f"(bit-equal expected)")
    # Needed work: each input float read once and added once, one float a row out.
    return dict(
        agree=1.0, max_abs_err=err,
        ms=cuda_ms(lambda: rowsum.row_sums(x), 20),
        plain_ms=cuda_ms(lambda: rowsum.row_sums_plain(x), 3),
        library_ms=cuda_ms(lambda: torch.sum(x, dim=-1), 20),
        bound=bound_ms(4 * x.numel() + 4 * LANES * 27, (float(x.numel()), PEAK_FP32_OPS)),
        shape=f"{LANES} lanes x 27 rows x {cap} (the ICP's normal equations)",
    )


def serve_paths(dev, cfg) -> dict:
    """Path V: the serving tier at ServeConfig's defaults on the card.  A
    RegistrationServer on loopback port 0, prewarmed at SERVE_CAPS, takes
    SERVE_REQUESTS requests from SERVE_CLIENTS client threads: half inline
    base64 pairs (the PAIRS benchmark pairs), half path specs of
    SERVE_SOURCES moved, re-noised copies of pair 0's source against that
    source as one shared target PLY (the resident-target route and the cloud
    cache).  Every response ok and gated; run at pipeline_depth 0, then 1.
    Then one request alone against the same request first among
    SERVE_FLOOD, bit for bit, and Q2: MESH_SERVE_REQUESTS requests through
    ServeEngine(mesh=4x1) against the same without the mesh.  Returns {"V":
    the launch counts of the depth-0 run, "Q2V": Q2's}."""
    import dataclasses
    import tempfile
    import threading

    import torch

    from tpu3dm_torch.core.se3 import exp_se3
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.io.ply import write_ply
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch
    from tpu3dm_torch.serve import RegistrationClient, RegistrationServer, ServeConfig, ServeEngine

    pairs = [make_benchmark_pair(N_POINTS, seed=s, sigma=0.01) for s in range(PAIRS)]
    sp0 = pairs[0][0].astype(np.float32)
    rng = np.random.default_rng(31)
    moved = []  # (points, T_true): a copy moved by M registers onto sp0 by inv(M)
    for _ in range(SERVE_SOURCES):
        axis = rng.normal(size=3)
        xi = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                             axis / np.linalg.norm(axis) * np.radians(rng.uniform(10, 40))])
        M = exp_se3(torch.tensor(xi, dtype=torch.float64)).numpy()
        pts = (sp0 @ M[:3, :3].T + M[:3, 3] + rng.normal(0, 0.01, sp0.shape)).astype(np.float32)
        moved.append((pts, np.linalg.inv(M)))

    def moments(p):
        p = p.astype(np.float64)
        return p.mean(0), p.T @ p / p.shape[0]

    serve = ServeConfig()
    with tempfile.TemporaryDirectory() as tmp:
        target_path = f"{tmp}/target.ply"
        write_ply(target_path, sp0)
        source_paths = []
        for k, (pts, _) in enumerate(moved):
            source_paths.append(f"{tmp}/source{k}.ply")
            write_ply(source_paths[-1], pts)
        # Request i: even -> inline pair i/2 mod PAIRS; odd -> path source.
        requests = []
        for i in range(SERVE_REQUESTS):
            if i % 2 == 0:
                s, t, T = pairs[(i // 2) % PAIRS]
                requests.append((s.astype(np.float32), t.astype(np.float32), T, moments(s)))
            else:
                k = (i // 2) % SERVE_SOURCES
                requests.append((source_paths[k], target_path, moved[k][1],
                                 moments(moved[k][0])))

        def flood(depth: int):
            server = RegistrationServer(port=0, pipeline=cfg, device=dev,
                                        serve=dataclasses.replace(serve, pipeline_depth=depth))
            with server:
                prewarm_s = server.prewarm(caps=SERVE_CAPS, batch_sizes=[SERVE_CLIENTS])
                responses, errors = [None] * SERVE_REQUESTS, []

                def client(c):
                    try:
                        with RegistrationClient(server.host, server.port, timeout=600) as cl:
                            for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                                responses[i] = cl.register(requests[i][0], requests[i][1])
                    except Exception as e:  # noqa: BLE001 - failed below
                        errors.append(f"client {c}: {type(e).__name__}: {e}")

                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.time()
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(SERVE_CLIENTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=900)
                wall = time.time() - t0
                counts = {k: v.launches for k, v in KERNELS.items()}
                st = server.engine.stats()
                cache = dict(hits=server.cache.hits, misses=server.cache.misses)
            if errors or any(th.is_alive() for th in threads) or None in responses:
                fail(f"path V depth {depth}: {len(errors)} failed clients: {errors[:3]}")
            T = torch.tensor(np.stack([r["transformation"] for r in responses]))
            T_true = np.stack([r[2] for r in requests])
            mu = np.stack([r[3][0] for r in requests])
            M2 = np.stack([r[3][1] for r in requests])
            worst = gate_lanes(f"path V depth {depth}", T, T_true, mu, M2)
            for k in SERVE_KERNELS:
                if counts[k] == 0:
                    fail(f"path V depth {depth}: {k} was never launched ({counts})")
            n_b = st["batches"]
            lat = st["latency_ms"]
            log(f"path V depth {depth} ({SERVE_REQUESTS} requests, {SERVE_CLIENTS} clients, "
                f"ServeConfig defaults, prewarm {prewarm_s:.2f} s): {wall:.2f} s -> "
                f"{SERVE_REQUESTS / wall:.1f} req/s; latency p50 {lat['p50']:.1f} ms, p95 "
                f"{lat['p95']:.1f} ms; queue p50 {st['queue_ms']['p50']:.2f} ms, pack p50 "
                f"{st['pack_ms_per_batch']['p50']:.1f} ms, device p50 "
                f"{st['device_ms_per_batch']['p50']:.2f} ms a micro-batch; {n_b} micro-batches, "
                f"mean size {st['mean_batch_size']:.2f}, max {st['max_batch_size']}; buckets "
                f"{st['buckets']}; shared-target requests {st['shared_target_requests']}; cloud "
                f"cache {cache}; launches a micro-batch "
                f"{ {k: round(counts[k] / n_b, 2) for k in SERVE_KERNELS} }; {worst}")
            return counts

        counts0 = flood(0)
        flood(1)

    # One request alone, and the same request first among SERVE_FLOOD.
    pp = cfg.preprocess

    def prep(p):
        return preprocess_points_batch([p], pp, full_normals=False, device=dev)[0]

    target = prep(sp0)
    shared = [prep(p) for p, _ in moved]
    inline = [(prep(s.astype(np.float32)), prep(t.astype(np.float32))) for s, t, _ in pairs]
    # Odd requests: inline pairs, each its own cloud objects (as the server
    # decodes them), so they take the pair route; even ones the shared target.
    flood_pairs = [(shared[i % SERVE_SOURCES], target) if i % 2 == 0 else
                   tuple(dataclasses.replace(c) for c in inline[i % PAIRS])
                   for i in range(SERVE_FLOOD)]
    with ServeEngine(cfg, serve, device=dev) as eng:
        solo = eng.register(*flood_pairs[0], timeout=600)
    with ServeEngine(cfg, serve, device=dev) as eng:
        futs = [eng.submit(*p) for p in flood_pairs]
        in_flood = futs[0].result(timeout=600)
        for f in futs[1:]:
            f.result(timeout=600)
        st = eng.stats()
    same = (np.array_equal(solo.transformation, in_flood.transformation)
            and solo.fitness == in_flood.fitness and solo.inlier_rmse == in_flood.inlier_rmse)
    gap = float(np.abs(solo.transformation - in_flood.transformation).max())
    if not same:
        fail(f"path V: request 0 alone differs from request 0 of a {SERVE_FLOOD}-request flood "
             f"by {gap:.3g} (bit-equal expected)")
    log(f"path V: request 0 alone (a micro-batch of 1, the pair route) equals request 0 of a "
        f"{SERVE_FLOOD}-request flood ({st['batches']} micro-batches, mean size "
        f"{st['mean_batch_size']:.1f}, {st['shared_target_requests']} on the resident route) "
        f"bit for bit")
    # The engine alone on the flood's workload, its clouds preprocessed once:
    # SERVE_CLIENTS threads each waiting for its request before sending the
    # next (as the clients do), then all SERVE_REQUESTS submitted at once; and
    # one profiled micro-batch of SERVE_CLIENTS requests.
    work = [flood_pairs[i % SERVE_FLOOD] if i % 2 == 0 else
            tuple(dataclasses.replace(c) for c in flood_pairs[i % SERVE_FLOOD])
            for i in range(SERVE_REQUESTS)]
    for mode in ("clients", "at once"):
        with ServeEngine(cfg, serve, device=dev) as eng:
            t0 = time.time()
            if mode == "clients":
                def client(c, eng=eng):
                    for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                        eng.register(*work[i], timeout=600)

                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(SERVE_CLIENTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=900)
            else:
                for f in [eng.submit(*w) for w in work]:
                    f.result(timeout=600)
            wall = time.time() - t0
            st = eng.stats()
            if mode == "clients":
                profile_report(lambda eng=eng: [f.result(timeout=600) for f in [
                    eng.submit(*w) for w in work[:SERVE_CLIENTS]]],
                    f"path V engine, one micro-batch of {SERVE_CLIENTS}")
        log(f"path V engine alone ({mode}, {SERVE_REQUESTS} preprocessed requests): {wall:.2f} s "
            f"-> {SERVE_REQUESTS / wall:.1f} req/s; latency p50 {st['latency_ms']['p50']:.1f} "
            f"ms; pack p50 {st['pack_ms_per_batch']['p50']:.1f} ms, device p50 "
            f"{st['device_ms_per_batch']['p50']:.2f} ms a micro-batch; {st['batches']} "
            f"micro-batches, mean size {st['mean_batch_size']:.2f}")
    # Q2: MESH_SERVE_REQUESTS of the flood's requests through an engine whose
    # micro-batches split over a 4x1 mesh on the card (no resident route),
    # against the same requests without the mesh.
    truth = [(moved[i % SERVE_SOURCES][1], moments(moved[i % SERVE_SOURCES][0])) if i % 2 == 0
             else (pairs[i % PAIRS][2], moments(pairs[i % PAIRS][0]))
             for i in range(MESH_SERVE_REQUESTS)]

    def engine_run(mesh):
        reqs = [p if i % 2 == 0 else tuple(dataclasses.replace(c) for c in p)
                for i, p in enumerate(flood_pairs[:MESH_SERVE_REQUESTS])]
        with ServeEngine(cfg, serve, mesh=mesh, device=dev) as eng:
            futs = [eng.submit(*p) for p in reqs]
            got = [f.result(timeout=600) for f in futs]
            return got, eng.stats()

    plain, _ = engine_run(None)
    mesh = card_mesh(dev, MESH_N, 1)
    (meshed, st), q_counts, q_wall, _ = counted(
        f"path Q2 ServeEngine(mesh={MESH_N}x1)", lambda: engine_run(mesh),
        {k: (lambda n: n > 0) for k in MESH_KERNELS})
    if st["shared_target_requests"] or st["errors"]:
        fail(f"path Q2 serve: {st['shared_target_requests']} requests on the resident route, "
             f"{st['errors']} errors (none expected under a mesh)")
    worst = gate_lanes("path Q2 serve", torch.tensor(np.stack([r.transformation for r in meshed])),
                       np.stack([t[0] for t in truth]), np.stack([t[1][0] for t in truth]),
                       np.stack([t[1][1] for t in truth]))
    for i in range(1, MESH_SERVE_REQUESTS, 2):  # the inline pairs
        a, b = meshed[i], plain[i]
        if not (np.array_equal(a.transformation, b.transformation) and a.fitness == b.fitness
                and a.inlier_rmse == b.inlier_rmse):
            fail(f"path Q2 serve: inline request {i} differs from the engine without the mesh")
    log(f"path Q2 (ServeEngine(mesh={MESH_N}x1), {MESH_SERVE_REQUESTS} requests, half inline "
        f"pairs, half against one shared target): {q_wall:.2f} s, {st['batches']} micro-batches, "
        f"none on the resident route; every response ok, {worst}; the inline requests bit-equal "
        f"to the engine without the mesh; launches { {k: q_counts[k] for k in MESH_KERNELS} }")
    return {"V": counts0, "Q2V": q_counts}


def pipeline_paths(dev, cfg) -> dict:
    """Path P: ``register_files`` on two PAIRS-benchmark arch PLYs
    (make_benchmark_pair(N_POINTS, seed=0, sigma=0.01), written by the
    port's write_ply) at voxel 0.3, with restarts 1 and 4, each cold and
    warm, launch counts zeroed before and read after each call, the stage
    times from the port's profiler, each call gated (< 2 deg, alignment RMSE
    < 0.1); restarts 1 again on the CPU with the same bits; then Q5
    (sharded) on the same pair.  Returns {"P": restarts 1's warm counts,
    "P4": restarts 4's, "Q5s": Q5's}."""
    import tempfile

    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.io.ply import write_ply
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.pipeline import register_files
    from tpu3dm_torch.registration.ransac import chunk_count
    from tpu3dm_torch.utils.profiler import Profiler

    sp, tp, T_true = make_benchmark_pair(N_POINTS, seed=0, sigma=0.01)
    sp, tp = sp.astype(np.float32), tp.astype(np.float32)
    mu, M2 = sp.astype(np.float64).mean(0), sp.T.astype(np.float64) @ sp / sp.shape[0]
    r = cfg.ransac
    shape = (chunk_count(r.max_iterations, r.batch_size), r.batch_size, 2)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, tgt = f"{tmp}/source.ply", f"{tmp}/target.ply"
        write_ply(src, sp)
        write_ply(tgt, tp)
        for restarts in PIPELINE_RESTARTS:
            lead = () if restarts == 1 else (restarts,)
            bits = draw_bits(lead + shape, torch.Generator().manual_seed(restarts))
            walls = []
            for run in ("cold", "warm"):
                Profiler.reset()
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.time()
                res = register_files(src, tgt, cfg, sample_bits=bits, restarts=restarts,
                                     device=dev)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
                counts = {k: v.launches for k, v in KERNELS.items()}
                stages = {k: round(v.total * 1e3, 1) for k, v in Profiler.get_stats().items()}
                for k in PIPELINE_KERNELS:
                    if counts[k] == 0:
                        fail(f"path P restarts {restarts} ({run}): {k} was never launched")
            worst = gate_lanes(f"path P restarts {restarts}", res.transformation[None],
                               T_true[None], mu[None], M2[None])
            out["P" if restarts == 1 else f"P{restarts}"] = counts
            note = ""
            if restarts == 1:
                t0 = time.time()
                ref = register_files(src, tgt, cfg, sample_bits=bits, device="cpu")
                cpu_s = time.time() - t0
                note = (f"; CPU ({cpu_s:.1f} s): " + agree_cpu(
                    "path P", res.transformation[None], ref.transformation[None]))
            log(f"path P restarts {restarts} (register_files, {N_POINTS} + {N_POINTS} points, "
                f"voxel {cfg.preprocess.voxel_size}): cold {walls[0]:.3f} s, warm "
                f"{walls[1]:.3f} s; warm stages (ms) {stages}; RANSAC fitness "
                f"{float(res.ransac.fitness):.4f}, {int(res.ransac.iterations)} hypotheses; ICP "
                f"{int(res.icp.iterations)} iterations, fitness {float(res.icp.fitness):.4f}, "
                f"rmse {float(res.icp.inlier_rmse):.5f}; launches "
                f"{ {k: counts[k] for k in PIPELINE_KERNELS} }; {worst}{note}")
    out["Q5s"] = sharded_ransac_path(dev, cfg, sp, tp, T_true, mu, M2)
    return out


def sharded_ransac_path(dev, cfg, sp, tp, T_true, mu, M2) -> dict:
    """Q5 (sharded): path P's pair preprocessed on the card, its FPFH
    correspondences, then ``sharded_ransac`` with the config's 100,000
    hypotheses over a 1x4 block mesh on the card (fp32 score), counted;
    the elected 3-point pose refined by P's full-resolution ICP and held to
    P's gate (the raw pose's error printed beside it).  Returns the counts."""
    import torch

    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs
    from tpu3dm_torch.registration.icp import refine_registration
    from tpu3dm_torch.parallel.sharded_ransac import sharded_ransac

    ps, pt = preprocess_points(sp, cfg.preprocess, device=dev), preprocess_points(
        tp, cfg.preprocess, device=dev)
    pairs, valid = feature_correspondences(ps.down, pt.down, mutual_filter=cfg.ransac.mutual_filter)
    p_all, q_all = gather_pairs(ps.down, pt.down, pairs)
    mesh = card_mesh(dev, 1, MESH_N)
    res, counts, wall, _ = counted(
        f"path Q5 sharded_ransac (1x{MESH_N})",
        lambda: sharded_ransac(mesh, p_all, q_all, valid, generator=torch.Generator().manual_seed(0),
                               dist_thresh=cfg.ransac.dist_thresh,
                               iterations=cfg.ransac.max_iterations),
        {"ransac_score": lambda n: n >= MESH_N})
    raw_rot, raw_rmse = fused_gate(res.transformation[None], T_true[None], mu[None], M2[None])
    fine = refine_registration(ps.full, pt.full, res.transformation, cfg.icp)
    worst = gate_lanes("path Q5 sharded_ransac + ICP", fine.transformation[None], T_true[None],
                       mu[None], M2[None])
    log(f"path Q5 (sharded_ransac on 1x{MESH_N}, path P's pair: {int(valid.sum())} valid of "
        f"{valid.shape[0]} correspondences, {int(res.iterations)} hypotheses, the fp32 score): "
        f"{wall * 1e3:.1f} ms; fitness {float(res.fitness):.4f}, inlier rmse "
        f"{float(res.inlier_rmse):.4f}; the elected 3-point pose rot {raw_rot[0]:.4f} deg, rmse "
        f"{raw_rmse[0]:.4f}; after P's ICP {worst}; launches ransac_score "
        f"{counts['ransac_score']}")
    return counts


def multiway_views(n_clouds: int, n_points: int):
    """JAX's run_multiway_benchmark data (tpu3dm/apps/benchmark.py:384-476):
    view k is dental_arch_cloud(n_points, seed=0) under rand_T(k) (view 0
    under the identity) plus sigma 0.01 noise, one generator seeded 0 across
    the views.  Returns (views, trues [n, 4, 4])."""
    from tpu3dm_torch.io.synthetic import dental_arch_cloud

    rng = np.random.default_rng(0)
    base = dental_arch_cloud(n_points, seed=0)
    center = base.mean(axis=0)

    def rand_T(k):
        r = np.random.default_rng(1000 + k)
        a, b, c = r.uniform(-np.pi / 6, np.pi / 6, size=3)
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        R = rz @ ry @ rx
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ center + center + r.uniform(-0.5, 0.5, size=3)
        return T

    trues = np.stack([np.eye(4)] + [rand_T(k) for k in range(1, n_clouds)])
    views = [(base @ T[:3, :3].T + T[:3, 3] + 0.01 * rng.standard_normal(base.shape))
             .astype(np.float32) for T in trues]
    return views, trues


def rot_deg(Ta, Tb) -> np.ndarray:
    """Rotation (deg) between [..., 4, 4] pose sets, from the Frobenius gap
    (exact near 0)."""
    d = np.asarray(Ta, np.float64)[..., :3, :3] - np.asarray(Tb, np.float64)[..., :3, :3]
    fro = np.sqrt((d * d).sum((-2, -1)))
    return np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


def multiway_case(label: str, clouds, trues, dev, cfg, *, gate_poses: bool,
                  mesh_check: bool = False) -> dict:
    """``register_multiway_batched`` over the chain + loop-closure edges of
    ``clouds`` at run_multiway_benchmark's settings (rescue_restarts 2,
    robust_delta 0.1, 20 pose-graph iterations), one bit set for every call:
    a cold call, then three warm calls (launch counts zeroed before the
    first and read after it); every edge gated (< 2 deg against its true
    relative transform) and, with ``gate_poses``, every pose (< 2 deg
    against its truth); edges 0-3 against the CPU with the same bits;
    the pose graph solved on the CPU from the card's edges against the
    card's poses (agree_cpu's bounds); edge 0 alone bit-equal to edge 0 in
    its chunk; the warm calls' results bit-equal; with ``mesh_check`` (Q2)
    one more call with the edges split over a 4x1 mesh on the card, counted,
    its edges and poses bit-equal to the warm calls'.  Returns {label: the
    counted call's launch counts} (and "Q2M": the mesh call's)."""
    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.multiway import posegraph
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.batch import pair_bits_shape

    n = len(clouds)
    edges = posegraph.default_edges(n)
    cap = max(c.down.capacity for c in clouds)
    shape = pair_bits_shape(cap, rescue_restarts=MULTIWAY_RESCUE)[0]
    gen = torch.Generator().manual_seed(0)
    bits = torch.stack([draw_bits(shape, gen) for _ in edges])
    kw = dict(rescue_restarts=MULTIWAY_RESCUE, robust_delta=MULTIWAY_ROBUST, edge_bits=bits)

    def call(device=dev, **over):
        torch.cuda.synchronize()
        t0 = time.time()
        out = posegraph.register_multiway_batched(clouds, cfg, device=device, **{**kw, **over})
        torch.cuda.synchronize()
        return out, time.time() - t0

    _, cold_s = call()
    reset_launch_counts()
    res, first_s = call()
    counts = {k: v.launches for k, v in KERNELS.items()}
    for k in MULTIWAY_KERNELS:
        if counts[k] == 0:
            fail(f"path {label}: {k} was never launched")
    warm = [first_s]
    for _ in range(2):
        again, s = call()
        warm.append(s)
        for f in ("poses", "edge_transforms", "edge_fitness"):
            if not np.array_equal(getattr(again, f), getattr(res, f)):
                fail(f"path {label}: two warm calls differ in {f}")
    warm_s = float(np.median(warm))
    out = {label: counts}
    if mesh_check:
        mesh = card_mesh(dev, MESH_N, 1)
        (meshed, _), out["Q2M"], mesh_s, _ = counted(
            f"path Q2 register_multiway_batched(mesh={MESH_N}x1)", lambda: call(mesh=mesh),
            {k: (lambda n: n > 0) for k in MULTIWAY_KERNELS})
        for f in ("poses", "edges", "edge_transforms", "edge_fitness"):
            if not np.array_equal(getattr(meshed, f), getattr(res, f)):
                fail(f"path Q2 multiway: the {MESH_N}x1 mesh call differs in {f} (bit-equal "
                     f"expected)")
        log(f"path Q2 (register_multiway_batched, {label}'s {n} views, mesh {MESH_N}x1 on one "
            f"card): {mesh_s:.3f} s, edges and poses bit-equal to the call without the mesh; "
            f"launches { {k: out['Q2M'][k] for k in MULTIWAY_KERNELS} }")

    rel_true = np.stack([trues[j] @ np.linalg.inv(trues[i]) for i, j in edges])
    edge_err = rot_deg(res.edge_transforms, rel_true)
    if not (np.isfinite(res.poses).all() and edge_err.max() < 2.0):
        fail(f"path {label}: worst edge {edge_err.max():.3f} deg (gate 2 deg)")
    note = ""
    if gate_poses:
        pose_err = rot_deg(res.poses, np.linalg.inv(trues))
        if pose_err.max() >= 2.0:
            fail(f"path {label}: worst pose {pose_err.max():.3f} deg (gate 2 deg)")
        note = f", worst pose {pose_err.max():.4f} deg"

    # The pose graph alone on the card (its share of a call), then on the CPU
    # from the card's edges.
    T_meas = torch.as_tensor(res.edge_transforms, device=dev)
    w = torch.as_tensor(res.edge_fitness.astype(np.float32), device=dev)
    solve = dict(n_nodes=n, iterations=20, robust_delta=MULTIWAY_ROBUST)
    pg_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        posegraph._solve_pose_graph(T_meas, edges, w, **solve)
        torch.cuda.synchronize()
        pg_times.append(time.time() - t0)
    pg_s = float(np.median(pg_times))
    t0 = time.time()
    cpu_poses = posegraph._solve_pose_graph(T_meas.cpu(), edges, w.cpu(), **solve)
    pg_cpu_s = time.time() - t0
    pg_rot, pg_t = apart(torch.as_tensor(res.poses), cpu_poses)
    if pg_rot >= PG_AGREE_DEG or pg_t >= PG_AGREE_T:
        fail(f"path {label}: the pose graph on the card and on the CPU differ: rot "
             f"{pg_rot:.4f} deg, t {pg_t:.4g}")
    pg_agree = f"rot {pg_rot:.4f} deg, t {pg_t:.3g}"

    alone, _ = call(edges=edges[:1], edge_bits=bits[:1], pose_graph_iters=0)
    if not (np.array_equal(alone.edge_transforms[0], res.edge_transforms[0])
            and alone.edge_fitness[0] == res.edge_fitness[0]):
        fail(f"path {label}: edge 0 alone differs from edge 0 in its "
             f"{min(posegraph.EDGE_CHUNK, len(edges))}-edge chunk")
    t0 = time.time()
    ref = posegraph.register_multiway_batched(clouds, cfg, device="cpu", edges=edges[:4],
                                              pose_graph_iters=0, **{**kw, "edge_bits": bits[:4]})
    cpu_s = time.time() - t0
    edge_agree = agree_cpu(f"path {label} edges 0-3", torch.as_tensor(res.edge_transforms[:4]),
                           torch.as_tensor(ref.edge_transforms))
    log(f"path {label} (register_multiway_batched, {n} clouds of {MULTIWAY_POINTS} points, "
        f"{len(edges)} edges, cap {cap}, rescue {MULTIWAY_RESCUE}, robust {MULTIWAY_ROBUST}): "
        f"cold {cold_s:.3f} s, warm {warm_s:.3f} s median of 3 ({warm[0]:.3f} / {warm[1]:.3f} "
        f"/ {warm[2]:.3f}) -> {len(edges) / warm_s:.1f} edges/s; pose graph "
        f"({'edgewise' if n >= posegraph._EDGEWISE_THRESHOLD else 'dense'}) {pg_s * 1e3:.1f} ms "
        f"median of 3 "
        f"= {pg_s / warm_s:.1%} of a warm call (CPU {pg_cpu_s:.2f} s); edges: worst "
        f"{edge_err.max():.4f} deg, mean {edge_err.mean():.4f} deg, least fitness "
        f"{res.edge_fitness.min():.4f}{note}; launches "
        f"{ {k: counts[k] for k in MULTIWAY_KERNELS} }; card vs CPU: pose graph {pg_agree}, "
        f"edges 0-3 {edge_agree} (CPU {cpu_s:.1f} s); edge 0 alone bit-equal, warm calls "
        f"bit-equal")
    return out


def multiway_paths(dev, cfg) -> dict:
    """Paths M1-M3, the multi-way registration (multiway/posegraph.py).  M1:
    run_multiway_benchmark(256)'s shape (MULTIWAY_CLOUDS views of a
    20k-point arch, preprocess_points_batch(full_normals=False) at voxel
    0.3, the edgewise pose graph); M2: its first MULTIWAY_SMALL views (the
    dense jacfwd solve), poses gated too, one profiled call; M3:
    ``register_multiway`` on RESUME_CLOUDS views with full-resolution
    normals into a checkpoint directory, one edge record deleted, run
    again: bit-equal.  Q2: M1's call again over a 4x1 mesh.  Returns {"M1",
    "M2", "M3", "Q2M": launch counts}."""
    import os
    import tempfile

    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.multiway import posegraph
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    views, trues = multiway_views(MULTIWAY_CLOUDS, MULTIWAY_POINTS)
    out = {}
    for label, n in (("M1", MULTIWAY_CLOUDS), ("M2", MULTIWAY_SMALL)):
        torch.cuda.synchronize()
        t0 = time.time()
        clouds = preprocess_points_batch(views[:n], cfg.preprocess, full_normals=False,
                                         device=dev)
        torch.cuda.synchronize()
        log(f"path {label} ingest: {n} clouds in {time.time() - t0:.3f} s "
            f"(preprocess_points_batch, full_normals=False, cap {clouds[0].down.capacity})")
        out.update(multiway_case(label, clouds, trues[:n], dev, cfg, gate_poses=label == "M2",
                                 mesh_check=label == "M1"))
        torch.cuda.empty_cache()
    profile_report(lambda: posegraph.register_multiway_batched(
        clouds, cfg, device=dev, rescue_restarts=MULTIWAY_RESCUE,
        robust_delta=MULTIWAY_ROBUST), "path M2")

    fulls = preprocess_points_batch(views[:RESUME_CLOUDS], cfg.preprocess, full_normals=True,
                                    device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for run in ("first", "resumed"):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.time()
            res = posegraph.register_multiway(fulls, cfg, generator=torch.Generator().manual_seed(0),
                                              checkpoint_dir=tmp, device=dev)
            torch.cuda.synchronize()
            runs.append((res, time.time() - t0, {k: v.launches for k, v in KERNELS.items()}))
            if run == "first":
                os.remove(os.path.join(tmp, "edge_0001_0002.npz"))
    (first, first_s, counts), (again, again_s, again_counts) = runs
    for k in MULTIWAY_FULL_KERNELS:
        if counts[k] == 0:
            fail(f"path M3: {k} was never launched")
    for f in ("poses", "edge_transforms", "edge_fitness"):
        if not np.array_equal(getattr(first, f), getattr(again, f)):
            fail(f"path M3: the resumed run differs in {f}")
    edges = posegraph.default_edges(RESUME_CLOUDS)
    rel_true = np.stack([trues[j] @ np.linalg.inv(trues[i]) for i, j in edges])
    edge_err = rot_deg(first.edge_transforms, rel_true)
    pose_err = rot_deg(first.poses, np.linalg.inv(trues[:RESUME_CLOUDS]))
    if edge_err.max() >= 2.0 or pose_err.max() >= 2.0:
        fail(f"path M3: worst edge {edge_err.max():.3f} deg, pose {pose_err.max():.3f} deg")
    log(f"path M3 (register_multiway, {RESUME_CLOUDS} clouds of {MULTIWAY_POINTS} points with "
        f"full-resolution normals, {len(edges)} edges): {first_s:.3f} s, resumed after one "
        f"edge record was deleted {again_s:.3f} s, bit-equal; worst edge {edge_err.max():.4f} "
        f"deg, worst pose {pose_err.max():.4f} deg; launches "
        f"{ {k: counts[k] for k in MULTIWAY_FULL_KERNELS} } (resumed: "
        f"{ {k: again_counts[k] for k in MULTIWAY_FULL_KERNELS} })")
    out["M3"] = counts
    return out


def feature_route_paths(dev, cfg) -> dict:
    """Path R, the feature routes without the shared scan:
    ``preprocess_points_batch`` on phase 3's 16 clouds (full_normals=False)
    with each of FEATURE_ROUTES, cold and warm, launch counts zeroed before
    the warm call; clouds 0-1 against the same on the CPU within the CPU
    tests' bounds (``features_agree``).  Returns {"R": the counts}."""
    import dataclasses

    import torch

    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    raw = [c for s in range(PAIRS) for c in make_benchmark_pair(N_POINTS, seed=s, sigma=0.01)[:2]]
    counts = {}
    for name, over in FEATURE_ROUTES:
        pp = dataclasses.replace(cfg.preprocess, **over)
        walls = []
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.time()
            procs = preprocess_points_batch(raw, pp, full_normals=False, device=dev)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        for k, v in KERNELS.items():
            counts[k] = counts.get(k, 0) + v.launches
        t0 = time.time()
        ref = preprocess_points_batch(raw[:2], pp, full_normals=False, device="cpu",
                                      down_cap=procs[0].down.capacity)
        cpu_s = time.time() - t0
        worst = [features_agree(f"path R {name} cloud {i}", procs[i].down, ref[i].down)
                 for i in range(2)]
        log(f"path R {name} ({over}): {len(raw)} clouds, cap {procs[0].down.capacity}: cold "
            f"{walls[0] * 1e3:.1f} ms, warm {walls[1] * 1e3:.1f} ms; clouds 0-1 vs CPU "
            f"({cpu_s:.1f} s): normals dot min {min(w[0] for w in worst):.6f}, FPFH relative "
            f"L1 max {max(w[1] for w in worst):.3g}")
        torch.cuda.empty_cache()
    return {"R": counts}


def crash_paths(dev) -> dict:
    """Path K, the crash suite (apps/crashtest.py) on the card: every case
    must pass, launch counts zeroed before and read after (kernel 3's fp32
    route > 0 required).  Then kernel 3's fp32 route against its plain
    version on the hypotheses the suite's RANSAC cases score (64 rows with
    none valid, 300 rows at five outlier ratios, 50 rows near 1000): counts
    inside the float64 bracket of FP32_CHAIN_REL, equal on >= 99.9% of
    hypotheses, never more than 1 apart, all 0 without a valid row.
    Returns {"K": the suite's counts}."""
    import torch

    from tpu3dm_torch.apps import crashtest
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.ops import ransac_score
    from tpu3dm_torch.registration import hypotheses

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    results = crashtest.run_all_crash_tests(device=dev)
    torch.cuda.synchronize()
    suite_s = time.time() - t0
    counts = {k: v.launches for k, v in KERNELS.items()}
    failed = [f"{r.name} ({r.detail})" for r in results if not r.passed]
    if failed:
        fail(f"path K: crash cases failed on the card: {failed}")
    if counts["ransac_score"] == 0:
        fail("path K: kernel 3's fp32 route was never launched")

    captured = []
    real = hypotheses.score_features

    def capture(H, e, F, c, valid, thresh_sq):
        captured.append((H.clone(), e.clone(), F.clone(), c.clone(), valid.clone(), thresh_sq))
        return real(H, e, F, c, valid, thresh_sq)

    hypotheses.score_features = capture
    try:
        for case in (crashtest.test_zero_correspondences, crashtest.test_noise_ratio_sweep,
                     crashtest.test_degenerate_huge_transform):
            case(dev)
    finally:
        hypotheses.score_features = real
    shapes = {}
    for H, e, F, c, v, thr in captured:
        if H.dtype != torch.float32:
            fail(f"path K: the crash RANSAC scored {H.dtype} features, not fp32")
        ck = ransac_score.score_features(H, e, F, c, v, thr)
        cp = ransac_score.score_features_plain(H, e, F, c, v, thr)
        sure, near = ransac_score.score_count_bracket(H, e, F, c, v, thr,
                                                      ransac_score.FP32_CHAIN_REL)
        diff = (ck - cp).abs()
        outside = sum(int(((x < sure) | (x > sure + near)).sum()) for x in (ck, cp))
        exact = (diff == 0).float().mean().item()
        if outside or (not v.any() and ck.any()):
            fail(f"path K: kernel 3 at K {H.shape[1]} x N {F.shape[1]} disagrees with its plain "
                 f"version: {outside} counts outside the bracket, {exact:.6f} equal")
        key = (H.shape[1], F.shape[1], int(v.sum()))
        prev = shapes.get(key, (0, 1.0, 0))
        shapes[key] = (prev[0] + 1, min(prev[1], exact), max(prev[2], int(diff.max())))
    log(f"path K (run_all_crash_tests on the card): {len(results)}/{len(results)} passed in "
        f"{suite_s:.2f} s; launches: kernel 3 fp32 {counts['ransac_score']}, row_sums "
        f"{counts['row_sums']}; kernel 3 fp32 against its plain version on "
        f"{len(captured)} scored chunks: "
        + ", ".join(f"K {k} x N {n} ({nv} valid) x {c}: equal {ex:.6f}, max diff {d}"
                    for (k, n, nv), (c, ex, d) in sorted(shapes.items())))
    return {"K": counts}


def card_mesh(dev, n_pair: int, n_block: int):
    """A mesh of n_pair x n_block shards on ``dev`` alone (the device
    repeated): the simulated mesh the smoke runs on one card."""
    from tpu3dm_torch.parallel.mesh import make_mesh

    return make_mesh(n_pair, n_block, devices=[dev] * (n_pair * n_block))


def real_mesh(dev, axis: str):
    """A mesh with a shard on each visible card along ``axis`` ("pair" or
    "block"), for Q6; None on a machine with one card."""
    import torch

    from tpu3dm_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 2:
        return None
    return make_mesh(n, 1) if axis == "pair" else make_mesh(1, n)


def mesh_pair_paths(dev, cfg, src, tgt, bits, T_true, mu, M2) -> dict:
    """Q1: ``batched_register`` over the main path's 2048 lanes at bench's
    settings (4096 hypotheses, 8 ICP iterations / 4 solves a search, bf16
    score, the default values_pk route with fp32 features, JAX's knobs) on
    meshes of 1, 2 and 4 pair shards: every pair bit-equal across the
    meshes and to a direct ``fused_register_step`` on the same bits, every
    lane gated, pairs/s for each mesh; with several cards (Q6) once more
    with a shard a card.  Q5 (batched): ``batched_ransac`` on the 4x1 mesh
    over the same lanes' correspondences (the fp32 score), bit-equal to one
    ``ransac_pair_step`` over all of them.  Returns {"Q1": the 4x1 call's
    counts, "Q5b": batched_ransac's (and "Q6": the multi-card Q1's)}."""
    import torch

    from tpu3dm_torch.parallel.multipair import batched_ransac, ransac_pair_step
    from tpu3dm_torch.parallel.register import batched_register
    from tpu3dm_torch.registration.fused import _pn_center, correspondences, fused_register_step

    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=HYPOTHESES, icp_iterations=ICP_ITERS,
              icp_solves_per_nn=ICP_SOLVES_PER_NN, approx_score=True)
    args = [src["points"], src["features"], src["mask"], None,
            tgt["points"], tgt["features"], tgt["mask"], tgt["normals"]]
    direct = fused_register_step(*args, bits, device=dev, ransac_batch=HYPOTHESES, **kw)
    expect = {k: (lambda n: n > 0) for k in MESH_KERNELS}
    out, notes = {}, []
    meshes = [(f"{a}x{b} on one card", card_mesh(dev, a, b)) for a, b in MESH_PAIR_SHAPES]
    many = real_mesh(dev, "pair")
    if many is not None:
        meshes.append((f"{many.shape['pair']}x1, a shard a card (Q6)", many))
    for label, mesh in meshes:
        def call(mesh=mesh):
            return batched_register(mesh, *args, bits, **kw)

        call()  # warm-up
        res, counts, _, peak = counted(f"path Q1 {label}", call, expect)
        for k, name in enumerate(("transforms", "RANSAC fitness", "ICP RMSE")):
            if not torch.equal(res[k].to(dev), direct[k]):
                gap = float((res[k].to(dev).double() - direct[k].double()).abs().max())
                fail(f"path Q1 {label}: {name} differ from the direct fused step by {gap:.3g} "
                     f"(bit-equal expected)")
        worst = gate_lanes(f"path Q1 {label}", res[0], T_true, mu, M2)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            call()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        call_s = float(np.median(times))
        notes.append(f"{label}: {call_s * 1e3:.1f} ms median of 3 -> {LANES / call_s:.1f} "
                     f"pairs/s, peak {peak:.2f} GiB")
        if mesh.shape["pair"] == MESH_N and many is not mesh:
            out["Q1"] = counts
        elif mesh is many:
            out["Q6"] = counts
    log(f"path Q1 (batched_register, {LANES} lanes, {HYPOTHESES} hypotheses, {ICP_ITERS} ICP "
        f"iterations / {ICP_SOLVES_PER_NN} solves a search, bf16 score, values_pk): every mesh "
        f"bit-equal to the direct fused step; {worst}; " + "; ".join(notes)
        + f"; launches (4x1) { {k: out['Q1'][k] for k in MESH_KERNELS} }")
    if many is None:
        log(f"path Q6: the machine has {torch.cuda.device_count()} card(s); Q1 and Q4 with a shard "
            f"a card were not run")

    # Q5 (batched): the fused path's correspondences, its RANSAC on the mesh.
    frame_c = _pn_center(tgt["points"], tgt["mask"])
    sp = (src["points"] - frame_c[:, None]).contiguous()
    tp = (tgt["points"] - frame_c[:, None]).contiguous()
    q_all, valid = correspondences(src["features"], tgt["features"], src["mask"], tgt["mask"], tp)
    rkw = dict(dist_thresh=cfg.ransac.dist_thresh, iterations=HYPOTHESES, batch_size=HYPOTHESES)
    T_ref, c_ref = ransac_pair_step(sp, q_all, valid, bits, **rkw)
    mesh = card_mesh(dev, MESH_N, 1)
    (T_b, f_b), counts, wall, _ = counted(
        "path Q5 batched_ransac", lambda: batched_ransac(mesh, sp, q_all, valid, bits, **rkw),
        {"ransac_score": lambda n: n > 0})
    f_ref = c_ref.to(torch.float32) / torch.clamp_min(valid.sum(-1), 1).to(torch.float32)
    if not (torch.equal(T_b, T_ref) and torch.equal(f_b, f_ref)):
        fail(f"path Q5: batched_ransac on {MESH_N}x1 differs from one ransac_pair_step by "
             f"{float((T_b - T_ref).abs().max()):.3g} (bit-equal expected)")
    out["Q5b"] = counts
    log(f"path Q5 (batched_ransac on {MESH_N}x1, {LANES} correspondence sets of {sp.shape[1]} "
        f"rows, {HYPOTHESES} hypotheses, the fp32 score): {wall * 1e3:.1f} ms counted call, "
        f"bit-equal to one ransac_pair_step over all lanes; fitness min {f_b.min().item():.3f}; "
        f"launches ransac_score {counts['ransac_score']}")
    return out


def card_tests() -> None:
    """The card tests of tests/test_torch_kernels.py named by CARD_TESTS: the
    ordered-row-sum kernel bit-equal to its plain version; one pair of
    fused_register_step with batch.py's knobs bit-equal alone and in batches
    of 2, 8 and 128; each cloud's kNN features bit-equal at 1, 16 and 256
    clouds a call; the pose-graph solves bit-equal call to call; the crash
    suite's cases and kernel 3 at their shapes; batched_register on four
    pair shards of one card bit-equal to one shard."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
         "tests/test_torch_kernels.py", "-k", CARD_TESTS],
        capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0:
        fail("card tests failed:\n" + "\n".join(lines[-40:]) + out.stderr[-2000:])
    log(f"card tests ({CARD_TESTS}): {lines[-1] if lines else ''} in {time.time() - t0:.1f} s")


def mesh_large_paths(dev, src_pts, tgt_pts, a: dict, fine_a, gate) -> dict:
    """Q3: ``ring_nn_search`` on a 1x4 block mesh on the card, at d = 3 on
    path A's 1,000,448-row clouds (A's source moved by its downsampled-ICP
    pose against its target: kernel 4 in every ring step) and at d = 33 on
    RING_FEATURES random features with RING_MASKED of the rows masked
    (kernel 5), each against ``nn_search`` on the whole arrays (valid rows:
    every index equal, d2 within RING_TOL) and one ring step's shape against
    the kernel's plain version.  Q4: ``register_arrays_large(mesh=1x4)`` at
    path A's settings with the block-sparse ring (kernel 6; its first ring
    step against the plain version) and the dense ring (kernel 4), cold and
    warm, counted, gated, against path A's single-device pose within
    MESH_LARGE_GAP_*; with several cards (Q6) once more with a shard a
    card.  ``a`` holds path A's stage data, ``fine_a`` its refinement."""
    import torch

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.ops import nn as tnn
    from tpu3dm_torch.ops import nn_sparse
    from tpu3dm_torch.parallel import sharded_icp
    from tpu3dm_torch.parallel.ring_nn import ring_nn_search
    from tpu3dm_torch.registration import large

    out = {}
    mesh = card_mesh(dev, 1, MESH_N)
    src, tgt = a["src"], a["tgt"]
    q = torch.where(src.mask[:, None], se3.apply(a["mid"], src.points), src.points).contiguous()
    gen = torch.Generator(device=dev).manual_seed(7)
    fq, ft = (torch.randn((RING_FEATURES, 33), generator=gen, device=dev) for _ in range(2))
    fqm, ftm = (torch.rand(RING_FEATURES, generator=gen, device=dev) >= RING_MASKED
                for _ in range(2))
    cases = (("Q3a", "d 3, path A's clouds", "nn_tiled_smalld", q, tgt.points, src.mask, tgt.mask),
             ("Q3f", "d 33, random features", "nn_tiled_wide", fq, ft, fqm, ftm))
    for key, label, kern, qq, tt, qmask, tmask in cases:
        (d2r, ir), counts, ring_s, _ = counted(
            f"path Q3 ring_nn_search ({label})",
            lambda: ring_nn_search(mesh, qq, tt, qmask, tmask),
            {kern: lambda n: n >= MESH_N * MESH_N})
        torch.cuda.synchronize()
        t0 = time.time()
        d2w, iw = tnn.nn_search(qq, tt, qmask, tmask)
        torch.cuda.synchronize()
        whole_s = time.time() - t0
        gap = (d2r - d2w).abs()[qmask]
        allowed = RING_TOL + RING_TOL * d2w.abs()[qmask]
        idx_equal = (ir == iw)[qmask].float().mean().item()
        if idx_equal < 1.0 or bool((gap > allowed).any()):
            fail(f"path Q3 ({label}): indices equal on {idx_equal:.6%} of valid rows, worst d2 "
                 f"gap {gap.max().item():.3g} (every index equal and rtol = atol = {RING_TOL} "
                 f"required)")
        # One ring step's shape: up to 8192 queries of shard 0 against target
        # shard 0 and its mask, no query mask, as the ring calls it.
        nt_s = tt.shape[0] // MESH_N
        qs = qq[:min(8192, qq.shape[0] // MESH_N)].contiguous()
        ts, tms = tt[:nt_s].contiguous(), tmask[:nt_s].contiguous()
        d2k, ik = tnn.nn_search_tiled(qs, ts, None, tms)
        d2p, ip = tnn.nn_search_tiled_plain(qs, ts, None, tms)
        torch.cuda.synchronize()
        agree = (ik == ip).float().mean().item()
        err = (d2k - d2p).abs().max().item()
        scale = (torch.sum(qs * qs, -1).max() + torch.sum(ts[tms] ** 2, -1).max()).item()
        if kern == "nn_tiled_smalld" and (agree < 1.0 or err > 0.0):
            fail(f"path Q3: {kern} at a ring step's shape: picks equal on {agree:.6%}, max |d2| "
                 f"error {err:.3g} (exact expected)")
        if kern == "nn_tiled_wide" and (agree < 0.999 or err > 2e-6 * scale):
            fail(f"path Q3: {kern} at a ring step's shape: picks equal on {agree:.4%}, max |d2| "
                 f"error {err:.3g}")
        out[key] = counts
        log(f"path Q3 (ring_nn_search on 1x{MESH_N}, {label}: {qq.shape[0]} x {tt.shape[0]}, "
            f"{int(qmask.sum())} valid queries): ring {ring_s:.3f} s, whole search "
            f"{whole_s:.3f} s; indices equal on every valid row, worst d2 gap "
            f"{gap.max().item():.3g} ({(gap / allowed).max().item():.3f} of the bound); "
            f"{kern} at a ring step ({qs.shape[0]} x {nt_s}) against its plain version: picks "
            f"equal {agree:.6f}, max |d2| err {err:.3g}; launches {kern} {counts[kern]}")
        del d2r, ir, d2w, iw, d2k, ik, d2p, ip
    del fq, ft, fqm, ftm, q
    torch.cuda.empty_cache()

    # Kernel 6 at the block-sparse ring's first step: source shard 0 moved by
    # A's downsampled-ICP pose against target shard 0, both KD-sorted shards.
    blk = src.block
    sp_sh, spm, _ = sharded_icp._prep_blocksparse_shards(src_pts, None, MESH_N, blk)
    tp_sh, _, _ = sharded_icp._prep_blocksparse_shards(tgt_pts, None, MESH_N, blk)
    n_s = sp_sh.shape[0] // MESH_N
    qs = torch.from_numpy(sp_sh[:n_s]).to(dev)
    qs = torch.where(torch.from_numpy(spm[:n_s]).to(dev)[:, None], se3.apply(a["mid"], qs),
                     qs).contiguous()
    ts = torch.from_numpy(tp_sh[:n_s]).to(dev)
    table, _ = nn_sparse.candidate_blocks(qs, ts, blk, 8)
    d2k, ik = nn_sparse.nn_search_table(qs, ts, table, block=blk)
    d2p, ip = nn_sparse.nn_search_table_plain(qs, ts, table, block=blk)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(d2k, d2p)):
        fail("path Q4: nn_blocksparse at the ring's first step differs from its plain version "
             "(exact expected)")
    log(f"path Q4: nn_blocksparse at the block-sparse ring's first step ({n_s} x {n_s}, "
        f"{table.shape[0]} blocks x w {table.shape[1]}) equal to its plain version")
    del qs, ts, table, d2k, ik, d2p, ip

    cfg = PipelineConfig.with_voxel_size(0.3)
    meshes = [(f"1x{MESH_N} on one card", mesh, "Q4")]
    many = real_mesh(dev, "block")
    if many is not None:
        meshes.append((f"1x{many.shape['block']}, a shard a card (Q6)", many, "Q6"))
    for mlabel, m, tag in meshes:
        for block_sparse in (True, False):
            ring = "block-sparse" if block_sparse else "dense"
            # Kernel 4: the donor normals, and on the dense ring nb^2 ring
            # steps an ICP iteration.
            steps = 0 if block_sparse else m.shape["block"] ** 2
            need = {"ransac_score": lambda n: n > 0,
                    "nn_tiled_smalld": lambda n, steps=steps: n > steps}
            if block_sparse:
                need["nn_blocksparse"] = lambda n: n > 0
            walls = []
            for _ in ("cold", "warm"):
                (fine, _), counts, wall, _ = counted(
                    f"path {tag} register_arrays_large ({mlabel}, {ring} ring)",
                    lambda: large.register_arrays_large(src_pts, tgt_pts, cfg, device=dev, mesh=m,
                                                        mesh_block_sparse=block_sparse), need)
                walls.append(wall)
                rot, rmse = gate(fine.transformation)
                if rot >= LARGE_GATE_ROT_DEG or rmse >= LARGE_GATE_RMSE:
                    fail(f"path {tag} ({ring} ring) quality gate: rot {rot:.4f} deg, "
                         f"rmse {rmse:.3g}")
            d_rot, d_t = apart(fine.transformation[None], fine_a.transformation[None])
            if d_rot >= MESH_LARGE_GAP_DEG or d_t >= MESH_LARGE_GAP_T:
                fail(f"path {tag} ({ring} ring): {d_rot:.4f} deg, t {d_t:.3g} from path A's "
                     f"single-device pose (bound {MESH_LARGE_GAP_DEG} deg, {MESH_LARGE_GAP_T})")
            out[f"{tag}{'s' if block_sparse else 'd'}"] = counts
            log(f"path {tag} (register_arrays_large, mesh {mlabel}, {ring} ring, "
                f"{LARGE_POINTS} points, voxel 0.3): cold {walls[0]:.3f} s, warm "
                f"{walls[1]:.3f} s; rot {rot:.4f} deg, rmse {rmse:.3g}, fitness "
                f"{float(fine.fitness):.4f}, full-res ICP iterations {int(fine.iterations)}; "
                f"from path A's pose {d_rot:.5f} deg, t {d_t:.3g}; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
    return out


def large_phases(dev, results: dict) -> dict:
    """Paths A and B of ``register_arrays_large`` at LARGE_POINTS points, the
    kernels 3 (fp32 route) to 6 against their plain versions at those paths'
    shapes, and path A on the card against the CPU.  Adds the kernels'
    numbers to ``results``; returns {"A": counts, "B": counts} of the warm
    calls."""
    import dataclasses

    import torch

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.ops import nn as tnn
    from tpu3dm_torch.ops import nn_sparse
    from tpu3dm_torch.preprocess.pipeline import down_features
    from tpu3dm_torch.preprocess.voxel import voxel_downsample_host
    from tpu3dm_torch.registration import large
    from tpu3dm_torch.registration.icp import icp_refine
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.ransac import chunk_count

    t0 = time.time()
    src_pts, tgt_pts, T_true = make_benchmark_pair(LARGE_POINTS, seed=0, sigma=0.002)
    log(f"large pair: {LARGE_POINTS} points a cloud, made in {time.time() - t0:.2f} s (host)")

    def gate(T, pts=src_pts, T_ref=T_true):
        """bench.py's gate: rotation error (deg) and alignment RMSE over the source."""
        T = T.double().cpu().numpy()
        if not (T.shape == (4, 4) and np.isfinite(T).all()):
            fail(f"non-finite or misshapen transform {T}")
        M = T[:3, :3] @ T_ref[:3, :3].T
        rot = float(np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))))
        moved = pts @ T[:3, :3].T + T[:3, 3]
        expect = pts @ T_ref[:3, :3].T + T_ref[:3, 3]
        return rot, float(np.sqrt(((moved - expect) ** 2).sum(1).mean()))

    def staged(cfg):
        """The path once more, stage by stage, synchronized between stages;
        returns stage ms, full-resolution ICP iterations and the stages' data."""
        pp = cfg.preprocess
        marks = [time.time()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.time())

        sv = voxel_downsample_host(src_pts, pp.voxel_size, device=dev)
        tv = voxel_downsample_host(tgt_pts, pp.voxel_size, device=dev)
        mark()
        sd, td = (down_features(v, pp.normal_radius, pp.fpfh_radius, normal_max_nn=pp.normal_max_nn,
                                fpfh_max_nn=pp.fpfh_max_nn,
                                share_knn=pp.normal_radius <= pp.fpfh_radius) for v in (sv, tv))
        mark()
        coarse = large.coarse_pose_with_verification(
            sd, td, cfg, generator=torch.Generator().manual_seed(0))
        mark()
        mid = icp_refine(sd, td, coarse.transformation, dist_thresh=cfg.icp.dist_thresh,
                         max_iterations=cfg.icp.max_iterations, point_to_plane=True)
        mark()
        src = large.prepare_large_cloud(src_pts, device=dev)
        tgt = large.prepare_large_cloud(tgt_pts, device=dev)
        mark()
        tgt = dataclasses.replace(tgt, normals=large.donor_normals(tgt, td))
        mark()
        fine = large.icp_refine_large(src, tgt, mid.transformation,
                                      dist_thresh=cfg.icp.dist_thresh,
                                      max_iterations=cfg.icp.max_iterations, point_to_plane=True)
        mark()
        return np.diff(marks) * 1e3, int(fine.iterations), dict(sd=sd, td=td, src=src, tgt=tgt,
                                                                mid=mid.transformation)

    stage_names = ("host voxel", "features", "coarse (RANSAC + verify)", "downsampled ICP",
                   "host kd_perm", "donor normals", "full-res ICP")
    data, path_launches, fines = {}, {}, {}
    for name, voxel, needed in LARGE_PATHS:
        cfg = PipelineConfig.with_voxel_size(voxel)
        walls = []
        for _ in ("cold", "warm"):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.time()
            fine, coarse = large.register_arrays_large(src_pts, tgt_pts, cfg, device=dev)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            counts = {k: v.launches for k, v in KERNELS.items()}
            for k in needed:
                if counts[k] <= 0:
                    fail(f"path {name} launched kernel {k} no time")
            if counts["ransac_score_bf16"]:
                fail(f"path {name} launched the bf16 score: its RANSAC scores fp32 features")
            rot, rmse = gate(fine.transformation)
            if rot >= LARGE_GATE_ROT_DEG or rmse >= LARGE_GATE_RMSE:
                fail(f"path {name} quality gate: rot {rot:.4f} deg, rmse {rmse:.3g}")
        path_launches[name] = counts
        fines[name] = fine
        ms, iters, data[name] = staged(cfg)
        sd, td = data[name]["sd"], data[name]["td"]
        log(f"path {name} (voxel {voxel}; down {int(sd.mask.sum())}/{sd.capacity} and "
            f"{int(td.mask.sum())}/{td.capacity} points): cold {walls[0]:.3f} s, warm "
            f"{walls[1]:.3f} s; rot {rot:.4f} deg, rmse {rmse:.3g}, fitness "
            f"{float(fine.fitness):.4f}, full-res ICP iterations {int(fine.iterations)}; "
            f"coarse fitness {float(coarse.fitness):.4f}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        log(f"path {name} stages (ms, synchronized): "
            + ", ".join(f"{n} {t:.1f}" for n, t in zip(stage_names, ms))
            + f"; full-res ICP {iters} iterations + 1 grading pass, "
              f"{ms[-1] / (iters + 1):.2f} ms a pass")
        if name == "A":
            profile_report(lambda: large.register_arrays_large(src_pts, tgt_pts, cfg, device=dev),
                           f"path {name}")
    torch.cuda.empty_cache()

    # --- Q3, Q4 (and Q6): the ring NN and the sharded refinement -------------
    path_launches.update(mesh_large_paths(dev, src_pts, tgt_pts, data["A"], fines["A"], gate))
    torch.cuda.empty_cache()

    # --- kernels 3-6 against their plain versions, at the paths' shapes ------
    results["ransac_score_fp32_1lane"] = fp32_score_case(data["B"]["sd"], data["B"]["td"],
                                              PipelineConfig.with_voxel_size(0.1).ransac)

    def valid_count(mask):
        return float(mask.sum().item())

    def chunked_cdist_argmin(q, far):
        for s in tnn.lane_slices(q.shape[0], far.shape[0]):
            torch.cdist(q[s], far).argmin(-1)

    def tiled_case(label, q, t, tmask, qmask, reps, pick_rel_tol, pass_qmask=False):
        """Kernel against plain version: equal picks required where the
        arithmetic order is the same (pick_rel_tol None), else on >= 99.9% of
        valid rows with distances within pick_rel_tol of the row's scale.
        pass_qmask: the call passes qmask as its query mask, as the path
        does (else None, every row computed); masked rows must then come
        back idx 0, d2 BIG, and the row adds the launch alone."""
        call_qmask = qmask if pass_qmask else None
        d2k, ik = tnn.nn_search_tiled(q, t, call_qmask, tmask)
        d2p, ip = tnn.nn_search_tiled_plain(q, t, call_qmask, tmask)
        torch.cuda.synchronize()
        agree = (ik == ip)[qmask].float().mean().item()
        err = (d2k - d2p).abs()[qmask].max().item()
        if pass_qmask and not ((ik[~qmask] == 0).all() and (d2k[~qmask] == tnn.BIG).all()):
            fail(f"{label}: masked query rows did not come back idx 0, d2 BIG")
        if pick_rel_tol is None:
            if agree < 1.0 or err > 0.0:
                fail(f"{label}: picks equal on {agree:.6%}, max |d2| error {err:.3g} (exact expected)")
        else:
            scale = (torch.sum(q * q, -1).max() + torch.sum(t[tmask] ** 2, -1).max()).item()
            if agree < 0.999 or err > pick_rel_tol * scale:
                fail(f"{label}: picks equal on {agree:.4%}, max |d2| error {err:.3g} "
                     f"(allowed {pick_rel_tol * scale:.3g})")
        far = torch.where(tmask[:, None], t, torch.full_like(t, 1e9))
        nq, nt, d = valid_count(qmask), valid_count(tmask), q.shape[1]
        if d < 8:  # fp32 instructions: 3 subtractions, 3 squares, 3 adds (bias first)
            work = (3.0 * d * nq * nt, PEAK_FP32_OPS)
        else:  # d FMAs, then one FMA of the -2 scale with |t|^2
            work = ((d + 1.0) * nq * nt, PEAK_FP32_OPS)
        r = dict(
            agree=agree, max_abs_err=err,
            ms=cuda_ms(lambda: tnn.nn_search_tiled(q, t, call_qmask, tmask), reps),
            plain_ms=cuda_ms(lambda: tnn.nn_search_tiled_plain(q, t, call_qmask, tmask), 1),
            library_ms=cuda_ms(lambda: chunked_cdist_argmin(q, far), 1),
            # valid rows of both sets, the bias or tsq of every target, d2 and
            # idx of every query
            bound=bound_ms(4 * d * (nq + nt) + 4 * t.shape[0] + 8 * q.shape[0], work),
            shape=f"{q.shape[0]} x {t.shape[0]}, d {d}",
        )
        if pass_qmask:  # the launch alone, without the wrapper's Python and norms
            mask_bytes = call_qmask.contiguous()
            if d < 8:
                launch_only = lambda: tnn.NN_TILED_SMALLD.launch(  # noqa: E731
                    dev, q.data_ptr(), t.data_ptr(), mask_bytes.data_ptr(), tmask.data_ptr(),
                    d2k.data_ptr(), ik.data_ptr(), q.shape[0], t.shape[0])
            else:
                tsq = tnn._sq_norms(t, tmask)
                launch_only = lambda: tnn.NN_TILED_WIDE.launch(  # noqa: E731
                    dev, q.data_ptr(), t.data_ptr(), tsq.data_ptr(), mask_bytes.data_ptr(),
                    tmask.data_ptr(), d2k.data_ptr(), ik.data_ptr(), q.shape[0], t.shape[0], d)
            r["launch_ms"] = cuda_ms(launch_only, reps)
        launch = f" (the launch alone {r['launch_ms']:.4f} ms)" if "launch_ms" in r else ""
        log(f"kernel {label}: {q.shape[0]} x {t.shape[0]} x {d}: picks equal {agree:.6f}, "
            f"max |d2| err {err:.3g}; kernel {r['ms']:.4f} ms{launch}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
        return r

    a, b = data["A"], data["B"]
    # Kernel 4: donor normals of path A (every full-resolution target point
    # against the downsampled target), and the downsampled ICP search of path B.
    results["nn_tiled_smalld"] = tiled_case(
        "nn_tiled_smalld (A donor normals)" + parent_note("nn_tiled_smalld"), a["tgt"].points,
        a["td"].points, a["td"].mask, a["tgt"].mask, 10, None)
    moved = se3.apply(b["mid"], b["sd"].points).contiguous()
    results["nn_tiled_smalld_8192"] = tiled_case(
        "nn_tiled_smalld (B downsampled ICP)" + parent_note("nn_tiled_smalld_8192"), moved,
        b["td"].points, b["td"].mask, b["sd"].mask, 20, None, pass_qmask=True)
    # Kernel 5: the forward FPFH search of path B's mutual filter, with the
    # source mask as its query mask, as nn_mutual passes it.
    results["nn_tiled_wide"] = tiled_case(
        "nn_tiled_wide (B FPFH)" + parent_note("nn_tiled_wide"), b["sd"].features,
        b["td"].features, b["td"].mask, b["sd"].mask, 20, 2e-6, pass_qmask=True)

    # Kernel 6: the first full-resolution ICP search of path A.
    src, tgt = a["src"], a["tgt"]
    qm, tmask = src.mask, tgt.mask
    q = torch.where(qm[:, None], se3.apply(a["mid"], src.points), src.points)
    table, _ = nn_sparse.candidate_blocks(q, tgt.points, src.block, 8)
    d2k, ik = nn_sparse.nn_search_table(q, tgt.points, table, block=src.block)
    d2p, ip = nn_sparse.nn_search_table_plain(q, tgt.points, table, block=src.block)
    torch.cuda.synchronize()
    agree = (ik == ip)[qm].float().mean().item()
    err = (d2k - d2p).abs()[qm].max().item()
    if agree < 1.0 or err > 0.0:
        fail(f"nn_blocksparse: picks equal on {agree:.6%}, max |d2| error {err:.3g} (exact expected)")
    blk = src.block
    vq = qm.reshape(-1, blk).sum(1).double()
    vt = tmask.reshape(-1, blk).sum(1).double()
    entries = (vq * vt[table.long()].sum(1)).sum().item()
    # 7 fp32 instructions per visited valid entry (3 products, 2 adds, the -2
    # scale, the subtraction); bytes: valid rows of both clouds, the table, d2
    # and idx of every query.
    results["nn_blocksparse"] = r = dict(
        agree=agree, max_abs_err=err,
        ms=cuda_ms(lambda: nn_sparse.nn_search_table(q, tgt.points, table, block=blk), 5),
        plain_ms=cuda_ms(lambda: nn_sparse.nn_search_table_plain(q, tgt.points, table, block=blk), 1),
        library_ms=None,  # no single PyTorch call searches a per-block candidate table
        bound=bound_ms(12 * (vq.sum() + vt.sum()).item() + 4 * table.numel() + 8 * q.shape[0],
                       (7.0 * entries, PEAK_FP32_OPS)),
        shape=f"{q.shape[0]} x {tgt.points.shape[0]}, {table.shape[0]} blocks x w {table.shape[1]}",
    )
    log(f"kernel nn_blocksparse (A first full-res ICP search){parent_note('nn_blocksparse')}: "
        f"{q.shape[0]} x {tgt.points.shape[0]}, "
        f"{table.shape[0]} query blocks x w {table.shape[1]}, {entries:.4g} valid entries: "
        f"picks equal {agree:.6f}, max |d2| err {err:.3g}; kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    del data, a, b, src, tgt, q, table, d2k, ik, d2p, ip, moved
    torch.cuda.empty_cache()

    # --- path A at AGREE_POINTS on the card and on the CPU -----------------
    sp, tp, T_small = make_benchmark_pair(AGREE_POINTS, seed=0, sigma=0.002)
    cfg = PipelineConfig.with_voxel_size(0.3)
    n_chunks = chunk_count(cfg.ransac.max_iterations, cfg.ransac.batch_size)
    bits = torch.stack([draw_bits((n_chunks, cfg.ransac.batch_size, 2),
                                  torch.Generator().manual_seed(r)) for r in range(4)])
    t0 = time.time()
    fg, _ = large.register_arrays_large(sp, tp, cfg, device=dev, sample_bits=bits)
    torch.cuda.synchronize()
    gpu_s = time.time() - t0
    t0 = time.time()
    fc, _ = large.register_arrays_large(sp, tp, cfg, device="cpu", sample_bits=bits)
    cpu_s = time.time() - t0
    Tg, Tc = fg.transformation.double().cpu().numpy(), fc.transformation.double().numpy()
    fro = np.linalg.norm(Tg[:3, :3] - Tc[:3, :3])
    d_rot = float(np.degrees(2 * np.arcsin(min(fro / (2 * np.sqrt(2)), 1.0))))
    d_t = float(np.abs(Tg[:3, 3] - Tc[:3, 3]).max())
    rot_g, rmse_g = gate(fg.transformation, sp, T_small)
    if d_rot >= 0.5 or d_t >= 0.02:
        fail(f"path A at {AGREE_POINTS} points: card and CPU differ by {d_rot:.4f} deg, t {d_t:.4g}")
    if rot_g >= LARGE_GATE_ROT_DEG or rmse_g >= LARGE_GATE_RMSE:
        fail(f"path A at {AGREE_POINTS} points on the card: rot {rot_g:.4f} deg, rmse {rmse_g:.3g}")
    log(f"path A at {AGREE_POINTS} points, same sample bits: card {gpu_s:.2f} s, CPU {cpu_s:.2f} s; "
        f"card vs CPU rot {d_rot:.5f} deg, t {d_t:.3g}; iterations {int(fg.iterations)} / "
        f"{int(fc.iterations)}; card vs T_true rot {rot_g:.4f} deg, rmse {rmse_g:.3g}")
    return path_launches


if __name__ == "__main__":
    sys.exit(main())
