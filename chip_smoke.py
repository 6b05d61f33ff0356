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
     "ransac_score_rescore", inside the fp32 float64 bracket);
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
     the 16 clouds against the CPU;
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
  7. the large-cloud path, register_arrays_large on make_benchmark_pair(
     1_000_000, seed=0, sigma=0.002) (bench.py's large phase): path A at
     voxel 0.3, path B at voxel 0.1, each twice (cold, warm) with the launch
     counts zeroed just before and read just after each call, each call
     gated as bench.py gates it (rotation < 2 deg, alignment RMSE < 0.01
     against T_true), then once more stage by stage; one profiled call of A;
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
     call, all buckets), "I3" and "S" (S1's counted run)), then the ok
     line, last.
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

    # --- 6e. path I: the batch API (registration/batch.py) -------------------
    del src, tgt
    torch.cuda.empty_cache()
    batch_launches = batch_paths(dev, cfg, clouds, trues, moments)

    # --- 6f. path S: the disk-to-result stream (registration/stream.py) ------
    torch.cuda.empty_cache()
    stream_launches = stream_paths(dev, cfg)

    # --- 7-10. the large-cloud path -----------------------------------------
    torch.cuda.empty_cache()
    large_launches = large_phases(dev, results)
    by_path = {"fused": launches, **rescue_launches, **values_launches, **hard_launches,
               **batch_launches, **stream_launches, **large_launches}
    # Kernels 1, 2 and the bf16 score: launches of the fused path's counted
    # step; the fp32 score and 4-6: of path B; 7: of path C.
    row_path = {"ransac_score": "B", "lane_nn_wide": "C",
                **{name: "B" for name in LARGE_KERNELS}}

    # --- 11. report -------------------------------------------------------
    kernels = []
    for name, r in results.items():
        kern = ROW_KERNEL.get(name, name)
        path = ROW_PATH.get(name, row_path.get(kern, "fused"))
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": by_path[path][kern],
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
    if mates_gap > 1e-4:
        fail(f"path I2: pairs 0-7 alone differ from the whole call by {mates_gap:.3g}")
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
    out = {"I": total}

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
                                fpfh_max_nn=pp.fpfh_max_nn) for v in (sv, tv))
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
    data, path_launches = {}, {}
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
