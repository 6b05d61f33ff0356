"""tpu3dm_torch kernel wrappers: device dispatch, and each CUDA kernel held
against its plain PyTorch version.

This file imports neither JAX nor tpu3dm, so it also runs where only the
port is installed.  The ``gpu`` tests need a CUDA device and nvcc and skip
without them; on a card run
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the repo's
conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from tpu3dm_torch.core.se3 import exp_so3
from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
from tpu3dm_torch.ops import nn as tnn
from tpu3dm_torch.ops import nn_lane, nn_sparse, ransac_score, rowsum

ALL_KERNELS = {"lane_nn_smalld", "lane_mutual", "lane_mutual_bf16_cross", "ransac_score",
               "ransac_score_bf16",
               "nn_tiled_smalld", "nn_tiled_wide", "nn_blocksparse", "lane_nn_wide", "row_sums"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda")


def test_wrappers_run_plain_on_cpu_without_launching():
    reset_launch_counts()
    x = torch.zeros(1, 8, 3)
    nn_lane.nn_search_lane(x, x)
    f = torch.rand(1, 8, 33)
    nn_lane.nn_search_lane(f, f)
    nn_lane.nn_mutual_mask_lane(f, f)
    nn_lane.nn_mutual_mask_batched(f, f, approx=True, cross_bf16=True)
    for dt in (torch.float32, torch.bfloat16):
        ransac_score.score_features(torch.zeros(1, 4, 16, dtype=dt), torch.zeros(1, 4),
                                    torch.zeros(1, 8, 16, dtype=dt), torch.zeros(1, 8),
                                    torch.ones(1, 8, dtype=torch.bool), 1.0)
    tnn.nn_search_tiled(torch.rand(8, 3), torch.rand(16, 3))
    tnn.nn_search_tiled(torch.rand(8, 33), torch.rand(16, 33))
    nn_sparse.nn_search_table(torch.rand(8, 3), torch.rand(16, 3),
                              torch.zeros(2, 2, dtype=torch.int32), block=4)
    rowsum.row_sums(torch.rand(3, 40))
    assert set(KERNELS) == ALL_KERNELS
    assert all(k.launches == 0 for k in KERNELS.values())


def test_wrappers_reject_other_devices():
    """Neither plain nor kernel for a tensor that is on neither the CPU nor
    CUDA: the wrappers raise rather than fall back."""
    x = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError):
        nn_lane.nn_search_lane(x, x)
    f = torch.zeros(1, 8, 33, device="meta")
    with pytest.raises(ValueError):
        nn_lane.nn_search_lane(f, f)
    with pytest.raises(ValueError):
        nn_lane.nn_mutual_mask_lane(f, f)
    with pytest.raises(ValueError):
        ransac_score.score_features(
            torch.zeros(1, 4, 16, device="meta"), torch.zeros(1, 4, device="meta"),
            torch.zeros(1, 8, 16, device="meta"), torch.zeros(1, 8, device="meta"),
            torch.ones(1, 8, dtype=torch.bool, device="meta"), 1.0,
        )
    for d in (3, 33):
        with pytest.raises(ValueError):
            tnn.nn_search_tiled(torch.zeros(8, d, device="meta"), torch.zeros(8, d, device="meta"))
    with pytest.raises(ValueError):
        nn_sparse.nn_search_table(torch.zeros(8, 3, device="meta"), torch.zeros(8, 3, device="meta"),
                                  torch.zeros(2, 1, dtype=torch.int32, device="meta"), block=4)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        nn_lane.nn_search_lane(torch.zeros(8, 3), torch.zeros(8, 3))
    with pytest.raises(ValueError):  # one target lane per query lane
        nn_lane.nn_search_lane(torch.zeros(2, 8, 16), torch.zeros(1, 8, 16))
    with pytest.raises(ValueError):
        ransac_score.score_features(torch.zeros(1, 4, 15), torch.zeros(1, 4),
                                    torch.zeros(1, 8, 15), torch.zeros(1, 8),
                                    torch.ones(1, 8, dtype=torch.bool), 1.0)
    with pytest.raises(ValueError):
        tnn.nn_search_tiled(torch.zeros(1, 8, 3), torch.zeros(1, 8, 3))
    with pytest.raises(ValueError):
        tnn.nn_search_tiled(torch.zeros(8, 3), torch.zeros(8, 4))
    table = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError):  # not padded to the block
        nn_sparse.nn_search_table(torch.zeros(7, 3), torch.zeros(8, 3), table, block=4)
    with pytest.raises(ValueError):  # one table row per query block
        nn_sparse.nn_search_table(torch.zeros(12, 3), torch.zeros(8, 3), table, block=4)


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    from tpu3dm_torch import csrc

    path = csrc.library_path("lane_nn.cu")
    assert path.parent == csrc.BUILD_DIR and path.name.startswith("lane_nn-")
    assert path == csrc.library_path("lane_nn.cu")
    (tmp_path / "lane_nn.cu").write_bytes((csrc.SRC_DIR / "lane_nn.cu").read_bytes() + b"\n")
    monkeypatch.setattr(csrc, "SRC_DIR", tmp_path)
    assert csrc.library_path("lane_nn.cu") != path  # an edited kernel is rebuilt


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as cpp

    from tpu3dm_torch import csrc

    monkeypatch.setattr(csrc, "library_path", lambda src: tmp_path / f"{src}.so")
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        csrc.build(["lane_nn.cu"])
    assert csrc.build([]) == {}


@pytest.mark.gpu
def test_lane_nn_kernel_matches_plain(cuda_device):
    """Same rounding order as the plain version: bit for bit."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(4, 300, 3)), dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.normal(size=(4, 2500, 3)), dtype=torch.float32, device=cuda_device)
    tm = torch.tensor(rng.random((4, 2500)) > 0.2, device=cuda_device)
    tm[3] = False  # a lane with every target masked: idx 0, d2 = BIG in both
    before = KERNELS["lane_nn_smalld"].launches
    d2k, idxk = nn_lane.nn_search_lane(q, t, None, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(q, t, None, tm)
    torch.cuda.synchronize()
    assert KERNELS["lane_nn_smalld"].launches == before + 1
    assert torch.equal(idxk, idxp)
    assert torch.equal(d2k, d2p)


def _lane_nn_case(case, rng):
    """(q [B, M, 3], t [B, N, 3], target mask [B, N] or None) for a case of the
    compacted search: lanes with a single valid target, valid targets only at
    the end of a 2048-row staging tile (or of the lane), exact ties between
    targets that land at different compacted positions, query counts that
    are no multiple of the 1024 rows a block takes, no mask at all."""
    B, M, N = 4, 700, 2500
    if case == "ragged_m":
        M = 2 * 1024 + 37
    q = rng.normal(size=(B, M, 3))
    t = rng.normal(size=(B, N, 3))
    tm = rng.random((B, N)) > 0.3
    if case == "one_valid":
        tm[1] = False
        tm[1, 1777] = True
        tm[2] = False
        tm[2, 0] = True
    elif case == "tile_end":
        tm[:] = False
        tm[0, 2040:2048] = True  # the first tile's last rows only
        tm[1, 2490:] = True      # the lane's last rows only, in the second tile
        tm[2, 2047:2049] = True  # one row either side of the tile boundary
        tm[3, 2047] = True
    elif case == "ties":
        # Points of a coarse integer grid: many targets at exactly the same
        # distance from a query, valid and masked ones interleaved across
        # both tiles, and duplicated target points.
        q = rng.integers(-2, 3, size=(B, M, 3)).astype(np.float64)
        t = rng.integers(-2, 3, size=(B, N, 3)).astype(np.float64)
        t[:, 2100] = t[:, 7]
        t[:, 1500] = t[:, 7]
        tm[:, 7] = False
    elif case == "no_mask":
        tm = None
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return f32(q), f32(t), None if tm is None else torch.tensor(tm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_valid", "tile_end", "ties", "ragged_m", "no_mask",
                                  "sliced_mask", "expanded_mask"])
def test_lane_nn_kernel_compaction_cases_match_plain(cuda_device, case):
    """The kernel searches only the compacted valid targets: bit for bit the
    plain version's biased search on every case, including a target mask
    that is a strided view at an odd byte offset, or one lane's mask
    expanded over all lanes."""
    q, t, tm = (None if x is None else x.to(cuda_device)
                for x in _lane_nn_case(case, np.random.default_rng(10)))
    if case == "sliced_mask":
        wide = torch.zeros((tm.shape[0] + 1, tm.shape[1] + 3), dtype=torch.bool,
                           device=cuda_device)
        wide[1:, 3:] = tm
        tm = wide[1:, 3:]
        assert not tm.is_contiguous() and tm.data_ptr() % 16
    elif case == "expanded_mask":
        tm = tm[:1].expand_as(tm)
    before = KERNELS["lane_nn_smalld"].launches
    d2k, idxk = nn_lane.nn_search_lane(q, t, None, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(q, t, None, tm)
    torch.cuda.synchronize()
    assert KERNELS["lane_nn_smalld"].launches == before + 1
    assert torch.equal(idxk, idxp)
    assert torch.equal(d2k, d2p)
    if case == "one_valid":
        assert (idxk[1] == 1777).all() and (idxk[2] == 0).all()


@pytest.mark.gpu
def test_lane_mutual_kernel_matches_plain(cuda_device):
    """The kernel's dot product is an fmaf chain, the plain one a matmul:
    picks may differ only at near-ties (>= 99.9% agree)."""
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.normal(size=(3, 300, 33)), dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.normal(size=(3, 260, 33)), dtype=torch.float32, device=cuda_device)
    ma = torch.tensor(rng.random((3, 300)) > 0.1, device=cuda_device)
    mb = torch.tensor(rng.random((3, 260)) > 0.1, device=cuda_device)
    idxk, mutk = nn_lane.nn_mutual_mask_lane(a, b, ma, mb)
    idxp, mutp = nn_lane.nn_mutual_lane_plain(a, b, ma, mb)
    torch.cuda.synchronize()
    assert (idxk == idxp).float().mean() >= 0.999
    assert (mutk == mutp).float().mean() >= 0.999
    assert mutk.any()


@pytest.mark.gpu
def test_ransac_score_kernel_matches_plain(cuda_device):
    """Counts equal on >= 99.9% of hypotheses and never more than 1 apart (a
    distance within rounding of the threshold)."""
    rng = np.random.default_rng(2)
    R = exp_so3(torch.tensor(rng.normal(size=(700, 3)) * 0.3, dtype=torch.float32))
    t = torch.tensor(rng.normal(size=(700, 3)) * 0.2, dtype=torch.float32)
    p = torch.tensor(rng.normal(size=(1300, 3)), dtype=torch.float32)
    q = p + torch.tensor(rng.normal(size=(1300, 3)) * 0.3, dtype=torch.float32)
    F, c = ransac_score.corres_features(p[None].to(cuda_device), q[None].to(cuda_device))
    H, e = ransac_score.hypothesis_features(R[None].to(cuda_device), t[None].to(cuda_device))
    m = torch.tensor(rng.random((1, 1300)) > 0.15, device=cuda_device)
    thr = float(np.float32(0.6) ** 2)
    ck = ransac_score.score_features(H.contiguous(), e, F.contiguous(), c, m, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, m, thr)
    torch.cuda.synchronize()
    diff = (ck - cp).abs()
    assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999
    assert ck.max() > 0


@pytest.mark.gpu
def test_ransac_score_bf16_kernel_within_bracket(cuda_device):
    """The bf16 tensor-core route against its plain version: lanes with 0, 1,
    7 and all N valid rows and one with ~half, K no multiple of the 512
    hypotheses a block takes, N over the 1024 rows staged a pass, a NaN
    hypothesis row.  Counts equal on >= 99.9% of hypotheses and never more
    than 1 apart, every kernel count inside the float64 bracket of
    BF16_MMA_REL, and the NaN row and the empty lane count 0."""
    rng = np.random.default_rng(12)
    B, K, N = 5, 700, 1300
    R = exp_so3(torch.tensor(rng.normal(size=(B, K, 3)) * 0.3, dtype=torch.float32))
    t = torch.tensor(rng.normal(size=(B, K, 3)) * 0.2, dtype=torch.float32)
    p = torch.tensor(rng.normal(size=(B, N, 3)), dtype=torch.float32)
    q = p + torch.tensor(rng.normal(size=(B, N, 3)) * 0.3, dtype=torch.float32)
    F, c = ransac_score.corres_features(p.to(cuda_device), q.to(cuda_device))
    H, e = ransac_score.hypothesis_features(R.to(cuda_device), t.to(cuda_device))
    H[0, 5] = float("nan")
    m = torch.tensor(rng.random((B, N)) > 0.5, device=cuda_device)
    m[1] = False
    m[2] = False
    m[2, 1111] = True
    m[3] = False
    m[3, [0, 8, 300, 1023, 1024, 1100, 1299]] = True
    m[4] = True
    H, F = H.to(torch.bfloat16).contiguous(), F.to(torch.bfloat16).contiguous()
    e, c = e.contiguous(), c.contiguous()
    thr = float(np.float32(0.6) ** 2)
    before = {n: KERNELS[n].launches for n in ("ransac_score", "ransac_score_bf16")}
    ck = ransac_score.score_features(H, e, F, c, m, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, m, thr)
    sure, near = ransac_score.score_count_bracket(H, e, F, c, m, thr, ransac_score.BF16_MMA_REL)
    torch.cuda.synchronize()
    assert KERNELS["ransac_score_bf16"].launches == before["ransac_score_bf16"] + 1
    assert KERNELS["ransac_score"].launches == before["ransac_score"]
    diff = (ck - cp).abs()
    assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999
    assert ((ck >= sure) & (ck <= sure + near)).all()
    assert ck[0, 5] == 0 and (ck[1] == 0).all()
    assert ck[2].max() == 1 and ck[3].max() > 1 and ck[4].max() > 0


@pytest.mark.gpu
def test_lane_nn_wide_kernel_matches_plain(cuda_device):
    """Kernel 7: an fmaf chain against a cuBLAS product, as kernel 5: picks
    equal on >= 99.9% of rows, distances within 1e-5 relative to
    |q|^2 + |t|^2, every pick a valid target."""
    rng = np.random.default_rng(8)
    q = torch.tensor(rng.random((3, 700, 33)) * 50, dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.random((3, 1100, 33)) * 50, dtype=torch.float32, device=cuda_device)
    tm = torch.tensor(rng.random((3, 1100)) > 0.1, device=cuda_device)
    tm[1] = False
    tm[1, 5] = True  # one valid target in lane 1
    before = KERNELS["lane_nn_wide"].launches
    d2k, idxk = nn_lane.nn_search_lane(q, t, None, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(q, t, None, tm)
    torch.cuda.synchronize()
    assert KERNELS["lane_nn_wide"].launches == before + 1
    assert (idxk == idxp).float().mean() >= 0.999
    assert (idxk[1] == 5).all()
    scale = (q * q).sum(-1).max() + (t * t).sum(-1).max()
    assert (d2k - d2p).abs().max() <= 1e-5 * scale
    assert torch.gather(tm, 1, idxk.long()).all()


def _fpfh_grid_case(case, rng):
    """(a [B, Na, 33], b [B, Nb, 33], mask_a, mask_b) on an integer grid: small
    integer features, so every fp32 sum is exact in any order and the plain
    version's cuBLAS product has the kernels' bits.  Cases of the FPFH lane
    tile (128 listed rows a tile): exact ties inside a tile and across tiles,
    duplicated query rows, a valid target only at a tile's end, a lane with
    no valid target and one with no valid query, Na != Nb and neither a
    multiple of 128, B = 1, no masks, a mask that is a strided view at an odd
    byte offset."""
    B, na, nb = 3, 300, 260
    if case == "one_lane":
        B = 1
    elif case == "ragged":
        B, na, nb = 5, 1100, 389
    a = rng.integers(0, 4, size=(B, na, 33)).astype(np.float32)
    b = rng.integers(0, 4, size=(B, nb, 33)).astype(np.float32)
    ma = rng.random((B, na)) > 0.3
    mb = rng.random((B, nb)) > 0.3
    if case == "ties":
        mb[:, :200] = True
        b[:, 200] = b[:, 7]  # twin targets, in the first and the second tile
        b[:, 6] = b[:, 5]    # twin targets in one tile
        mb[:, 200] = True
        a[:, 3] = b[:, 7]    # two query rows at distance 0 from both twins
        a[:, 150] = b[:, 7]
        ma[:, [3, 150]] = True
    elif case == "tile_end":
        mb[:] = False
        mb[0, 127] = True        # the end of the first 128 targets
        mb[1, :127] = True       # listed position 127, the first tile's end,
        mb[1, 255] = True        # is target 255
        mb[2, nb - 1] = True     # the lane's last row
    elif case == "empty":
        mb[1] = False  # no valid target: the BIG-biased entries decide
        ma[2] = False  # no valid query
    t = lambda x: torch.tensor(x, device="cuda")  # noqa: E731
    if case == "no_mask":
        return t(a), t(b), None, None
    ma, mb = t(ma), t(mb)
    if case == "sliced_mask":
        wide = torch.zeros((B + 1, na + 3), dtype=torch.bool, device="cuda")
        wide[1:, 3:] = ma
        ma = wide[1:, 3:]
        assert not ma.is_contiguous() and ma.data_ptr() % 16
    return t(a), t(b), ma, mb


FPFH_GRID_CASES = ["grid", "ties", "tile_end", "empty", "ragged", "one_lane", "no_mask",
                   "sliced_mask"]


MUTUAL_ROUTES = {  # name -> (approx, cross_bf16, kernel)
    "approx": (True, False, "lane_mutual"),
    "bf16_cross": (False, True, "lane_mutual_bf16_cross"),
    "bf16_cross_approx": (True, True, "lane_mutual_bf16_cross"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(MUTUAL_ROUTES))
def test_lane_mutual_routes_match_plain(cuda_device, route):
    """Kernel 2 with the options of the fused step's other routes, on
    FPFH-like features: on bf16-rounded features every product is exact, so
    the kernel's fmaf chain equals the plain version's in-order sum (picks
    and masks equal); the fp32 features of "bf16_cross" sum in another order
    than the plain matmul (>= 99.9% equal)."""
    approx, cross, name = MUTUAL_ROUTES[route]
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.random((3, 300, 33)) ** 2 * 120, dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.random((3, 260, 33)) ** 2 * 120, dtype=torch.float32, device=cuda_device)
    ma = torch.tensor(rng.random((3, 300)) > 0.1, device=cuda_device)
    mb = torch.tensor(rng.random((3, 260)) > 0.1, device=cuda_device)
    before = KERNELS[name].launches
    idxk, mutk = nn_lane.nn_mutual_mask_batched(a, b, ma, mb, approx=approx, cross_bf16=cross)
    idxp, mutp = nn_lane.nn_mutual_mask_batched(*(x.cpu() for x in (a, b, ma, mb)),
                                                approx=approx, cross_bf16=cross)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    idxk, mutk = idxk.cpu(), mutk.cpu()
    va = ma.cpu()
    if approx:
        assert torch.equal(idxk[va], idxp[va]) and torch.equal(mutk, mutp)
    else:
        assert (idxk == idxp)[va].float().mean() >= 0.999
        assert (mutk == mutp).float().mean() >= 0.999
    assert mutk.any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", FPFH_GRID_CASES)
def test_lane_mutual_bf16_cross_integer_grid_exact(cuda_device, case):
    """The bf16-cross entry on integer-grid features (every dot exact, then
    rounded to bf16 alike): equal to the plain version on every row."""
    a, b, ma, mb = _fpfh_grid_case(case, np.random.default_rng(21))
    idxk, mutk = nn_lane.nn_mutual_mask_batched(a, b, ma, mb, cross_bf16=True)
    idxp, mutp = nn_lane.nn_mutual_lane_plain(a, b, ma, mb, cross_bf16=True)
    torch.cuda.synchronize()
    va = torch.ones(a.shape[:2], dtype=torch.bool, device=cuda_device) if ma is None else ma
    assert torch.equal(idxk[va], idxp[va])
    assert torch.equal(mutk, mutp)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FPFH_GRID_CASES)
def test_lane_mutual_kernel_integer_grid_exact(cuda_device, case):
    """Kernel 2 on the FPFH lane tile, one launch: idx equal to the plain
    version's on every valid query row and mutual on every row."""
    a, b, ma, mb = _fpfh_grid_case(case, np.random.default_rng(20))
    before = KERNELS["lane_mutual"].launches
    idxk, mutk = nn_lane.nn_mutual_mask_lane(a, b, ma, mb)
    idxp, mutp = nn_lane.nn_mutual_lane_plain(a, b, ma, mb)
    torch.cuda.synchronize()
    assert KERNELS["lane_mutual"].launches == before + 1
    va = torch.ones(a.shape[:2], dtype=torch.bool, device=cuda_device) if ma is None else ma
    assert torch.equal(idxk[va], idxp[va])
    assert torch.equal(mutk, mutp)
    assert ((idxk >= 0) & (idxk < b.shape[1])).all()
    if case == "ties":  # both rows pick the first twin, and both pass
        assert (idxk[:, 3] == 7).all() and (idxk[:, 150] == 7).all()
        assert mutk[:, 3].all() and mutk[:, 150].all()
    if case == "empty":
        assert (idxk[1][va[1]] == 0).all() and not mutk[2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", FPFH_GRID_CASES)
def test_lane_nn_wide_kernel_integer_grid_exact(cuda_device, case):
    """Kernel 7 at d = 33 on the FPFH lane tile, one launch: d2 and idx equal
    to the plain version's on every valid query row (the query mask passed)."""
    q, t, qm, tm = _fpfh_grid_case(case, np.random.default_rng(21))
    before = KERNELS["lane_nn_wide"].launches
    d2k, idxk = nn_lane.nn_search_lane(q, t, qm, tm)
    d2p, idxp = nn_lane.nn_search_lane_plain(q, t, qm, tm)
    torch.cuda.synchronize()
    assert KERNELS["lane_nn_wide"].launches == before + 1
    vq = torch.ones(q.shape[:2], dtype=torch.bool, device=cuda_device) if qm is None else qm
    assert torch.equal(idxk[vq], idxp[vq])
    assert torch.equal(d2k[vq], d2p[vq])
    assert ((idxk >= 0) & (idxk < t.shape[1])).all()
    if case == "tile_end":
        assert (idxk[0][vq[0]] == 127).all() and (idxk[2][vq[2]] == t.shape[1] - 1).all()


@pytest.mark.gpu
def test_lane_nn_wide_fpfh_route_matches_kernel_5_per_lane(cuda_device):
    """Kernel 7 at d = 33 against kernel 5 (``t3t_nn_tiled_wide``, the same
    fmaf chain and -2 scale) run on each lane alone, on real-valued
    features: bit for bit on every valid query row, so the FPFH lane tile
    keeps a valid entry's bits."""
    rng = np.random.default_rng(22)
    B, M, N = 3, 700, 1100
    q = torch.tensor(rng.random((B, M, 33)) * 50, dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.random((B, N, 33)) * 50, dtype=torch.float32, device=cuda_device)
    qm = torch.tensor(rng.random((B, M)) > 0.25, device=cuda_device)
    tm = torch.tensor(rng.random((B, N)) > 0.25, device=cuda_device)
    d2k, idxk = nn_lane.nn_search_lane(q, t, qm, tm)
    for lane in range(B):
        before = KERNELS["nn_tiled_wide"].launches
        d2t, idxt = tnn.nn_search_tiled(q[lane], t[lane], None, tm[lane])
        torch.cuda.synchronize()
        assert KERNELS["nn_tiled_wide"].launches == before + 1
        v = qm[lane]
        assert torch.equal(idxk[lane][v], idxt[v])
        assert torch.equal(d2k[lane][v], d2t[v])


@pytest.mark.gpu
def test_fpfh_lane_kernels_take_lanes_above_8192_rows(cuda_device):
    """Kernels 2 and 7 at 8192 + 200 rows a lane side (kernel 2's lists then
    go to a device-memory scratch, kernel 7 sweeps its targets in parts of
    a block's list), with masks and a lane without a valid target, on an
    integer grid: equal to the plain versions on every valid query row
    (mutual on every row), one launch each."""
    rng = np.random.default_rng(23)
    B, n = 2, 8192 + 200
    a = torch.tensor(rng.integers(0, 4, size=(B, n, 33)), dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.integers(0, 4, size=(B, n, 33)), dtype=torch.float32, device=cuda_device)
    ma = torch.tensor(rng.random((B, n)) > 0.3, device=cuda_device)
    mb = torch.tensor(rng.random((B, n)) > 0.3, device=cuda_device)
    mb[1] = False
    before = {k: KERNELS[k].launches for k in ("lane_mutual", "lane_nn_wide")}
    idxk, mutk = nn_lane.nn_mutual_mask_lane(a, b, ma, mb)
    d2k, jk = nn_lane.nn_search_lane(a, b, ma, mb)
    torch.cuda.synchronize()
    assert KERNELS["lane_mutual"].launches == before["lane_mutual"] + 1
    assert KERNELS["lane_nn_wide"].launches == before["lane_nn_wide"] + 1
    idxp, mutp = nn_lane.nn_mutual_lane_plain(a, b, ma, mb)
    assert torch.equal(idxk[ma], idxp[ma]) and torch.equal(mutk, mutp)
    d2p, jp = nn_lane.nn_search_lane_plain(a, b, ma, mb)
    assert torch.equal(jk[ma], jp[ma]) and torch.equal(d2k[ma], d2p[ma])
    assert (jk[~ma] == 0).all() and (d2k[~ma] == tnn.BIG).all()
    assert mutk[0].any() and (jk[1][ma[1]] == 0).all()


@pytest.mark.gpu
def test_lane_nn_kernel_candidate_groups_match_copied_targets(cuda_device):
    """The rescue's verification: C candidate moves of a lane's source are
    C * M query rows of that lane ([B, C * M, 3] against [B, N, 3]); the same
    search on C copies of the targets gives the same bits."""
    rng = np.random.default_rng(9)
    B, C, M, N = 3, 4, 300, 500
    q = torch.tensor(rng.normal(size=(B, C * M, 3)), dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.normal(size=(B, N, 3)), dtype=torch.float32, device=cuda_device)
    tm = torch.tensor(rng.random((B, N)) > 0.2, device=cuda_device)
    d2k, idxk = nn_lane.nn_search_lane(q, t, None, tm)
    d2c, idxc = nn_lane.nn_search_lane(q.reshape(B * C, M, 3), t.repeat_interleave(C, 0), None,
                                       tm.repeat_interleave(C, 0))
    torch.cuda.synchronize()
    assert torch.equal(idxk.reshape(B * C, M), idxc) and torch.equal(d2k.reshape(B * C, M), d2c)


@pytest.mark.gpu
def test_lane_nn_kernels_take_only_their_widths(cuda_device):
    """Kernel 1 is built for d = 3, kernel 7 for 8 <= d <= 64; other widths
    raise on CUDA rather than run the plain version."""
    for d in (5, tnn.WIDE_MAX_D + 1):
        x = torch.zeros(1, 8, d, device=cuda_device)
        with pytest.raises(NotImplementedError):
            nn_lane.nn_search_lane(x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("nn_impl", ["lane", "values_pk"])
def test_fused_register_step_cuda_matches_cpu(cuda_device, nn_impl):
    """The whole slice on the card against the plain versions on the CPU,
    same inputs and sample bits, on the lane route and the default one
    (bf16 feature cross, f16 ICP payload): same poses (rotation within
    0.05 deg)."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.fused import fused_register_step
    from tpu3dm_torch.registration.hypotheses import sample_row_count

    cfg = PipelineConfig.with_voxel_size(0.3)
    sp, tp, T_true = make_benchmark_pair(8000, seed=3, sigma=0.01)
    s = preprocess_points(sp, cfg.preprocess, device="cpu").down
    t = preprocess_points(tp, cfg.preprocess, device="cpu").down
    B, K = 2, 1024
    args = [x[None].expand(B, *x.shape) for c in (s, t)
            for x in (c.points, c.features, c.mask, c.normals)]
    bits = draw_bits((B, 1, sample_row_count(s.capacity, K)), torch.Generator().manual_seed(1))
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=8, icp_solves_per_nn=4,
              approx_score=True, approx_features=True, nn_impl=nn_impl)
    before = {n: k.launches for n, k in KERNELS.items()}
    Tg, fg, _ = fused_register_step(*[a.to(cuda_device) for a in args], bits, **kw)
    Tc, fc, _ = fused_register_step(*args, bits, device="cpu", **kw)
    torch.cuda.synchronize()
    assert all(KERNELS[n].launches > before[n]
               for n in ("lane_nn_smalld", "lane_mutual", "ransac_score_bf16"))
    assert KERNELS["ransac_score"].launches == before["ransac_score"]  # approx_score: bf16
    _assert_close_poses(Tg, Tc, T_true)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", ["subset", "gather_adapt", "values_b16_rescue"])
def test_fused_options_cuda_match_cpu(cuda_device, opts):
    """The fused step with batch.py's RANSAC options (and the other f16
    route with the rescue) on the card against the CPU, same bits."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.parallel.multipair import chunk_bits_shape, draw_bits, extra_chunk_count
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.fused import fused_register_step

    cfg = PipelineConfig.with_voxel_size(0.3)
    sp, tp, T_true = make_benchmark_pair(8000, seed=3, sigma=0.01)
    s = preprocess_points(sp, cfg.preprocess, device="cpu").down
    t = preprocess_points(tp, cfg.preprocess, device="cpu").down
    B, K = 2, 1024
    args = [x[None].expand(B, *x.shape) for c in (s, t)
            for x in (c.points, c.features, c.mask, c.normals)]
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=8, icp_solves_per_nn=4,
              approx_score=True, approx_features=True)
    kw.update({"subset": dict(score_subset=256, rescore_top=64),
               "gather_adapt": dict(sample_mode="gather", adapt_iterations=3 * K),
               "values_b16_rescue": dict(nn_impl="values_b16", rescue_restarts=2)}[opts])
    lead = (B, 2) if "rescue_restarts" in kw else (B,)
    chunk = chunk_bits_shape(s.capacity, K, kw.get("sample_mode", "roll"))
    gen = torch.Generator().manual_seed(4)
    bits = draw_bits(lead + (1,) + chunk, gen)
    n_extra = extra_chunk_count(K, kw.get("adapt_iterations", 0), K)
    extra = draw_bits(lead + (n_extra,) + chunk, gen) if n_extra else None
    before = {n: k.launches for n, k in KERNELS.items()}
    Tg, _, _ = fused_register_step(*[a.to(cuda_device) for a in args], bits, extra_bits=extra,
                                   **kw)
    Tc, _, _ = fused_register_step(*args, bits, extra_bits=extra, device="cpu", **kw)
    torch.cuda.synchronize()
    if opts == "subset":  # the exact rescore is the fp32 route
        assert KERNELS["ransac_score"].launches == before["ransac_score"] + 1
    if opts == "values_b16_rescue":
        assert KERNELS["lane_mutual_bf16_cross"].launches == before["lane_mutual_bf16_cross"] + 1
    _assert_close_poses(Tg, Tc, T_true)


@pytest.mark.gpu
def test_escalated_register_step_cuda_matches_cpu(cuda_device):
    """The escalation (4 modes, the adaptive budget, 1 + 4 + 30 probes) on
    the card against the CPU, same bits and initial poses: T_true on lane
    0, on lane 1 an alias (T_true turned 90 deg about z through the source
    centroid) that the election must drop for another probe."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.fused import escalated_register_step

    cfg = PipelineConfig.with_voxel_size(0.3)
    sp, tp, T_true = make_benchmark_pair(8000, seed=3, sigma=0.01)
    s = preprocess_points(sp, cfg.preprocess, device="cpu").down
    t = preprocess_points(tp, cfg.preprocess, device="cpu").down
    B, K = 2, 1024
    args = [x[None].expand(B, *x.shape) for x in (s.points, s.features, s.mask, t.points,
                                                  t.features, t.mask, t.normals)]
    gen = torch.Generator().manual_seed(5)
    bits, extra = draw_bits((B, 1, s.capacity), gen), draw_bits((B, 2, s.capacity), gen)
    c = s.points[s.mask].mean(0)
    turn = torch.eye(4)
    turn[:2, :2] = torch.tensor([[0.0, -1.0], [1.0, 0.0]])
    turn[:3, 3] = c - turn[:3, :3] @ c
    T0 = torch.as_tensor(T_true, dtype=torch.float32)
    init = torch.stack([T0, T0 @ turn])
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, n_modes=4, adapt_iterations=3 * K)
    before = KERNELS["lane_nn_smalld"].launches
    Tg, _, _ = escalated_register_step(*[a.to(cuda_device) for a in args], bits,
                                       init.to(cuda_device), extra_bits=extra, **kw)
    Tc, _, _ = escalated_register_step(*args, bits, init, extra_bits=extra, device="cpu", **kw)
    torch.cuda.synchronize()
    # snap + 8 annealed + grading over every probe, 6 polish + grading
    assert KERNELS["lane_nn_smalld"].launches == before + 1 + 8 + 1 + 6 + 1
    _assert_close_poses(Tg, Tc, T_true)


def _assert_close_poses(Tg, Tc, T_true):
    """Card against CPU: rotation within 0.05 deg, translation within 5e-3,
    and the card's poses within 2 deg of T_true."""
    Tg, Tc = Tg.cpu().double(), Tc.double()
    fro = torch.linalg.matrix_norm(Tg[:, :3, :3] - Tc[:, :3, :3])
    assert torch.rad2deg(2 * torch.asin(fro / (2 * 2 ** 0.5))).max() < 0.05
    assert (Tg[:, :3, 3] - Tc[:, :3, 3]).abs().max() < 5e-3
    M = Tg[:, :3, :3].numpy() @ T_true[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(M, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert rot.max() < 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("nn_impl", ["lane", "values_pk"])
@pytest.mark.parametrize("mutual", [True, False])
def test_fused_rescue_cuda_matches_cpu(cuda_device, mutual, nn_impl):
    """One small rescue step (2 restarts, 6 modes, 8 verification solves)
    on the card against the plain versions on the CPU, same sample bits,
    on the lane route and the default one."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.fused import fused_register_step
    from tpu3dm_torch.registration.hypotheses import sample_row_count

    cfg = PipelineConfig.with_voxel_size(0.3)
    sp, tp, T_true = make_benchmark_pair(8000, seed=3, sigma=0.01)
    s = preprocess_points(sp, cfg.preprocess, device="cpu").down
    t = preprocess_points(tp, cfg.preprocess, device="cpu").down
    B, K, R = 2, 1024, 2
    args = [x[None].expand(B, *x.shape) for c in (s, t)
            for x in (c.points, c.features, c.mask, c.normals)]
    bits = draw_bits((B, R, 1, sample_row_count(s.capacity, K)),
                     torch.Generator().manual_seed(2))
    kw = dict(dist_thresh=cfg.ransac.dist_thresh, icp_thresh=cfg.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=8, icp_solves_per_nn=4,
              approx_score=True, approx_features=True, mutual_filter=mutual,
              rescue_restarts=R, rescue_modes=6, verify_iters=8, nn_impl=nn_impl)
    before = {n: k.launches for n, k in KERNELS.items()}
    Tg, _, _ = fused_register_step(*[a.to(cuda_device) for a in args], bits, **kw)
    Tc, _, _ = fused_register_step(*args, bits, device="cpu", **kw)
    torch.cuda.synchronize()
    used = "lane_mutual" if mutual else "lane_nn_wide"
    unused = "lane_nn_wide" if mutual else "lane_mutual"
    assert KERNELS[used].launches == before[used] + 1
    assert KERNELS[unused].launches == before[unused]
    assert KERNELS["ransac_score_bf16"].launches == before["ransac_score_bf16"] + R
    assert KERNELS["ransac_score"].launches == before["ransac_score"]
    # 8 annealed solves + 1 grading search over all candidates, 2 ICP searches
    assert KERNELS["lane_nn_smalld"].launches == before["lane_nn_smalld"] + 9 + 2
    _assert_close_poses(Tg, Tc, T_true)


@pytest.mark.gpu
def test_nn_tiled_smalld_kernel_matches_plain(cuda_device):
    """Same rounding order as the plain version: bit for bit, at a query
    count that takes the one-block-a-tile launch (300,000) and one that
    splits the targets over a cluster (700)."""
    rng = np.random.default_rng(3)
    t = torch.tensor(rng.normal(size=(5000, 3)), dtype=torch.float32, device=cuda_device)
    tm = torch.tensor(rng.random(5000) > 0.3, device=cuda_device)
    for nq in (700, 300_000):
        q = torch.tensor(rng.normal(size=(nq, 3)), dtype=torch.float32, device=cuda_device)
        before = KERNELS["nn_tiled_smalld"].launches
        d2k, idxk = tnn.nn_search_tiled(q, t, None, tm)
        d2p, idxp = tnn.nn_search_tiled_plain(q, t, None, tm)
        torch.cuda.synchronize()
        assert KERNELS["nn_tiled_smalld"].launches == before + 1
        assert torch.equal(idxk, idxp) and torch.equal(d2k, d2p)


def _tiled_case(case, rng):
    """(q [M, 3], t [N, 3], query mask [M] or None, target mask [N] or None)
    for kernel 4: path B's downsampled ICP (8192^2, the valid prefix of
    each padded cloud), A's donor normals (1,000,448 x 1024, every query
    valid), query and target counts that are no multiple of any tile or
    slice, no valid target at all, an integer grid full of exact ties
    (duplicated targets, masked twins), and masks that are strided views."""
    M, N = 8192, 8192
    if case == "donor":
        M, N = 1_000_448, 1024
    elif case == "ragged":
        M, N = 8192 + 37, 3001
    q = rng.normal(size=(M, 3))
    t = rng.normal(size=(N, 3))
    qm = np.zeros(M, bool)
    qm[:6750] = True
    tm = np.zeros(N, bool)
    tm[:6891] = True
    if case == "donor":
        qm, tm = None, rng.random(N) > 0.25
    elif case == "ragged":
        qm, tm = rng.random(M) > 0.2, rng.random(N) > 0.3
    elif case == "no_valid":
        tm[:] = False
    elif case == "grid_ties":
        q = rng.integers(-3, 4, size=(M, 3)).astype(np.float64)
        t = rng.integers(-3, 4, size=(N, 3)).astype(np.float64)
        t[5000:5400] = t[:400]
        tm[:200] = False
    elif case == "strided":
        qm = np.arange(M) % 3 != 1
        tm = rng.random(N) > 0.3
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return f32(q), f32(t), None if qm is None else torch.tensor(qm), torch.tensor(tm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["b_shape", "donor", "ragged", "no_valid", "grid_ties",
                                  "strided"])
def test_nn_tiled_smalld_kernel_query_mask_cases_exact(cuda_device, case):
    """Kernel 4 with its query mask: on valid query rows bit for bit the
    plain version's picks and distances; masked rows idx 0 and d2 = BIG;
    one launch.  "no_valid" runs the biased loop of every query; "strided"
    passes both masks as strided views at an odd byte offset."""
    q, t, qm, tm = (None if x is None else x.to(cuda_device)
                    for x in _tiled_case(case, np.random.default_rng(20)))
    if case == "strided":
        wide = torch.zeros((2, q.shape[0] + 3), dtype=torch.bool, device=cuda_device)
        wide[1, 3:] = qm
        qm = wide[1, 3:]
        wide_t = torch.zeros((2, t.shape[0] * 2 + 1), dtype=torch.bool, device=cuda_device)
        wide_t[1, 1::2] = tm
        tm = wide_t[1, 1::2]
        assert not tm.is_contiguous() and qm.data_ptr() % 16
    before = KERNELS["nn_tiled_smalld"].launches
    d2k, idxk = tnn.nn_search_tiled(q, t, qm, tm)
    d2p, idxp = tnn.nn_search_tiled_plain(q, t, qm, tm)
    torch.cuda.synchronize()
    assert KERNELS["nn_tiled_smalld"].launches == before + 1
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda_device) if qm is None else qm
    assert torch.equal(idxk[valid], idxp[valid])
    assert torch.equal(d2k[valid], d2p[valid])
    assert (idxk[~valid] == 0).all() and (d2k[~valid] == tnn.BIG).all()
    if case == "no_valid":
        assert (idxk[valid] == 0).all() and (d2k[valid] == tnn.BIG).all()


@pytest.mark.gpu
def test_nn_tiled_smalld_kernel_takes_only_3d(cuda_device):
    """Below d = 8 the kernel is built for d = 3 only; other widths raise on
    CUDA rather than run the plain version."""
    q = torch.zeros(8, 5, device=cuda_device)
    with pytest.raises(NotImplementedError):
        tnn.nn_search_tiled(q, q)


@pytest.mark.gpu
def test_nn_tiled_wide_kernel_matches_plain(cuda_device):
    """An fmaf chain against a cuBLAS product: picks equal on >= 99.9% of
    rows, distances within 1e-5 relative to |q|^2 + |t|^2."""
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.random((3000, 33)) * 50, dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.random((4100, 33)) * 50, dtype=torch.float32, device=cuda_device)
    tm = torch.tensor(rng.random(4100) > 0.1, device=cuda_device)
    d2k, idxk = tnn.nn_search_tiled(q, t, None, tm)
    d2p, idxp = tnn.nn_search_tiled_plain(q, t, None, tm)
    torch.cuda.synchronize()
    assert (idxk == idxp).float().mean() >= 0.999
    scale = (q * q).sum(1).max() + (t * t).sum(1).max()
    assert (d2k - d2p).abs().max() <= 1e-5 * scale
    assert tm[idxk.long()].all()


def _wide_case(case, rng):
    """(q [M, 33], t [N, 33], query mask [M] or None, target mask [N] or
    None) on an integer grid for kernel 5 at d = 33, where every dot is
    exact in any order, so the kernel equals the plain version bit for bit
    and ties abound: path B's FPFH shape (8192^2, the valid prefix of each
    padded cloud, so query tiles past the valid rows return at once and the
    targets split over a cluster of 8), no query mask, every query valid,
    random masks at counts no tile or share divides, no valid target, a
    share longer than one block's list (300 queries: 8 shares of ~8,500
    listed targets), twin targets within and across shares, and masks that
    are strided views at an odd byte offset."""
    M, N = 8192, 8192
    if case in ("none", "all"):
        M, N = 3000, 4100
    elif case == "random":
        M, N = 8192 + 37, 3001
    elif case == "long":
        M, N = 300, 70_000
    q = rng.integers(0, 4, size=(M, 33)).astype(np.float32)
    t = rng.integers(0, 4, size=(N, 33)).astype(np.float32)
    qm = np.arange(M) < 6750
    tm = np.arange(N) < 6891
    if case == "none":
        qm, tm = None, rng.random(N) > 0.1
    elif case == "all":
        qm, tm = np.ones(M, bool), rng.random(N) > 0.1
    elif case in ("random", "strided"):
        qm, tm = rng.random(M) > 0.3, rng.random(N) > 0.25
    elif case == "no_valid":
        tm[:] = False
    elif case == "long":
        qm, tm = rng.random(M) > 0.1, rng.random(N) > 0.03
    elif case == "ties":  # shares of ~861 listed targets: 10, 11, 70 in the first, 5000 in the sixth
        t[[11, 70, 5000]] = t[10]
        q[0] = t[10]
        q[1] = t[10]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return f32(q), f32(t), None if qm is None else torch.tensor(qm), torch.tensor(tm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["b_shape", "none", "all", "random", "no_valid", "long", "ties",
                                  "strided"])
def test_nn_tiled_wide_fpfh_route_query_mask_cases_exact(cuda_device, case):
    """Kernel 5 at d = 33 with its query mask: on valid query rows bit for
    bit the plain version's picks and distances (the first index of a tie,
    within a share and across shares); masked rows idx 0 and d2 = BIG; one
    launch."""
    q, t, qm, tm = (None if x is None else x.to(cuda_device)
                    for x in _wide_case(case, np.random.default_rng(24)))
    if case == "strided":
        wide = torch.zeros((2, q.shape[0] + 3), dtype=torch.bool, device=cuda_device)
        wide[1, 3:] = qm
        qm = wide[1, 3:]
        wide_t = torch.zeros((2, t.shape[0] * 2 + 1), dtype=torch.bool, device=cuda_device)
        wide_t[1, 1::2] = tm
        tm = wide_t[1, 1::2]
        assert not tm.is_contiguous() and qm.data_ptr() % 16
    before = KERNELS["nn_tiled_wide"].launches
    d2k, idxk = tnn.nn_search_tiled(q, t, qm, tm)
    d2p, idxp = tnn.nn_search_tiled_plain(q, t, qm, tm)
    torch.cuda.synchronize()
    assert KERNELS["nn_tiled_wide"].launches == before + 1
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda_device) if qm is None else qm
    assert torch.equal(idxk[valid], idxp[valid])
    assert torch.equal(d2k[valid], d2p[valid])
    assert (idxk[~valid] == 0).all() and (d2k[~valid] == tnn.BIG).all()
    if case == "ties":
        assert (idxk[:2] == 10).all() and (d2k[:2] == 0).all()
    if case == "no_valid":
        assert (idxk[valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 64])
def test_nn_tiled_wide_other_widths_integer_grid_exact(cuda_device, d):
    """Widths other than 33 stay on nn_wide.cuh, which computes every query
    row: bit for bit the plain version on an integer grid, masked targets
    never picked, the query mask not read."""
    rng = np.random.default_rng(25 + d)
    q = torch.tensor(rng.integers(0, 4, size=(700, d)), dtype=torch.float32, device=cuda_device)
    t = torch.tensor(rng.integers(0, 4, size=(1100, d)), dtype=torch.float32, device=cuda_device)
    qm = torch.tensor(rng.random(700) > 0.3, device=cuda_device)
    tm = torch.tensor(rng.random(1100) > 0.3, device=cuda_device)
    d2k, idxk = tnn.nn_search_tiled(q, t, qm, tm)
    d2p, idxp = tnn.nn_search_tiled_plain(q, t, qm, tm)
    torch.cuda.synchronize()
    assert torch.equal(idxk, idxp) and torch.equal(d2k, d2p)
    assert tm[idxk.long()].all()


def _fp32_score_case(case, inputs, rng, device):
    """(H, e, F, c, mask, thr) for kernel 3's fp32 route: one lane at the
    large path's shape (K 4096, N 8192, a third valid: the correspondence
    axis split over a cluster), 2048 lanes (no split), K no multiple of the
    256 hypotheses a block takes with N over a block's 2048-row list, and
    lanes with no valid row.  "dyadic": small integers, so every sum is
    exact in any order; "random": rigid hypotheses and noisy pairs."""
    B, K, N = {"one_lane": (1, 4096, 8192), "lanes": (2048, 1024, 1024),
               "ragged_k": (3, 700, 2300), "no_valid": (2, 300, 500)}[case]
    if inputs == "dyadic":
        H = rng.integers(-8, 9, size=(B, K, 16)).astype(np.float32)
        F = rng.integers(-8, 9, size=(B, N, 16)).astype(np.float32)
        H[..., 15] = 0
        e = rng.integers(0, 300, size=(B, K)).astype(np.float32)
        c = rng.integers(0, 300, size=(B, N)).astype(np.float32)
        H, e, F, c = (torch.tensor(x, device=device) for x in (H, e, F, c))
        thr = 300.5
    else:
        R = exp_so3(torch.tensor(rng.normal(size=(B, K, 3)) * 0.3, dtype=torch.float32))
        t = torch.tensor(rng.normal(size=(B, K, 3)) * 0.2, dtype=torch.float32)
        p = torch.tensor(rng.normal(size=(B, N, 3)), dtype=torch.float32)
        q = p + torch.tensor(rng.normal(size=(B, N, 3)) * 0.3, dtype=torch.float32)
        F, c = ransac_score.corres_features(p.to(device), q.to(device))
        H, e = ransac_score.hypothesis_features(R.to(device), t.to(device))
        thr = float(np.float32(0.6) ** 2)
    mask = torch.tensor(rng.random((B, N)) < 1 / 3, device=device)
    if case == "no_valid":
        mask[0] = False
    return H.contiguous(), e.contiguous(), F.contiguous(), c.contiguous(), mask, thr


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["dyadic", "random"])
@pytest.mark.parametrize("case", ["one_lane", "lanes", "ragged_k", "no_valid"])
def test_ransac_score_fp32_kernel_cases(cuda_device, case, inputs):
    """Kernel 3's fp32 route, one launch: counts equal to the plain version's
    on dyadic inputs, and inside the float64 bracket of FP32_CHAIN_REL on
    random ones (equal on >= 99.9% of hypotheses, never more than 1 apart);
    a lane with no valid row counts 0."""
    H, e, F, c, m, thr = _fp32_score_case(case, inputs, np.random.default_rng(26), cuda_device)
    before = {n: KERNELS[n].launches for n in ("ransac_score", "ransac_score_bf16")}
    ck = ransac_score.score_features(H, e, F, c, m, thr)
    cp = ransac_score.score_features_plain(H, e, F, c, m, thr)
    torch.cuda.synchronize()
    assert KERNELS["ransac_score"].launches == before["ransac_score"] + 1
    assert KERNELS["ransac_score_bf16"].launches == before["ransac_score_bf16"]
    if inputs == "dyadic":
        assert torch.equal(ck, cp)
    else:
        sure, near = ransac_score.score_count_bracket(H, e, F, c, m, thr,
                                                      ransac_score.FP32_CHAIN_REL)
        assert ((ck >= sure) & (ck <= sure + near)).all()
        diff = (ck - cp).abs()
        assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999
    if case == "no_valid":
        assert (ck[0] == 0).all() and ck[1].max() > 0
    else:
        assert ck.max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random_masks", "no_valid_target"])
def test_feature_correspondences_cuda_matches_cpu(cuda_device, case):
    """The mutual filter above DENSE_MAX_ENTRIES on the card (kernel 5 twice:
    forward with the query mask, backward without) against the plain
    versions on the CPU, on an integer grid (exact distances, many ties):
    validity equal on every row, pairs on every valid row, with every
    target masked too (the CPU run against JAX: test_torch_large.py)."""
    from tpu3dm_torch.core.cloud import from_reference_arrays
    from tpu3dm_torch.registration.correspondence import feature_correspondences

    rng = np.random.default_rng({"random_masks": 11, "no_valid_target": 12}[case])
    cap = 4352  # 4352^2 > 16M entries
    clouds = []
    for keep in (0.7, 0.0 if case == "no_valid_target" else 0.75):
        pts = rng.normal(size=(cap, 3)).astype(np.float32)
        feat = rng.integers(0, 4, size=(cap, 33)).astype(np.float32)
        mask = rng.random(cap) < keep
        clouds.append(dict(points=pts, normals=np.zeros_like(pts), features=feat, mask=mask))
    cpu = [from_reference_arrays(a, device="cpu") for a in clouds]
    card = [from_reference_arrays(a, device=cuda_device) for a in clouds]
    before = KERNELS["nn_tiled_wide"].launches
    pg, vg = feature_correspondences(*card, mutual_filter=True)
    torch.cuda.synchronize()
    assert KERNELS["nn_tiled_wide"].launches == before + 2
    pc, vc = feature_correspondences(*cpu, mutual_filter=True)
    assert torch.equal(vg.cpu(), vc)
    assert torch.equal(pg.cpu()[vc], pc[vc])


def _sparse_pair(block, device, n_tgt=30000, n_qry=29000):
    """KD-sorted arch clouds padded to the block (30,000 and 29,000 points:
    no block size divides them, so each last block is partly padding)."""
    from tpu3dm_torch.io.synthetic import dental_arch_cloud

    tgt = dental_arch_cloud(n_tgt, seed=0).astype(np.float32)
    qry = dental_arch_cloud(n_qry, seed=1).astype(np.float32) + 0.005
    tp = torch.tensor(nn_sparse.pad_sorted(tgt[nn_sparse.kd_perm(tgt, block)], block),
                      device=device)
    qp = torch.tensor(nn_sparse.pad_sorted(qry[nn_sparse.kd_perm(qry, block)], block),
                      device=device)
    return qp, tp


def _blocksparse_exact(qp, tp, table, block):
    before = KERNELS["nn_blocksparse"].launches
    d2k, idxk = nn_sparse.nn_search_table(qp, tp, table, block=block)
    d2p, idxp = nn_sparse.nn_search_table_plain(qp, tp, table, block=block)
    torch.cuda.synchronize()
    assert KERNELS["nn_blocksparse"].launches == before + 1
    assert torch.equal(idxk, idxp) and torch.equal(d2k, d2p)
    return idxk


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("block", [256, 512, 1024, 2048])
def test_nn_blocksparse_kernel_matches_plain(cuda_device, block, w):
    """Same rounding order as the plain version: bit for bit, sentinel rows
    included, on KD-sorted clouds with their candidate table, at every
    block size the large path may take and at one and eight visits."""
    qp, tp = _sparse_pair(block, cuda_device)
    assert qp.shape[0] > 29000 and tp.shape[0] > 30000  # padded last blocks
    table, _ = nn_sparse.candidate_blocks(qp, tp, block, w)
    _blocksparse_exact(qp, tp, table, block)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [256, 512])
def test_nn_blocksparse_kernel_ties_across_rows_and_visits(cuda_device, block):
    """An integer grid with duplicated points: target blocks 0 and 1 hold
    the same rows, and every query block visits block 1 first and block 0
    second.  Exact ties within a block, across blocks and across visits go
    to the first row of the earliest visit, as in the plain version, so no
    pick lands in block 0."""
    rng = np.random.default_rng(block)
    ntb, nqb, w = 12, 9, 8
    t = rng.integers(-2, 3, size=(ntb * block, 3)).astype(np.float32)
    t[:block] = t[block:2 * block]
    q = rng.integers(-2, 3, size=(nqb * block, 3)).astype(np.float32)
    table = rng.integers(2, ntb, size=(nqb, w))
    table[:, 0], table[:, 1] = 1, 0
    idx = _blocksparse_exact(torch.tensor(q, device=cuda_device),
                             torch.tensor(t, device=cuda_device),
                             torch.tensor(table, dtype=torch.int32, device=cuda_device), block)
    assert (idx >= block).all()


@pytest.mark.gpu
def test_new_wrappers_raise_on_wrong_cuda_input(cuda_device):
    q = torch.zeros(8, 3, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        tnn.nn_search_tiled(q, q)
    q = torch.zeros(8, 6, device=cuda_device)[:, :3]  # not contiguous
    with pytest.raises(ValueError):
        tnn.nn_search_tiled(q, q)
    with pytest.raises(TypeError):
        nn_sparse.nn_search_table(torch.zeros(8, 3, device=cuda_device),
                                  torch.zeros(8, 3, device=cuda_device),
                                  torch.zeros(2, 1, dtype=torch.int64, device=cuda_device), block=4)


@pytest.mark.gpu
def test_register_arrays_large_cuda_matches_cpu(cuda_device):
    """The large-cloud slice on the card against the plain versions on the
    CPU, same sample bits: poses within 0.5 deg and 0.02, every new kernel
    launched, inside bench.py's gate."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.registration.large import register_arrays_large
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.ransac import chunk_count

    cfg = PipelineConfig.with_voxel_size(0.1)  # 8192-capacity clouds: both tiled kernels
    sp, tp, T_true = make_benchmark_pair(60000, seed=2, sigma=0.002)
    k = cfg.ransac.batch_size
    bits = torch.stack([draw_bits((chunk_count(cfg.ransac.max_iterations, k), k, 2),
                                  torch.Generator().manual_seed(r)) for r in range(2)])
    before = {n: kern.launches for n, kern in KERNELS.items()}
    fg, _ = register_arrays_large(sp, tp, cfg, restarts=2, sample_bits=bits)
    torch.cuda.synchronize()
    for name in ("ransac_score", "nn_tiled_smalld", "nn_tiled_wide", "nn_blocksparse"):
        assert KERNELS[name].launches > before[name], name
    assert KERNELS["ransac_score_bf16"].launches == before["ransac_score_bf16"]  # fp32 score
    fc, _ = register_arrays_large(sp, tp, cfg, restarts=2, sample_bits=bits, device="cpu")
    Tg, Tc = fg.transformation.cpu().double(), fc.transformation.double()
    fro = torch.linalg.matrix_norm(Tg[:3, :3] - Tc[:3, :3])
    assert torch.rad2deg(2 * torch.asin(fro / (2 * 2 ** 0.5))) < 0.5
    assert (Tg[:3, 3] - Tc[:3, 3]).abs().max() < 0.02
    T = Tg.numpy()
    rot = np.degrees(np.arccos(np.clip((np.trace(T[:3, :3] @ T_true[:3, :3].T) - 1) / 2, -1, 1)))
    moved = sp @ T[:3, :3].T + T[:3, 3]
    expect = sp @ T_true[:3, :3].T + T_true[:3, 3]
    assert rot < 2.0 and np.sqrt(((moved - expect) ** 2).sum(1).mean()) < 0.01


# ---------------------------------------------------------------------------
# The batch API and its ingest (registration/batch.py, preprocess_points_batch,
# the device voxel grid, the dense features) on the card against the CPU
# ---------------------------------------------------------------------------


def _features_close(a, b):
    """Down normals and FPFH of two runs of one cloud, held to the bounds of
    tests/test_torch_preprocess.py (|dot| > 0.9999 on >= 99% of valid rows
    and > 0.9 on all; FPFH relative L1 median < 2e-3, 90th percentile
    < 1e-2, max < 0.6); equal masks."""
    m = b.mask.cpu().numpy()
    assert np.array_equal(a.mask.cpu().numpy(), m)
    dots = (a.normals.cpu().numpy() * b.normals.cpu().numpy()).sum(1)[m]
    assert (dots > 0.9999).mean() >= 0.99 and dots.min() > 0.9
    fa, fb = a.features.cpu().numpy(), b.features.cpu().numpy()
    rel = np.abs(fa - fb).sum(1)[m] / np.abs(fb).sum(1)[m]
    assert np.median(rel) < 2e-3 and np.quantile(rel, 0.9) < 1e-2 and rel.max() < 0.6


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0.0, 2000.0])
def test_voxel_downsample_cuda_equals_host_grid(cuda_device, shift):
    from tpu3dm_torch.core.cloud import from_numpy
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess import voxel

    sp = (make_benchmark_pair(20000, seed=3, sigma=0.01)[0] + shift).astype(np.float32)
    pc = from_numpy(sp, device=cuda_device)
    grid = voxel.voxel_downsample(pc, 0.3)
    assert grid.points.is_cuda and grid.capacity == pc.capacity
    grid = voxel.compact(grid)
    host = voxel.voxel_downsample_host(sp, 0.3, device=cuda_device)
    assert torch.equal(grid.points, host.points) and torch.equal(grid.mask, host.mask)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0.0, 2000.0])
def test_preprocess_points_batch_cuda_matches_cpu(cuda_device, shift):
    """Batched ingest on the card against the CPU (same down points, features
    within the CPU tests' bounds), each cloud's self-distance pinned, and the
    noise of given draws equal on both."""
    import dataclasses

    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    pp = dataclasses.replace(PipelineConfig.with_voxel_size(0.3).preprocess, noise_sigma=0.05)
    clouds = [c + shift for s in range(2) for c in make_benchmark_pair(6000, seed=s,
                                                                      sigma=0.01)[:2]]
    noise = torch.randn((4, 768, 3), generator=torch.Generator().manual_seed(1))
    card = preprocess_points_batch(clouds, pp, noise=noise, full_normals=False)
    cpu = preprocess_points_batch(clouds, pp, noise=noise, full_normals=False, device="cpu")
    for a, b in zip(card, cpu):
        assert a.down.points.is_cuda and a.down.capacity == b.down.capacity == 768
        assert torch.equal(a.down.points.cpu(), b.down.points)
        _features_close(a.down, b.down)


@pytest.mark.gpu
def test_register_pairs_batched_cuda_matches_cpu(cuda_device):
    """Two buckets of mixed-size pairs on the card against the CPU, same
    bits: poses within 0.5 deg and 0.02, one mutual search, 4 ICP searches
    and one bf16 score a bucket; the shared target equals the pair-batched
    call on the card; a resumed checkpoint launches nothing."""
    import tempfile

    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.multiway.checkpoint import CheckpointStore
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch
    from tpu3dm_torch.registration import batch

    cfg = PipelineConfig.with_voxel_size(0.3)
    raw = [c for s, n in ((0, 3000), (1, 20000), (2, 3500))
           for c in make_benchmark_pair(n, seed=s, sigma=0.01)[:2]]
    card = preprocess_points_batch(raw, cfg.preprocess, full_normals=False)
    cpu = preprocess_points_batch(raw, cfg.preprocess, full_normals=False, device="cpu")
    pairs = [(card[i], card[i + 1]) for i in range(0, 6, 2)]
    cpu_pairs = [(cpu[i], cpu[i + 1]) for i in range(0, 6, 2)]
    bits = draw_bits((3, 1, 256), torch.Generator().manual_seed(2))
    kw = dict(pair_bits=bits, ransac_iterations=1024, bucket_multiple=64)
    reset_launch_counts()
    res = batch.register_pairs_batched(pairs, cfg, **kw)
    n_buckets = len(set(res.bucket_of_pair))
    assert n_buckets == 2
    assert KERNELS["lane_mutual"].launches == n_buckets
    assert KERNELS["lane_nn_smalld"].launches == 4 * n_buckets
    assert KERNELS["ransac_score_bf16"].launches == n_buckets
    ref = batch.register_pairs_batched(cpu_pairs, cfg, device="cpu", **kw)
    assert res.bucket_of_pair == ref.bucket_of_pair
    Ta, Tb = torch.from_numpy(res.transforms).double(), torch.from_numpy(ref.transforms).double()
    fro = torch.linalg.matrix_norm(Ta[:, :3, :3] - Tb[:, :3, :3])
    assert torch.rad2deg(2 * torch.asin(fro / (2 * 2 ** 0.5))).max() < 0.5
    assert (Ta[:, :3, 3] - Tb[:, :3, 3]).abs().max() < 0.02
    shared = batch.register_sources_to_target([p[0] for p in pairs],
                                              batch.ResidentTarget(pairs[0][1]), cfg, **kw)
    direct = batch.register_pairs_batched([(p[0], pairs[0][1]) for p in pairs], cfg, **kw)
    np.testing.assert_allclose(shared.transforms, direct.transforms, atol=1e-4)
    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(checkpoint=CheckpointStore(tmp), pair_names=["a", "b", "c"], **kw)
        first = batch.register_pairs_batched(pairs, cfg, **ck)
        reset_launch_counts()
        again = batch.register_pairs_batched(pairs, cfg, **ck)
    assert again.bucket_of_pair == [-1] * 3 and all(k.launches == 0 for k in KERNELS.values())
    np.testing.assert_allclose(again.transforms, first.transforms, atol=1e-6)


@pytest.mark.gpu
def test_down_features_dense_cuda_matches_cpu(cuda_device):
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.dense import down_features_dense
    from tpu3dm_torch.preprocess.voxel import voxel_downsample_host

    pp = PipelineConfig.with_voxel_size(0.3).preprocess
    sp = make_benchmark_pair(20000, seed=4, sigma=0.01)[0]
    for kn, kf in ((30, 100), (100, 30), (0, 0)):
        outs = [down_features_dense(voxel_downsample_host(sp, 0.3, device=d), pp.normal_radius,
                                    pp.fpfh_radius, normal_max_nn=kn, fpfh_max_nn=kf)
                for d in (cuda_device, "cpu")]
        assert outs[0].features.is_cuda
        _features_close(*outs)


@pytest.mark.gpu
def test_down_features_dense_batch_invariant_on_the_card(cuda_device):
    """A cloud's dense features do not depend on the clouds that share its
    call, its chunk, or its place in the batch: the stream's window
    invariance rests on it (the three families at the stream's capacity)."""
    from tpu3dm_torch.core.cloud import PointCloud
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess import dense
    from tpu3dm_torch.preprocess.voxel import voxel_downsample_host

    pp = PipelineConfig.with_voxel_size(0.3).preprocess
    cap = 896
    clouds = []
    for s in range(12):
        for raw in make_benchmark_pair(20000, seed=s, sigma=0.01,
                                       family=("arch", "plate", "scan")[s % 3])[:2]:
            down = voxel_downsample_host(raw, 0.3, device="cpu")
            n = int(down.mask.sum())
            p, m = torch.zeros((cap, 3)), torch.zeros((cap,), dtype=torch.bool)
            p[:n], m[:n] = down.points[:n], True
            clouds.append((p, m))
    pts = torch.stack([c[0] for c in clouds]).to(cuda_device)
    msk = torch.stack([c[1] for c in clouds]).to(cuda_device)

    def features(idx, plane_bytes=dense.DENSE_PLANE_BYTES):
        old = dense.DENSE_PLANE_BYTES
        dense.DENSE_PLANE_BYTES = plane_bytes
        try:
            pc = PointCloud(pts[idx], msk[idx], torch.zeros_like(pts[idx]),
                            torch.zeros(pts[idx].shape[:2] + (0,), device=cuda_device))
            out = dense.down_features_dense(pc, pp.normal_radius, pp.fpfh_radius,
                                            normal_max_nn=pp.normal_max_nn,
                                            fpfh_max_nn=pp.fpfh_max_nn)
        finally:
            dense.DENSE_PLANE_BYTES = old
        return out.normals.cpu(), out.features.cpu()

    every = torch.arange(len(clouds))
    whole = features(every)
    chunked = features(every, plane_bytes=4 * cap * cap * 5)
    reordered = features(every.flip(0))
    for i in range(len(clouds)):
        alone = features(torch.tensor([i]))
        for k in range(2):
            assert torch.equal(whole[k][i], alone[k][0]), (i, k)
            assert torch.equal(whole[k][i], chunked[k][i]), (i, k)
            assert torch.equal(whole[k][i], reordered[k][len(clouds) - 1 - i]), (i, k)


@pytest.mark.gpu
def test_fit_rigid_horn_does_not_follow_the_batch_size(cuda_device):
    """The refit's weighted Horn fit of one lane is the same bits alone and
    in a batch of 2, 8, 16, 64 or 384 fits: its sums over the rows do not
    take their order from the batch count (a batched product's kernel and
    ``torch.sum`` below a dozen rows do), so neither the stream's window nor
    a serving micro-batch can change a registration."""
    from tpu3dm_torch.registration.kabsch import fit_rigid_horn

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n, m = 384, 896
    p = torch.randn((n, m, 3), generator=gen, device=cuda_device)
    q = p + 0.01 * torch.randn((n, m, 3), generator=gen, device=cuda_device)
    w = (torch.rand((n, m), generator=gen, device=cuda_device) > 0.6).to(torch.float32)
    whole = fit_rigid_horn(p, q, w)
    for k in (1, 2, 8, 16, 64):
        assert torch.equal(fit_rigid_horn(p[:k], q[:k], w[:k]), whole[:k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 31, 32, 33, 1000, 1024, 20000])
def test_row_sums_kernel_equals_plain(cuda_device, m):
    """The ordered-row-sum kernel against its plain version, bit for bit,
    on rows from one to thousands, ragged widths and signed values."""
    gen = torch.Generator().manual_seed(m)
    for rows in (1, 27, 2048 * 27):
        if rows * m > 1 << 26:
            continue
        x = torch.randn((rows, m), generator=gen) * torch.logspace(-3, 3, m)
        reset_launch_counts()
        card = rowsum.row_sums(x.to(cuda_device))
        assert KERNELS["row_sums"].launches == 1
        assert torch.equal(card.cpu(), rowsum.row_sums_plain(x)), (rows, m)


@pytest.mark.gpu
def test_row_sums_kernel_takes_only_float32(cuda_device):
    with pytest.raises(TypeError):
        rowsum.row_sums(torch.zeros((2, 40), dtype=torch.float64, device=cuda_device))


def _fused_batch_inputs(device, n_pairs=8, cap=1024):
    """Eight arch pairs of 20,000 points at voxel 0.3, each padded to
    ``cap`` as batch.py pads a bucket, and the batch API's knobs."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch
    from tpu3dm_torch.registration import batch

    cfg = PipelineConfig.with_voxel_size(0.3)
    raw = [c for s in range(n_pairs) for c in make_benchmark_pair(20000, seed=s, sigma=0.01)[:2]]
    procs = preprocess_points_batch(raw, cfg.preprocess, full_normals=False, device=device)
    padded = [batch._at_cap(batch._tight(p), cap, device) for p in procs]
    knobs = batch._Knobs.of(cfg, ransac_iterations=4096, icp_iterations=8, icp_solves_per_nn=2,
                            approx_score=True, sample_mode="roll")
    return padded, knobs


def _fused_stages(src, tgt, bits, knobs):
    """The stages of ``fused_register_step`` with batch.py's knobs, as the
    step runs them: (name, output) in order."""
    from tpu3dm_torch.parallel.multipair import ransac_pair_step
    from tpu3dm_torch.registration import fused

    sp, sf, sm = src
    tp, tf, tm, tn = tgt
    route = fused.nn_route("values_pk")
    frame_c = fused._pn_center(tp, tm)
    sp = (sp - frame_c[:, None, :]).contiguous()
    tp = (tp - frame_c[:, None, :]).contiguous()
    q_all, valid = fused.correspondences(sf, tf, sm, tm, tp, approx=False, route=route)
    T, count = ransac_pair_step(
        sp, q_all, valid, bits, dist_thresh=knobs.dist_thresh,
        iterations=knobs.ransac_iterations, batch_size=min(knobs.ransac_iterations, 4096),
        approx_score=knobs.approx_score, score_subset=knobs.score_subset,
        rescore_top=knobs.rescore_top)
    T_icp, rmse = fused.icp_polish(T, sp, sm, tp, tm, tn, icp_thresh=knobs.icp_thresh,
                                   icp_iterations=knobs.icp_iterations,
                                   icp_solves_per_nn=knobs.icp_solves_per_nn, f16_payload=True)
    return [("frame centre", frame_c), ("correspondences", q_all), ("valid", valid),
            ("RANSAC + refit", T), ("RANSAC count", count), ("ICP", T_icp), ("ICP rmse", rmse),
            ("world pose", fused._unshift(T_icp, frame_c))]


@pytest.mark.gpu
def test_fused_step_pair_does_not_follow_the_batch_size(cuda_device):
    """One pair through ``fused_register_step`` with batch.py's knobs
    (``values_pk``, fp32 features, bf16 score, 2 solves a search) is the
    same bits alone and in batches of 2, 8 and 128 pairs: the serving
    engine's micro-batches run at every size.  A difference names the
    first stage (in the step's order) where lane 0 differs."""
    from tpu3dm_torch.parallel.multipair import draw_bits

    padded, knobs = _fused_batch_inputs(cuda_device)
    n = len(padded) // 2
    bits = draw_bits((128,) + knobs.bits_shape(1024)[0], torch.Generator().manual_seed(5))

    def run(b):
        lanes = [i % n for i in range(b)]
        src = [torch.stack([padded[2 * i][k] for i in lanes]) for k in (0, 1, 2)]
        tgt = [torch.stack([padded[2 * i + 1][k] for i in lanes]) for k in (0, 1, 2, 3)]
        stages = _fused_stages(src, tgt, bits[:b].to(cuda_device), knobs)
        step = knobs.step(src, tgt, bits[:b], None, cuda_device)
        return stages, step

    ref_stages, ref_step = run(128)
    for b in (1, 2, 8):
        stages, step = run(b)
        first = next(((name, float((out[0].double() - ref[0].double()).abs().max()))
                      for (name, out), (_, ref) in zip(stages, ref_stages)
                      if not torch.equal(out[0], ref[0])), None)
        assert first is None, f"B={b}: lane 0 first differs from B=128 at {first}"
        for k in range(3):
            assert torch.equal(step[k][0], ref_step[k][0]), (b, k)


@pytest.mark.gpu
def test_batched_register_mesh_on_one_card_is_bit_equal(cuda_device):
    """``batched_register`` on a simulated mesh of four pair shards on one
    card ([cuda] * 4) is the same bits as on the one-device mesh: the shard
    split, the per-shard fused steps and the gather change no pair."""
    from tpu3dm_torch.parallel.mesh import make_mesh
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.parallel.register import batched_register

    padded, knobs = _fused_batch_inputs(cuda_device)
    lanes = [i % (len(padded) // 2) for i in range(16)]
    src = [torch.stack([padded[2 * i][k] for i in lanes]) for k in (0, 1, 2)]
    tgt = [torch.stack([padded[2 * i + 1][k] for i in lanes]) for k in (0, 1, 2, 3)]
    bits = draw_bits((16,) + knobs.bits_shape(1024)[0], torch.Generator().manual_seed(6))
    kw = dict(dist_thresh=knobs.dist_thresh, icp_thresh=knobs.icp_thresh,
              ransac_iterations=knobs.ransac_iterations, icp_iterations=knobs.icp_iterations,
              icp_solves_per_nn=knobs.icp_solves_per_nn, approx_score=knobs.approx_score)

    def run(n_pair):
        mesh = make_mesh(n_pair, 1, devices=[cuda_device] * n_pair)
        return batched_register(mesh, *src, None, *tgt, bits, **kw)

    one, four = run(1), run(4)
    for k in range(3):
        assert torch.equal(four[k], one[k]), k


@pytest.fixture
def cards(cuda_device):
    """Every visible card; skips below two (the tests that need them run on
    a machine with several cards)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards, found {n}")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.gpu
def test_batched_register_mesh_over_cards_is_bit_equal(cards):
    """A pair shard on each card gives the bits of one shard on card 0."""
    from tpu3dm_torch.parallel.mesh import make_mesh
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.parallel.register import batched_register

    padded, knobs = _fused_batch_inputs(cards[0])
    n = 4 * len(cards)
    lanes = [i % (len(padded) // 2) for i in range(n)]
    src = [torch.stack([padded[2 * i][k] for i in lanes]) for k in (0, 1, 2)]
    tgt = [torch.stack([padded[2 * i + 1][k] for i in lanes]) for k in (0, 1, 2, 3)]
    bits = draw_bits((n,) + knobs.bits_shape(1024)[0], torch.Generator().manual_seed(7))
    kw = dict(dist_thresh=knobs.dist_thresh, icp_thresh=knobs.icp_thresh,
              ransac_iterations=knobs.ransac_iterations, icp_iterations=knobs.icp_iterations,
              icp_solves_per_nn=knobs.icp_solves_per_nn, approx_score=knobs.approx_score)
    one = batched_register(make_mesh(1, 1, devices=cards[:1]), *src, None, *tgt, bits, **kw)
    many = batched_register(make_mesh(len(cards), 1), *src, None, *tgt, bits, **kw)
    for k in range(3):
        assert torch.equal(many[k], one[k]), k


# Pair-sharded RANSAC on a 2x1 mesh and the ring ICP on a 1x2 mesh: run by
# each NCCL process and by the one-process mesh over the same two cards.
_MESH_CASES = """
import numpy as np
import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.parallel.multipair import batched_ransac
from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
from tpu3dm_torch.registration.hypotheses import sample_row_count


def mesh_cases(pair_mesh, block_mesh):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4, 256, 3)).astype(np.float32)
    bits = torch.from_numpy(rng.integers(0, 1 << 32, (4, 2, sample_row_count(256, 256)),
                                         dtype=np.int64))
    home = pair_mesh.home
    Ts, fit = batched_ransac(pair_mesh, torch.from_numpy(p).to(home),
                             torch.from_numpy(p + 0.01).to(home),
                             torch.ones(4, 256, dtype=torch.bool, device=home), bits,
                             dist_thresh=0.1, iterations=512, batch_size=256)
    tgt = rng.normal(size=(200_001, 3)).astype(np.float32)
    nrm = rng.normal(size=tgt.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    Tinv = torch.linalg.inv(se3.exp_se3(torch.tensor([0.02, -0.01, 0.015, 0.03, -0.02, 0.01])))
    src = (tgt @ Tinv[:3, :3].numpy().T + Tinv[:3, 3].numpy()).astype(np.float32)
    res = icp_refine_sharded(block_mesh, src, tgt, np.eye(4), tgt_normals=nrm,
                             dist_thresh=0.3, max_iterations=10)
    return dict(Ts=Ts.cpu().numpy(), fit=fit.cpu().numpy(),
                T=res.transformation.cpu().numpy(), fitness=res.fitness.cpu().numpy(),
                it=res.iterations.numpy())
"""

_NCCL_WORKER = _MESH_CASES + """
import sys

coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
from tpu3dm_torch.parallel.mesh import initialize_distributed, make_mesh

initialize_distributed(coordinator=coord, num_processes=2, process_id=rank, backend="nccl")
import torch.distributed as dist

card = [torch.device("cuda", rank)]
res = mesh_cases(make_mesh(2, 1, devices=card), make_mesh(1, 2, devices=card))
np.savez(out, **res)
dist.destroy_process_group()
print(f"rank {rank}: OK", flush=True)
"""


@pytest.mark.gpu
def test_two_process_nccl_mesh_equals_one_process(cards, tmp_path):
    """Two NCCL processes, one card each, against the one-process mesh over
    the same two cards: pair-sharded RANSAC and the dense ring ICP on
    200,001 points (kernel 4 in every ring step), bit for bit."""
    import os
    import socket
    import subprocess
    import sys

    from tpu3dm_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_NCCL_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(r), str(tmp_path / f"r{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out[-3000:]
    cases: dict = {}
    exec(_MESH_CASES, cases)
    ref = cases["mesh_cases"](make_mesh(2, 1, devices=cards[:2]),
                              make_mesh(1, 2, devices=cards[:2]))
    assert ref["fit"].min() > 0.99 and float(ref["fitness"]) > 0.99
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.gpu
def test_knn_features_do_not_follow_the_cloud_count(cuda_device):
    """``preprocess_points_batch(..., full_normals=False)``, the kNN feature
    route of the server (one cloud a request) and the stream's generic
    path: each cloud's down normals and features are the same bits at C =
    1, 16 and 256 clouds a call (one down capacity for all)."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    pp = PipelineConfig.with_voxel_size(0.3).preprocess
    clouds = [c for s in range(128) for c in make_benchmark_pair(20000, seed=s, sigma=0.01)[:2]]

    def feats(cs):
        out = preprocess_points_batch(cs, pp, full_normals=False, down_cap=1024)
        return [(p.down.normals.cpu(), p.down.features.cpu()) for p in out]

    whole = feats(clouds)
    sixteen = feats(clouds[:16])
    one = feats(clouds[:1])
    for i in range(16):
        for k in range(2):
            assert torch.equal(sixteen[i][k], whole[i][k]), (i, k)
    for k in range(2):
        assert torch.equal(one[0][k], whole[0][k]), k


def _noisy_graph(n, seed):
    """n random poses joined to their next two neighbours (a ring), each
    measurement off by ~0.03 in every tangent coordinate: (T_meas, edges,
    weights, truth).  Every edge keeps a residual far above ~3.5e-4 rad at
    the optimum, where fp32 rounds a residual's trace to 3 and JAX's step
    guard would freeze the solve at a step that depends on the last bits."""
    from tpu3dm_torch.core import se3

    gen = torch.Generator().manual_seed(seed)
    truth = se3.exp_se3(torch.randn((n, 6), generator=gen) * 0.4)
    truth[0] = torch.eye(4)
    edges = [(i, (i + k) % n) for k in (1, 2) for i in range(n)]
    ii, jj = (torch.tensor([e[k] for e in edges]) for k in (0, 1))
    T = se3.inverse(truth[jj]) @ truth[ii] @ se3.exp_se3(
        torch.randn((len(edges), 6), generator=gen) * 0.03)
    w = 0.5 + 0.5 * torch.rand(len(edges), generator=gen)
    return T, edges, w, truth


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 256])
@pytest.mark.parametrize("robust", [None, 0.1])
def test_pose_graph_is_bit_equal_call_to_call(cuda_device, n, robust):
    """The pose-graph solve on the card (dense below 65 nodes, edgewise at
    256: its blocks summed in a fixed order, not by index_add_) gives the
    same bits in two calls, and lies near the CPU's solve of the same graph
    (both fp32; the solves round differently): within 1e-3 in every pose
    entry at 16 nodes, within 0.05 at 256, where the ring's weakest modes
    (the Hessian's condition ~1e5) carry the rounding and the robust
    weights, refitted every step, compound it."""
    from tpu3dm_torch.multiway.posegraph import _solve_pose_graph

    T, edges, w, _ = _noisy_graph(n, seed=n)
    kw = dict(n_nodes=n, iterations=20, robust_delta=robust)
    a = _solve_pose_graph(T.to(cuda_device), edges, w.to(cuda_device), **kw)
    b = _solve_pose_graph(T.to(cuda_device), edges, w.to(cuda_device), **kw)
    assert torch.equal(a, b), float((a - b).abs().max())
    assert torch.isfinite(a).all()
    cpu = _solve_pose_graph(T, edges, w, **kw)
    gap = float((a.cpu() - cpu).abs().max())
    assert gap < (1e-3 if n < 65 else 0.05), gap


@pytest.mark.gpu
def test_crash_suite_passes_on_the_card(cuda_device):
    """Every crash case on CUDA, and kernel 3's fp32 route against its plain
    version on every chunk the RANSAC cases score (64 rows none valid, 300
    rows, 50 rows near 1000): both counts inside the float64 bracket of
    FP32_CHAIN_REL, all 0 without a valid row.  (Near 1000 the products
    reach ~1e6 against a threshold of 1, so fp32's chains legitimately
    differ by several counts there; both stay inside the bracket.)"""
    from tpu3dm_torch.apps import crashtest
    from tpu3dm_torch.registration import hypotheses

    reset_launch_counts()
    results = crashtest.run_all_crash_tests(device=cuda_device)
    assert all(r.passed for r in results), [(r.name, r.detail) for r in results]
    assert KERNELS["ransac_score"].launches > 0
    captured = []
    real = hypotheses.score_features

    def capture(*args):
        captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    hypotheses.score_features = capture
    try:
        crashtest.test_zero_correspondences(cuda_device)
        crashtest.test_noise_ratio_sweep(cuda_device)
        crashtest.test_degenerate_huge_transform(cuda_device)
    finally:
        hypotheses.score_features = real
    assert {a[2].shape[1] for a in captured} >= {64, 300, 50}
    for H, e, F, c, v, thr in captured:
        assert H.dtype == torch.float32
        ck = ransac_score.score_features(H, e, F, c, v, thr)
        cp = ransac_score.score_features_plain(H, e, F, c, v, thr)
        sure, near = ransac_score.score_count_bracket(H, e, F, c, v, thr,
                                                      ransac_score.FP32_CHAIN_REL)
        for x in (ck, cp):
            assert ((x >= sure) & (x <= sure + near)).all()
        if not v.any():
            assert not ck.any()
