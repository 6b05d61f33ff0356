"""Port parity for the kernel modules of tpu3dm_torch (CPU, small shapes).

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/test_ops.py runs them) and through the port's
wrapper, which on CPU tensors runs its plain PyTorch version.  The CUDA
kernels themselves are held against those plain versions in
tests/test_torch_kernels.py (``gpu`` tests, which skip without a card) and
by chip_smoke.py at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.ops import nn as jnn
from tpu3dm.ops import nn_lane as jlane
from tpu3dm.ops import ransac_score as jscore
from tpu3dm.registration import hypotheses as jhyp
from tpu3dm_torch.ops import nn_lane, ransac_score
from tpu3dm_torch.registration import hypotheses as phyp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # The suite runs under several xdist workers; one intra-op thread each.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Kernel 1: 3-D NN per lane (tolerance: idx exact; d2 1e-4 absolute, the
# lane kernels' own test bound — both sides compute the direct sum of squares)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nt", [(256, 256), (200, 300), (37, 129)])
def test_nn_search_lane_matches_jax(nq, nt):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(nq, 3)).astype(np.float32)
    t = rng.normal(size=(nt, 3)).astype(np.float32)
    tmask = rng.random(nt) > 0.2
    d2l, idxl = jlane.nn_search_lane(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tmask),
                                     interpret=True)
    d2d, idxd = jnn.nn_search_dense(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tmask))
    d2p, idxp = nn_lane.nn_search_lane(_t(q)[None], _t(t)[None], None, _t(tmask)[None])
    assert idxp.dtype == torch.int32 and d2p.dtype == torch.float32
    np.testing.assert_array_equal(idxp[0].numpy(), np.asarray(idxl))
    np.testing.assert_array_equal(idxp[0].numpy(), np.asarray(idxd))
    np.testing.assert_allclose(d2p[0].numpy(), np.asarray(d2l), atol=1e-4)
    np.testing.assert_allclose(d2p[0].numpy(), np.asarray(d2d), atol=1e-4)


def test_nn_search_lane_batched_matches_jax_vmap():
    rng = np.random.default_rng(5)
    B, m, n = 3, 128, 200
    q = rng.normal(size=(B, m, 3)).astype(np.float32)
    t = rng.normal(size=(B, n, 3)).astype(np.float32)
    tm = rng.random((B, n)) > 0.2
    d2l, idxl = jax.vmap(lambda a, b, c: jlane.nn_search_lane(a, b, None, c, interpret=True))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm)
    )
    d2p, idxp = nn_lane.nn_search_lane(_t(q), _t(t), None, _t(tm))
    np.testing.assert_array_equal(idxp.numpy(), np.asarray(idxl))
    np.testing.assert_allclose(d2p.numpy(), np.asarray(d2l), atol=1e-4)


def test_nn_search_lane_candidate_rows_match_copied_targets_and_jax():
    """The rescue's verification searches C candidate moves of a lane's source
    against that lane's one target as C * M query rows ([B, C * M, 3] against
    [B, N, 3]).  Bit-equal to the same search on C copies of the targets, and
    to JAX's search vmapped over lanes and candidates (d2 within 1e-4, as above)."""
    rng = np.random.default_rng(6)
    B, C, M, N = 2, 3, 70, 150
    q = rng.normal(size=(B, C, M, 3)).astype(np.float32)
    t = rng.normal(size=(B, N, 3)).astype(np.float32)
    tm = rng.random((B, N)) > 0.2
    d2g, idxg = nn_lane.nn_search_lane(_t(q).reshape(B, C * M, 3), _t(t), None, _t(tm))
    d2c, idxc = nn_lane.nn_search_lane(_t(q).reshape(B * C, M, 3), _t(t).repeat_interleave(C, 0),
                                       None, _t(tm).repeat_interleave(C, 0))
    assert torch.equal(idxg.reshape(B * C, M), idxc) and torch.equal(d2g.reshape(B * C, M), d2c)
    one = lambda a, b, c: jlane.nn_search_lane(a, b, None, c, interpret=True)  # noqa: E731
    d2l, idxl = jax.vmap(jax.vmap(one, in_axes=(0, None, None)))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm)
    )
    np.testing.assert_array_equal(idxg.reshape(B, C, M).numpy(), np.asarray(idxl))
    np.testing.assert_allclose(d2g.reshape(B, C, M).numpy(), np.asarray(d2l), atol=1e-4)


def test_nn_search_lane_ties_go_to_smaller_index():
    t = np.array([[0, 0, 1], [0, 0, -1], [0, 0, 1], [5, 5, 5]], np.float32)
    q = np.zeros((2, 3), np.float32)
    d2, idx = nn_lane.nn_search_lane(_t(q)[None], _t(t)[None])
    np.testing.assert_array_equal(idx[0].numpy(), [0, 0])
    np.testing.assert_allclose(d2[0].numpy(), [1.0, 1.0])


# ---------------------------------------------------------------------------
# Kernel 7: 33-D NN per lane (the TPU's _lane_nn_mxu_kernel).  Tolerance:
# idx exact on random features (no two targets within rounding of each
# other); d2 within 2e-5 absolute: |t|^2 - 2 q.t + |q|^2 at |q|^2 ~ 33 with
# the dot summed in another order (XLA's, torch's), as in
# tests/test_torch_nn_tiled.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nt", [(256, 256), (200, 300), (37, 129)])
def test_nn_search_lane_wide_matches_jax(nq, nt):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(nq, 33)).astype(np.float32)
    t = rng.normal(size=(nt, 33)).astype(np.float32)
    tmask = rng.random(nt) > 0.2
    d2l, idxl = jlane.nn_search_lane(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tmask),
                                     interpret=True)
    d2d, idxd = jnn.nn_search_dense(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tmask))
    d2p, idxp = nn_lane.nn_search_lane(_t(q)[None], _t(t)[None], None, _t(tmask)[None])
    assert idxp.dtype == torch.int32 and d2p.dtype == torch.float32
    np.testing.assert_array_equal(idxp[0].numpy(), np.asarray(idxl))
    np.testing.assert_array_equal(idxp[0].numpy(), np.asarray(idxd))
    np.testing.assert_allclose(d2p[0].numpy(), np.asarray(d2l), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d2p[0].numpy(), np.asarray(d2d), rtol=0, atol=2e-5)
    assert tmask[idxp[0].numpy()].all()


def test_nn_search_lane_wide_batched_matches_jax_vmap():
    """Lanes of their own masks, one lane with a single valid target, shapes
    that are multiples of neither 8 nor the TPU's 256-wide target tile."""
    rng = np.random.default_rng(9)
    B, m, n = 4, 123, 301
    q = (rng.random((B, m, 33)) * 50).astype(np.float32)
    t = (rng.random((B, n, 33)) * 50).astype(np.float32)
    tm = rng.random((B, n)) > 0.3
    tm[2] = False
    tm[2, 77] = True
    d2l, idxl = jax.vmap(lambda a, b, c: jlane.nn_search_lane(a, b, None, c, interpret=True))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm)
    )
    d2p, idxp = nn_lane.nn_search_lane(_t(q), _t(t), None, _t(tm))
    np.testing.assert_array_equal(idxp.numpy(), np.asarray(idxl))
    assert (idxp[2] == 77).all()
    # |q|^2 ~ 2e4 here: 2e-5 relative to the row's |q|^2 + |t|^2.
    scale = (q * q).sum(-1) + (t * t).sum(-1).max(-1, keepdims=True)
    assert (np.abs(d2p.numpy() - np.asarray(d2l)) <= 2e-5 * scale).all()


# ---------------------------------------------------------------------------
# Kernel 2: mutual 33-D NN per lane (idx and mutual exact on random features:
# a tie within an ulp has probability ~0 at these sizes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("na,nb", [(384, 512), (100, 70)])
def test_nn_mutual_mask_lane_matches_jax(na, nb):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(na, 33)).astype(np.float32)
    b = rng.normal(size=(nb, 33)).astype(np.float32)
    ma = rng.random(na) > 0.1
    mb = rng.random(nb) > 0.1
    idxl, mutl = jlane.nn_mutual_mask_lane(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma),
                                           jnp.asarray(mb), interpret=True)
    idxp, mutp = nn_lane.nn_mutual_mask_lane(_t(a)[None], _t(b)[None], _t(ma)[None], _t(mb)[None])
    np.testing.assert_array_equal(idxp[0].numpy(), np.asarray(idxl))
    np.testing.assert_array_equal(mutp[0].numpy(), np.asarray(mutl))
    assert mutp[0].sum() > 0


def test_nn_mutual_mask_lane_batched_matches_jax_vmap():
    rng = np.random.default_rng(5)
    B, m, n = 3, 128, 256
    f = rng.normal(size=(B, m, 33)).astype(np.float32)
    g = rng.normal(size=(B, n, 33)).astype(np.float32)
    fm = rng.random((B, m)) > 0.1
    gm = rng.random((B, n)) > 0.1
    idxl, mutl = jax.vmap(
        lambda a, b, c, d: jlane.nn_mutual_mask_lane(a, b, c, d, interpret=True)
    )(jnp.asarray(f), jnp.asarray(g), jnp.asarray(fm), jnp.asarray(gm))
    idxp, mutp = nn_lane.nn_mutual_mask_lane(_t(f), _t(g), _t(fm), _t(gm))
    np.testing.assert_array_equal(idxp.numpy(), np.asarray(idxl))
    np.testing.assert_array_equal(mutp.numpy(), np.asarray(mutl))


def test_nn_mutual_mask_lane_approx_is_fp32():
    """``approx`` is accepted and ignored, as by the TPU kernel: the result is
    the exact fp32 one."""
    rng = np.random.default_rng(6)
    a = (np.abs(rng.normal(size=(1, 200, 33))) * 50).astype(np.float32)
    b = (np.abs(rng.normal(size=(1, 180, 33))) * 50).astype(np.float32)
    idx0, mut0 = nn_lane.nn_mutual_mask_lane(_t(a), _t(b))
    idx1, mut1 = nn_lane.nn_mutual_mask_lane(_t(a), _t(b), approx=True)
    idxj, mutj = jnn.nn_mutual_mask(jnp.asarray(a[0]), jnp.asarray(b[0]), approx=False)
    np.testing.assert_array_equal(idx1.numpy(), idx0.numpy())
    np.testing.assert_array_equal(mut1.numpy(), mut0.numpy())
    np.testing.assert_array_equal(idx1[0].numpy(), np.asarray(idxj))
    np.testing.assert_array_equal(mut1[0].numpy(), np.asarray(mutj))


# ---------------------------------------------------------------------------
# Kernels 2 and 7 on an integer grid: the tie semantics the card tests rely
# on (tests/test_torch_kernels.py holds the kernels to these plain versions
# exactly on such inputs).  Small integer features make every fp32 sum exact
# in any order, so the tolerance is exact: first index on ties, every tying
# row mutual, and a lane with no valid target decided by the BIG-biased
# entries (idx 0, d2 = BIG), in JAX's Pallas kernels as in the plain versions.
# ---------------------------------------------------------------------------


def _fpfh_grid(rng, B, na, nb):
    a = rng.integers(0, 4, size=(B, na, 33)).astype(np.float32)
    b = rng.integers(0, 4, size=(B, nb, 33)).astype(np.float32)
    ma = rng.random((B, na)) > 0.3
    mb = rng.random((B, nb)) > 0.3
    b[:, nb - 1] = b[:, 2]  # twin targets far apart, both valid
    mb[:, [2, nb - 1]] = True
    a[:, 0] = b[:, 2]       # two query rows at distance 0 from both twins
    a[:, na - 1] = b[:, 2]
    ma[:, [0, na - 1]] = True
    mb[1] = False           # lane 1: no valid target
    ma[2] = False           # lane 2: no valid query
    return a, b, ma, mb


@pytest.mark.parametrize("B,na,nb", [(3, 130, 270), (4, 300, 90)])
def test_nn_mutual_lane_plain_integer_grid_matches_jax(B, na, nb):
    a, b, ma, mb = _fpfh_grid(np.random.default_rng(30 + na), B, na, nb)
    idxl, mutl = jax.vmap(
        lambda x, y, u, v: jlane.nn_mutual_mask_lane(x, y, u, v, interpret=True)
    )(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb))
    idxp, mutp = nn_lane.nn_mutual_lane_plain(_t(a), _t(b), _t(ma), _t(mb))
    # idx of a masked row is unspecified; mutual is exact on every row.
    np.testing.assert_array_equal(idxp.numpy()[ma], np.asarray(idxl)[ma])
    np.testing.assert_array_equal(mutp.numpy(), np.asarray(mutl))
    full = [0] + list(range(3, B))  # lanes with valid rows on both sides
    assert (idxp[full, 0] == 2).all() and (idxp[full, na - 1] == 2).all()
    assert mutp[full][:, [0, na - 1]].all()
    assert (idxp[1][_t(ma[1])] == 0).all() and mutp[1].equal(_t(ma[1]))
    assert not mutp[2].any()


@pytest.mark.parametrize("B,nq,nt", [(3, 130, 270), (4, 300, 90)])
def test_nn_search_lane_plain_wide_integer_grid_matches_jax_vmap(B, nq, nt):
    q, t, qm, tm = _fpfh_grid(np.random.default_rng(40 + nq), B, nq, nt)
    d2l, idxl = jax.vmap(lambda x, y, v: jlane.nn_search_lane(x, y, None, v, interpret=True))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm)
    )
    d2p, idxp = nn_lane.nn_search_lane_plain(_t(q), _t(t), _t(qm), _t(tm))
    np.testing.assert_array_equal(idxp.numpy(), np.asarray(idxl))
    np.testing.assert_array_equal(d2p.numpy(), np.asarray(d2l))
    full = [0, 2] + list(range(3, B))  # lanes with a valid target
    assert (idxp[full, 0] == 2).all() and (d2p[full, 0] == 0).all()
    assert (idxp[1] == 0).all() and (d2p[1] == 1e30).all()


# ---------------------------------------------------------------------------
# Kernel 3: RANSAC score (counts exact on tie-free fp32 inputs)
# ---------------------------------------------------------------------------


def _random_hypotheses(rng, k, n):
    from tpu3dm.core.se3 import exp_so3

    w = rng.normal(size=(k, 3)).astype(np.float32) * 0.3
    R = np.asarray(exp_so3(jnp.asarray(w)))
    t = (rng.normal(size=(k, 3)) * 0.2).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    q = (p + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    mask = rng.random(n) > 0.15
    return R, t, p, q, mask


@pytest.mark.parametrize("k,n", [(256, 384), (300, 257)])
def test_score_matches_jax_pallas_and_xla(k, n):
    rng = np.random.default_rng(7)
    R, t, p, q, mask = _random_hypotheses(rng, k, n)
    thr = float(np.float32(0.6) ** 2)
    args = tuple(jnp.asarray(x) for x in (R, t, p, q, mask))
    c_pl = jscore.score_hypotheses_pallas(*args, thr, tile_k=128, tile_n=128, interpret=True)
    c_x = jscore.score_hypotheses_xla(*args, thr)
    F, c = ransac_score.corres_features(_t(p)[None], _t(q)[None])
    H, e = ransac_score.hypothesis_features(_t(R)[None], _t(t)[None])
    counts = ransac_score.score_features(H, e, F, c, _t(mask)[None], thr)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(c_pl))
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(c_x))
    dense = ransac_score.score_hypotheses_dense(_t(R), _t(t), _t(p), _t(q), _t(mask), thr)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(c_x))
    assert 0 < counts.min() and counts.max() < mask.sum()


def _bf16_scoring_inputs(k=300, n=257, seed=11):
    rng = np.random.default_rng(seed)
    R, t, p, q, mask = _random_hypotheses(rng, k, n)
    F, c = ransac_score.corres_features(_t(p)[None], _t(q)[None])
    H, e = ransac_score.hypothesis_features(_t(R)[None], _t(t)[None])
    return H.to(torch.bfloat16), e, F.to(torch.bfloat16), c, _t(mask)[None]


def test_score_features_bf16_equals_fp32_on_the_same_values():
    """The bf16 route's plain version upcasts: bit-equal counts to the fp32
    call on the same (bf16-representable) values, inside the bf16 kernel's
    float64 bracket."""
    H, e, F, c, m = _bf16_scoring_inputs()
    thr = float(np.float32(0.6) ** 2)
    cb = ransac_score.score_features(H, e, F, c, m, thr)
    cf = ransac_score.score_features(H.float(), e, F.float(), c, m, thr)
    assert cb.dtype == torch.int32
    assert torch.equal(cb, cf)
    sure, near = ransac_score.score_count_bracket(H, e, F, c, m, thr, ransac_score.BF16_MMA_REL)
    assert ((cb >= sure) & (cb <= sure + near)).all()
    assert 0 < cb.max() < m.sum()


@pytest.mark.parametrize("h_dtype,f_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.float16, torch.float16)])
def test_score_features_rejects_mixed_or_other_dtypes(h_dtype, f_dtype):
    with pytest.raises(TypeError):
        ransac_score.score_features(torch.zeros(1, 4, 16, dtype=h_dtype), torch.zeros(1, 4),
                                    torch.zeros(1, 8, 16, dtype=f_dtype), torch.zeros(1, 8),
                                    torch.ones(1, 8, dtype=torch.bool), 1.0)


@pytest.mark.parametrize("rel", [ransac_score.FP32_CHAIN_REL, ransac_score.BF16_MMA_REL],
                         ids=["fp32_chain", "bf16_mma"])
def test_score_count_bracket_holds_jax_counts(rel):
    """The float64 bracket holds the JAX XLA score's counts on the same fp32
    inputs (a NaN hypothesis row counts nothing, and is in neither set);
    near entries are rare."""
    rng = np.random.default_rng(13)
    R, t, p, q, mask = _random_hypotheses(rng, 256, 384)
    R = R.copy()
    R[3] = np.nan
    thr = float(np.float32(0.6) ** 2)
    c_x = np.asarray(jscore.score_hypotheses_xla(*(jnp.asarray(x) for x in (R, t, p, q, mask)),
                                                 thr))
    F, c = ransac_score.corres_features(_t(p)[None], _t(q)[None])
    H, e = ransac_score.hypothesis_features(_t(R)[None], _t(t)[None])
    sure, near = ransac_score.score_count_bracket(H, e, F, c, _t(mask)[None], thr, rel)
    assert ((c_x >= sure[0].numpy()) & (c_x <= (sure + near)[0].numpy())).all()
    assert sure[0, 3] == 0 and near[0, 3] == 0 and c_x[3] == 0
    assert near.sum() <= 2


@pytest.mark.parametrize("valid", ["random_third", "prefix_third"])
def test_score_fp32_one_lane_matches_jax_pallas(valid):
    """The fp32 route at the large path's one-lane shape, cut to K 512 and
    N 2048 with about a third of the rows valid (scattered, or the valid
    prefix that ransac_two_mode's compaction leaves): the port's counts and
    the TPU kernel's in interpret mode both lie inside the float64 bracket
    of FP32_CHAIN_REL, are equal on >= 99.9% of hypotheses and never more
    than 1 apart (the two sum the dot in different orders)."""
    rng = np.random.default_rng({"random_third": 14, "prefix_third": 15}[valid])
    R, t, p, q, _ = _random_hypotheses(rng, 512, 2048)
    mask = rng.random(2048) < 1 / 3 if valid == "random_third" else np.arange(2048) < 690
    thr = float(np.float32(0.6) ** 2)
    c_pl = np.asarray(jscore.score_hypotheses_pallas(
        *(jnp.asarray(x) for x in (R, t, p, q, mask)), thr, tile_k=256, tile_n=1024,
        interpret=True))
    F, c = ransac_score.corres_features(_t(p)[None], _t(q)[None])
    H, e = ransac_score.hypothesis_features(_t(R)[None], _t(t)[None])
    counts = ransac_score.score_features(H, e, F, c, _t(mask)[None], thr)[0].numpy()
    sure, near = (x[0].numpy() for x in ransac_score.score_count_bracket(
        H, e, F, c, _t(mask)[None], thr, ransac_score.FP32_CHAIN_REL))
    for x in (counts, c_pl):
        assert ((x >= sure) & (x <= sure + near)).all()
    diff = np.abs(counts.astype(np.int64) - c_pl)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert 0 < counts.max() <= mask.sum()


def _arch_correspondences(n=512, seed=0):
    """Correspondences of a moved arch with 40% outliers, centred."""
    from tpu3dm_torch.io.synthetic import dental_arch_cloud

    rng = np.random.default_rng(seed)
    p = dental_arch_cloud(n, seed=seed).astype(np.float32)
    p -= p.mean(0)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    q = p @ R.T + np.float32([0.3, -0.2, 0.1])
    out = rng.random(n) < 0.4
    q[out] = rng.normal(size=(out.sum(), 3)).astype(np.float32) * 2
    q += rng.normal(size=q.shape).astype(np.float32) * 0.01
    return p, q.astype(np.float32), rng.random(n) > 0.05


@pytest.mark.parametrize("approx", [False, True])
def test_fit_score_gathers_matches_jax(approx):
    """The whole hypothesis chunk, fp32 and with the bf16-rounded score
    (JAX: bf16-in, fp32-accumulate dot).  Counts may differ only where a
    distance sits within rounding of the threshold: at most 1 count, on at
    most 1% of hypotheses; the fits agree to 1e-5."""
    p, q, valid = _arch_correspondences()
    rng = np.random.default_rng(1)
    kk = 512
    tri = rng.integers(0, p.shape[0], size=(kk, 3))
    pq = np.concatenate([p, q], 1)
    ga, gb, gc = pq[tri[:, 0]], pq[tri[:, 1]], pq[tri[:, 2]]
    thr = float(np.float32(0.45) ** 2)
    Fj, cj = jscore.corres_features(jnp.asarray(p), jnp.asarray(q))
    Rj, tj, cnt_j = jhyp.fit_score_gathers(
        jnp.asarray(ga), jnp.asarray(gb), jnp.asarray(gc), Fj, cj, jnp.asarray(valid), thr,
        approx_score=approx,
    )
    F, c = ransac_score.corres_features(_t(p)[None], _t(q)[None])
    Rp, tp, cnt_p = phyp.fit_score_gathers(
        _t(ga)[None], _t(gb)[None], _t(gc)[None], F, c, _t(valid)[None], thr,
        approx_score=approx,
    )
    for i in range(3):
        np.testing.assert_allclose(tp[i][0].numpy(), np.asarray(tj[i]), atol=1e-5)
        for j in range(3):
            np.testing.assert_allclose(Rp[i][j][0].numpy(), np.asarray(Rj[i][j]), atol=1e-5)
    diff = np.abs(cnt_p[0].numpy().astype(np.int64) - np.asarray(cnt_j))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert (np.asarray(cnt_j) > 50).any()  # some all-inlier hypotheses exist
