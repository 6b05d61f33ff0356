"""Port parity for the ``nn_impl`` routes of the fused step (CPU, small
shapes): the batched mutual search with a bf16 feature cross and with a
bf16-stored cross, the f16 ICP payload, and ``fused_register_step`` on each
row of ``NN_ROUTES`` against the JAX step vmapped over keys.

JAX's bits are rebuilt as in tests/test_torch_rescue.py and handed to the
port, so both packages draw the same triples.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.nn import (
    nn_mutual_mask,
    nn_mutual_mask_fold,
    nn_mutual_vals,
    pack_f16_pairs,
    unpack_f16_pairs,
)
from tpu3dm.preprocess.pipeline import preprocess_points
from tpu3dm.registration import fused as jfused
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.ops.nn_lane import nn_mutual_mask_batched
from tpu3dm_torch.registration import fused as pfused
from tpu3dm_torch.registration.hypotheses import sample_row_count

CFG = PipelineConfig.with_voxel_size(0.3)
K = 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _features(kind, rng, b, n):
    """Integer-grid features (every bf16 product and fp32 sum exact) or
    FPFH-like random ones."""
    if kind == "grid":
        return rng.integers(0, 5, (b, n, 33)).astype(np.float32)
    return (rng.random((b, n, 33)) ** 2 * 120).astype(np.float32)


def _mutual_inputs(kind, seed=0, b=3, na=300, nb=280):
    rng = np.random.default_rng(seed)
    a, bb = _features(kind, rng, b, na), _features(kind, rng, b, nb)
    ma, mb = rng.random((b, na)) > 0.2, rng.random((b, nb)) > 0.2
    mb[-1] = False  # a lane without a valid target
    return a, bb, ma, mb


def _check_picks(kind, idx_j, mut_j, idx_p, mut_p, ma):
    """Exact on the integer grid; >= 99.9% of valid rows' picks and of all
    masks equal on random features (fp32 sums in another order)."""
    picks = (idx_p == idx_j)[ma].mean()
    masks = (mut_p == mut_j).mean()
    if kind == "grid":
        assert picks == 1.0 and masks == 1.0
    else:
        assert picks >= 0.999 and masks >= 0.999
    assert not mut_p[~ma].any()


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("kind", ["grid", "random"])
def test_nn_mutual_mask_batched_matches_jax(kind, approx):
    """The min-only mutual search (values_pk, values, dense, ...) against
    JAX's ``nn_mutual_mask(approx=)``, vmapped over lanes."""
    a, b, ma, mb = _mutual_inputs(kind)
    ij, mj = jax.vmap(lambda *x: nn_mutual_mask(*x, approx=approx))(a, b, ma, mb)
    ip, mp = nn_mutual_mask_batched(*(torch.from_numpy(x) for x in (a, b, ma, mb)), approx=approx)
    _check_picks(kind, np.asarray(ij), np.asarray(mj), ip.numpy(), mp.numpy(), ma)


def _route_search(nn_impl, a, b, ma, mb, approx):
    """The port's mutual correspondences on ``nn_impl``'s route, each target
    point carrying its own index: (idx [B, Na], valid [B, Na]) numpy."""
    ids = np.broadcast_to(np.arange(b.shape[1], dtype=np.float32)[None, :, None],
                          b.shape[:2] + (3,)).copy()
    q, valid = pfused.correspondences(*(torch.from_numpy(x) for x in (a, b, ma, mb, ids)),
                                      approx=approx, route=pfused.nn_route(nn_impl))
    return q[..., 0].numpy().astype(np.int32), valid.numpy()


def _jax_route_search(nn_impl, a, b, ma, mb, approx):
    """JAX's mutual search of ``nn_impl`` (tpu3dm/registration/fused.py's
    branches), vmapped over lanes: (idx, mutual) numpy."""
    ids = np.broadcast_to(np.arange(b.shape[1], dtype=np.float32)[None, :, None],
                          b.shape[:2] + (1,)).copy()

    def vals(**kw):
        rows, mut = jax.vmap(lambda a_, b_, v_, c_, d_: nn_mutual_vals(
            a_, b_, v_, c_, d_, approx=approx, **kw))(a, b, ids, ma, mb)
        return np.asarray(rows)[..., 0].astype(np.int32), np.asarray(mut)

    if nn_impl == "values_b16":
        return vals(chunk=0, cross_dtype=jnp.bfloat16)
    if nn_impl in ("values", "values_corr"):
        return vals()
    fn = nn_mutual_mask_fold if nn_impl == "values_fold" else nn_mutual_mask
    idx, mut = jax.vmap(lambda *x: fn(*x, approx=approx))(a, b, ma, mb)
    return np.asarray(idx), np.asarray(mut)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("kind", ["grid", "random"])
def test_nn_mutual_mask_bf16_cross_matches_jax(kind, approx):
    """values_b16's search (kernel 2's bf16-cross route and the fold's rule
    for a lane without a valid target) against JAX's
    ``nn_mutual_vals(cross_dtype=bf16, chunk=0)``: the payload is each
    target's index, so the fold's pick is compared with the port's."""
    a, b, ma, mb = _mutual_inputs(kind, seed=1)
    idx_j, mut_j = _jax_route_search("values_b16", a, b, ma, mb, approx)
    idx_p, mut_p = _route_search("values_b16", a, b, ma, mb, approx)
    _check_picks(kind, idx_j, mut_j, idx_p, mut_p, ma)


@pytest.mark.parametrize("kind", ["grid", "random"])
@pytest.mark.parametrize("nn_impl", ["values", "values_corr", "values_fold", "values_pk",
                                     "dense"])
def test_route_mutual_search_matches_jax(nn_impl, kind):
    """Each route's mutual search against the JAX branch it ports, with a
    lane whose targets are all masked: the folds of values / values_corr
    (``nn_mutual_vals``, 256-target chunks) and values_fold
    (``nn_mutual_mask_fold``) give that lane no mutual row, the argmin test
    of values_pk / dense (``nn_mutual_mask``) passes its valid rows."""
    a, b, ma, mb = _mutual_inputs(kind, seed=3)
    idx_j, mut_j = _jax_route_search(nn_impl, a, b, ma, mb, True)
    idx_p, mut_p = _route_search(nn_impl, a, b, ma, mb, True)
    _check_picks(kind, idx_j, mut_j, idx_p, mut_p, ma)
    fold = pfused.nn_route(nn_impl).fold_mutual
    assert fold == (nn_impl != "values_pk" and nn_impl != "dense")
    assert mut_p[-1].any() != fold and mut_p[:-1].any()


def test_f16_payload_rows_match_pack_unpack():
    """The values_pk payload: bit-equal to JAX's unpack(pack(rows - shift))
    + shift, with f16 subnormals, values past 65504 (inf) and negative
    zeros among the rows."""
    rng = np.random.default_rng(2)
    rows = (rng.normal(size=(2, 64, 6)) * 40).astype(np.float32)
    special = np.float32([3e-8, -6e-6, 1e-4, 65504.0, 65519.0, 65520.0, 7e4, -1e5, -0.0, 0.0,
                          6.1e-5, 2.0**-24, 2.0**-25, 1.0 + 2.0**-11, 2049.0, 1e-30])
    rows[0, :16, 3] = special
    rows[1, :16, 0] = special + np.float32(64.0)
    center = np.float32([[0.0, 0.0, 0.0], [64.0, -128.0, 0.0]])
    shift = np.concatenate([center, np.zeros_like(center)], -1)[:, None, :]
    ref = np.stack([np.asarray(unpack_f16_pairs(pack_f16_pairs(jnp.asarray(rows[i] - shift[i]))))
                    for i in range(2)]) + shift
    got = pfused.f16_payload_rows(torch.from_numpy(rows), torch.from_numpy(center)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.astype(np.float32).view(np.int32))
    assert np.isinf(got).any() and (got[0, :16, 3] != special).any()


@pytest.fixture(scope="module")
def arch_pair():
    """The bench's arch pair (20k points, seed 0), preprocessed by JAX, plus
    the same clouds carried across to the port."""
    sp, tp, T_true = make_benchmark_pair(20000, seed=0, sigma=0.01)
    src = preprocess_points(sp, CFG.preprocess).down
    tgt = preprocess_points(tp, CFG.preprocess).down

    def arrays(pc):
        return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}

    return (src, tgt, from_reference_arrays(arrays(src), device="cpu"),
            from_reference_arrays(arrays(tgt), device="cpu"), sp, T_true)


def _chunk_bits(key, m_s, n_chunks=1):
    return np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                     for kc in jax.random.split(key, n_chunks)]).astype(np.int64)


def _bits(keys, m_s, restarts):
    if not restarts:
        return torch.from_numpy(np.stack([_chunk_bits(k, m_s) for k in keys]))
    return torch.from_numpy(np.stack([
        np.stack([_chunk_bits(kr, m_s) for kr in jax.random.split(k, restarts)]) for k in keys]))


def _rot_apart_deg(Ta, Tb):
    fro = np.linalg.norm(Ta[..., :3, :3].astype(np.float64) - Tb[..., :3, :3], axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


def _gate(T, T_true, src_pts):
    """bench.py's per-lane gate: rotation error and closed-form alignment RMSE."""
    M = T[:, :3, :3] @ T_true[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(M, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    mu, M2 = src_pts.mean(0), src_pts.T @ src_pts / src_pts.shape[0]
    A = T[:, :3, :3] - T_true[:3, :3]
    b = T[:, :3, 3] - T_true[:3, 3]
    rmse2 = (np.einsum("bij,jk,bik->b", A, M2, A) + 2 * np.einsum("bi,bij,j->b", b, A, mu)
             + (b * b).sum(1))
    return rot, np.sqrt(np.maximum(rmse2, 0))


def _run_both(arch_pair, keys, *, jax_opts=None, **opts):
    """The JAX fused step vmapped over keys and the port with the same bits."""
    sd, td, pcs, pct, _, _ = arch_pair
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, icp_thresh=CFG.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=4, icp_solves_per_nn=4,
              approx_score=True, **opts)
    outj = jax.vmap(lambda k: jfused.fused_register_step(
        sd.points, sd.features, sd.mask, sd.normals, td.points, td.features, td.mask,
        td.normals, k, **{**kw, **(jax_opts or {})}))(keys)
    bits = _bits(keys, sample_row_count(sd.capacity, K, opts.get("sample_rows", 0)),
                 opts.get("rescue_restarts", 0))

    def rep(x):
        return x[None].expand(len(keys), *x.shape)

    outp = pfused.fused_register_step(
        rep(pcs.points), rep(pcs.features), rep(pcs.mask), rep(pcs.normals),
        rep(pct.points), rep(pct.features), rep(pct.mask), rep(pct.normals),
        bits, device="cpu", **kw)
    return [np.asarray(x) for x in outj], [x.numpy() for x in outp]


def _assert_parity(arch_pair, outj, outp):
    """Rotation within 0.05 deg and translation within 5e-3 of JAX's, the
    RANSAC fitness within 1e-6, the ICP rmse within 1e-4, and both inside
    the bench gate (2 deg, RMSE 0.1) against T_true."""
    (Tj, fj, rj), (Tp, fp, rp) = outj, outp
    _, _, _, _, sp, T_true = arch_pair
    assert _rot_apart_deg(Tp, Tj).max() < 0.05
    assert np.abs(Tp[:, :3, 3] - Tj[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(fp, fj, atol=1e-6)
    np.testing.assert_allclose(rp, rj, atol=1e-4)
    for T in (Tj, Tp):
        rot, rmse = _gate(T.astype(np.float64), T_true, sp)
        assert rot.max() < 2.0 and rmse.max() < 0.1


# (nn_impl, mutual_filter, approx_features): every row of NN_ROUTES, the
# default route with and without each switch, and two of JAX's other names.
ROUTE_CASES = [
    ("values_pk", True, True),
    ("values_pk", True, False),
    ("values_pk", False, True),
    ("values_b16", True, True),
    ("values_b16", True, False),
    ("values", True, True),
    ("dense", False, False),
    ("lane", True, False),
]


@pytest.mark.parametrize("nn_impl,mutual,approx", ROUTE_CASES)
def test_fused_register_step_route_matches_jax(arch_pair, nn_impl, mutual, approx):
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    outj, outp = _run_both(arch_pair, keys, nn_impl=nn_impl, mutual_filter=mutual,
                           approx_features=approx)
    _assert_parity(arch_pair, outj, outp)


def test_fused_register_step_rescue_values_pk_matches_jax(arch_pair):
    """The rescue on the default route: 2 restarts x 6 modes, each candidate
    verified with the f16 payload."""
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    outj, outp = _run_both(arch_pair, keys, nn_impl="values_pk", approx_features=True,
                           rescue_restarts=2, rescue_modes=6, verify_iters=8)
    _assert_parity(arch_pair, outj, outp)


@pytest.mark.parametrize("sample_rows,restarts", [(-1, 0), (300, 0), (-1, 2)])
def test_fused_register_step_sample_rows_matches_jax(arch_pair, sample_rows, restarts):
    """sample_rows through the default route's step and its rescue: the roll
    sampler over every valid row (-1) or 300 rows, as JAX passes it to
    ``ransac_pair_step``."""
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    outj, outp = _run_both(arch_pair, keys, approx_features=True, sample_rows=sample_rows,
                           rescue_restarts=restarts)
    _assert_parity(arch_pair, outj, outp)


def test_default_route_is_values_pk(arch_pair):
    """The port's default nn_impl is JAX's, and the lane route ignores
    approx_features (its TPU kernel is fp32; JAX's CPU stand-in for it is
    not, so the lane row above runs approx_features=False)."""
    for fn in (pfused.fused_register_step, jfused.fused_register_step):
        assert inspect.signature(fn).parameters["nn_impl"].default == "values_pk"
    _, _, pcs, pct, _, _ = arch_pair
    args = [x[None] for c in (pcs, pct) for x in (c.points, c.features, c.mask, c.normals)]
    bits = torch.from_numpy(_chunk_bits(jax.random.PRNGKey(0), sample_row_count(pcs.capacity, K)))
    kw = dict(ransac_iterations=K, ransac_batch=K, approx_score=True, device="cpu")
    out = [pfused.fused_register_step(*args, bits[None], approx_features=a, nn_impl="lane", **kw)
           for a in (False, True)]
    assert all(torch.equal(x, y) for x, y in zip(*out))
    T0 = pfused.fused_register_step(*args, bits[None], approx_features=True, **kw)[0]
    T1 = pfused.fused_register_step(*args, bits[None], approx_features=True, nn_impl="values_pk",
                                    **kw)[0]
    assert torch.equal(T0, T1)
