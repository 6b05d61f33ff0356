"""Port parity for the options of ``ransac_pair_step`` (CPU, small shapes):
two-stage scoring, the gather sampler, the roll sampler's row count and the
adaptive budget, each against the JAX step vmapped over keys.

The port takes JAX's bits: ``jax.random.bits(k_i, (m_s,))`` (roll) or
``bits(k_i, (K, 2))`` (gather) for chunk i of ``split(key, n_chunks)``, and
for the j-th extra chunk of the adaptive budget the j-th subkey of the chain
k_0 = fold_in(key, 0x5F5E), (k_{j+1}, sub_j) = split(k_j).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.nn import nn_mutual_mask
from tpu3dm.parallel.multipair import ransac_pair_step as j_ransac
from tpu3dm.preprocess.pipeline import preprocess_points
from tpu3dm_torch.parallel import multipair
from tpu3dm_torch.parallel.multipair import (
    EXTRA_KEY_SALT,
    chunk_bits_shape,
    extra_chunk_count,
)
from tpu3dm_torch.parallel.multipair import ransac_pair_step as p_ransac

CFG = PipelineConfig.with_voxel_size(0.3)
K = 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_chunk_bits(key, n_chunks, shape):
    """[n_chunks, *shape]: the bits of chunk i, drawn from split(key, n_chunks)[i]."""
    return np.stack([np.asarray(jax.random.bits(kc, shape, jnp.uint32))
                     for kc in jax.random.split(key, n_chunks)]).astype(np.int64)


def jax_extra_bits(key, n_extra, shape):
    """[n_extra, *shape]: the adaptive budget's extra chunks (JAX's ``extend``)."""
    k, out = jax.random.fold_in(key, EXTRA_KEY_SALT), []
    for _ in range(n_extra):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.bits(sub, shape, jnp.uint32)))
    return np.stack(out).astype(np.int64)


def run_both(p_all, q_all, valid, keys, **kw):
    """The JAX step vmapped over (lanes, keys) and the port with JAX's bits.
    p_all, q_all [B, M, 3], valid [B, M] numpy; returns numpy (T, counts)
    of both."""
    Tj, cj = jax.vmap(lambda p, q, v, k: j_ransac(p, q, v, k, **kw))(p_all, q_all, valid, keys)
    m = p_all.shape[1]
    shape = chunk_bits_shape(m, kw["batch_size"], kw.get("sample_mode", "roll"),
                             kw.get("sample_rows", 0))
    n_chunks = max(1, kw["iterations"] // kw["batch_size"])
    bits = np.stack([jax_chunk_bits(k, n_chunks, shape) for k in keys])
    n_extra = extra_chunk_count(kw["iterations"], kw.get("adapt_iterations", 0), kw["batch_size"])
    extra = (torch.from_numpy(np.stack([jax_extra_bits(k, n_extra, shape) for k in keys]))
             if n_extra else None)
    Tp, cp = p_ransac(torch.from_numpy(p_all), torch.from_numpy(q_all), torch.from_numpy(valid),
                      torch.from_numpy(bits), extra_bits=extra, **kw)
    return (np.asarray(Tj), np.asarray(cj)), (Tp.numpy(), cp.numpy())


@pytest.fixture(scope="module")
def arch_corr():
    """The bench arch pair's mutual correspondences (JAX), tiled to 3 lanes."""
    sp, tp, _ = make_benchmark_pair(20000, seed=0, sigma=0.01)
    sd = preprocess_points(sp, CFG.preprocess).down
    td = preprocess_points(tp, CFG.preprocess).down
    idx, mutual = nn_mutual_mask(sd.features, td.features, sd.mask, td.mask)
    p, q, v = (np.asarray(x) for x in (sd.points, td.points[idx], sd.mask & mutual))
    return tuple(np.ascontiguousarray(np.broadcast_to(x, (3,) + x.shape)) for x in (p, q, v))


def low_support_lanes(n_inliers=(14, 22, 60), m=256, seed=0):
    """One synthetic lane per inlier count: m correspondences, n of them
    moved by a random rigid motion (noise 0.01), the rest random.  At ~0.06
    support the confidence test wants every extra chunk; at ~0.23 a few."""
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    for n in n_inliers:
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
        R = u @ vt
        R[2] *= np.sign(np.linalg.det(R))
        p = (rng.normal(size=(m, 3)) * 2).astype(np.float32)
        q = (rng.normal(size=(m, 3)) * 2).astype(np.float32)
        q[:n] = p[:n] @ R.T.astype(np.float32) + np.float32([0.3, -0.2, 0.5])
        q[:n] += (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
        perm = rng.permutation(m)
        ps.append(p[perm])
        qs.append(q[perm])
    valid = np.ones((len(n_inliers), m), bool)
    valid[:, -5:] = False
    return np.stack(ps), np.stack(qs), valid


def assert_same(outj, outp, atol=1e-4):
    (Tj, cj), (Tp, cp) = outj, outp
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_allclose(Tp, Tj, atol=atol)


@pytest.mark.parametrize("approx", [False, True])
def test_score_subset_matches_jax(arch_corr, approx):
    """Two-stage scoring: the subset score, the exact fp32 rescore of the top
    64 (the port's stable sort keeps lax.top_k's order among tied counts),
    the election on exact counts; two chunks."""
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    outj, outp = run_both(*arch_corr, keys, dist_thresh=CFG.ransac.dist_thresh,
                          iterations=2 * K, batch_size=K, approx_score=approx,
                          score_subset=200, rescore_top=64)
    assert_same(outj, outp)
    assert (outp[1] > 50).all()


@pytest.mark.parametrize("two_mode,n_modes,subset", [(False, 2, 0), (False, 2, 256),
                                                     (True, 2, 0), (True, 5, 0)])
def test_gather_sampler_matches_jax(arch_corr, two_mode, n_modes, subset):
    """sample_mode="gather": compacted correspondences, distinct triples from
    [K, 2] bits a chunk (per-lane n), single, two-mode and N-mode."""
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    outj, outp = run_both(*arch_corr, keys, dist_thresh=CFG.ransac.dist_thresh,
                          iterations=K, batch_size=K, approx_score=True, sample_mode="gather",
                          two_mode=two_mode, n_modes=n_modes, score_subset=subset)
    (Tj, cj), (Tp, cp) = outj, outp
    np.testing.assert_array_equal(cp, cj)
    strong = cj >= 50  # weak modes' Horn refits move with the summation order
    np.testing.assert_allclose(Tp[strong], Tj[strong], atol=1e-4)
    np.testing.assert_allclose(Tp, Tj, atol=1e-3)


@pytest.mark.parametrize("sample_rows", [-1, 300])
def test_sample_rows_matches_jax(arch_corr, sample_rows):
    """The roll sampler with every valid row (-1) and with 300 rows."""
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    outj, outp = run_both(*arch_corr, keys, dist_thresh=CFG.ransac.dist_thresh,
                          iterations=K, batch_size=K, approx_score=True, sample_rows=sample_rows)
    assert_same(outj, outp)


@pytest.mark.parametrize("two_mode,n_modes", [(False, 2), (True, 2), (True, 4)])
@pytest.mark.parametrize("sample_mode", ["roll", "gather"])
def test_adaptive_budget_matches_jax(two_mode, n_modes, sample_mode):
    """adapt_iterations on lanes of different support: JAX extends each lane
    until its confidence test passes (up to 15 extra chunks here) and keeps
    a finished lane's carry; the port, given the extra chunks' bits, elects
    the same hypotheses with the same counts."""
    p, q, v = low_support_lanes()
    keys = jax.random.split(jax.random.PRNGKey(10), 3)
    kw = dict(dist_thresh=0.15, iterations=256, batch_size=256, adapt_iterations=4096,
              two_mode=two_mode, n_modes=n_modes, sample_mode=sample_mode)
    outj, outp = run_both(p, q, v, keys, **kw)
    (Tj, cj), (Tp, cp) = outj, outp
    np.testing.assert_array_equal(cp, cj)
    lead = cj if not two_mode else cj[:, 0]
    np.testing.assert_allclose(Tp if not two_mode else Tp[:, 0],
                               Tj if not two_mode else Tj[:, 0], atol=1e-4)
    # Without the extension the fixed budget elects worse in some lane.
    fixed = run_both(p, q, v, keys, **{**kw, "adapt_iterations": 0})[1][1]
    assert (lead >= (fixed if not two_mode else fixed[:, 0])).all()
    assert (lead > (fixed if not two_mode else fixed[:, 0])).any()


@pytest.mark.parametrize("two_mode,n_modes,subset", [(False, 2, 0), (False, 2, 200),
                                                     (True, 2, 0), (True, 5, 0)])
def test_refit_off_matches_jax(arch_corr, two_mode, n_modes, subset):
    """refit=False: each elected mode is its chunk's hypothesis as fitted
    from three rows, its count the hypothesis's score (exact under
    score_subset), clamped at 0 and un-shifted."""
    keys = jax.random.split(jax.random.PRNGKey(14), 3)
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, iterations=2 * K, batch_size=K,
              approx_score=True, two_mode=two_mode, n_modes=n_modes, score_subset=subset)
    outj, outp = run_both(*arch_corr, keys, refit=False, **kw)
    assert_same(outj, outp)
    refitted = run_both(*arch_corr, keys, **kw)[1]
    assert not np.array_equal(outp[0], refitted[0])


def test_refit_off_checker_failures_match_jax():
    """Collinear correspondences (as tests/test_parallel.py): every sample
    fails the frame check and scores -1, so without the refit the step
    returns the identity with count 0, in both packages."""
    n = 256
    s = np.linspace(0.0, 1.0, n, dtype=np.float32)
    p = np.stack([s, 2 * s, 3 * s], axis=1)
    lanes = (np.stack([p, p]), np.stack([p + 0.5, p + 0.5]), np.ones((2, n), bool))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    outj, outp = run_both(*lanes, keys, dist_thresh=1e-4, iterations=512, batch_size=512,
                          score_subset=64, rescore_top=32, refit=False)
    assert_same(outj, outp, atol=1e-6)
    assert (outp[1] == 0).all()
    np.testing.assert_array_equal(outp[0], np.broadcast_to(np.eye(4, dtype=np.float32),
                                                           (2, 4, 4)))


@pytest.mark.parametrize("confidence", [1e-6, 0.99999])
def test_confidence_matches_jax(confidence, monkeypatch):
    """A confidence other than 0.999 moves the adaptive budget's stopping
    test the same way in both packages.  At 1e-6 a lane with any support
    needs under one hypothesis, so only the lane the fixed chunk left at
    0 support (w = 0 asks for every chunk) runs on, until it has some; at
    0.99999 the low-support lanes run to the cap of 15 extra chunks."""
    calls = []
    sampler = multipair.rolled_sample_gathers
    monkeypatch.setattr(multipair, "rolled_sample_gathers",
                        lambda *a, **k: calls.append(1) or sampler(*a, **k))
    p, q, v = low_support_lanes()
    keys = jax.random.split(jax.random.PRNGKey(10), 3)
    outj, outp = run_both(p, q, v, keys, dist_thresh=0.15, iterations=256, batch_size=256,
                          adapt_iterations=4096, confidence=confidence)
    assert_same(outj, outp)
    n_extra = len(calls) - 1
    assert (0 < n_extra < 15) if confidence < 0.5 else n_extra == 15


def test_score_subset_ignored_with_two_modes(arch_corr):
    """As in JAX, the two-stage score is a single-mode option: with
    two_mode the step is the two-mode step."""
    p, q, v = (torch.from_numpy(x) for x in arch_corr)
    bits = torch.randint(0, 1 << 32, (3, 1, 256), generator=torch.Generator().manual_seed(0))
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, iterations=K, batch_size=K, two_mode=True)
    T0, c0 = p_ransac(p, q, v, bits, **kw)
    T1, c1 = p_ransac(p, q, v, bits, score_subset=128, **kw)
    assert torch.equal(c0, c1) and torch.equal(T0, T1)
