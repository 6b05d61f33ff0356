"""Port parity for tpu3dm_torch.viz (export.py, trace.py) on the CPU.

Every exported file must equal JAX's byte for byte from the same points,
transform and trace.  ``traced_ransac``, given JAX's own randomness (the
correspondence noise from ``k_corr`` and each chunk's bits from ``key, k =
split(key)``, as ``tpu3dm/viz/trace.py:69,96`` draws them), must give JAX's
trace: the same iteration and early-stop rows, fitness within one count and
each row's best pose within 1e-5 on the clean pair.  With 2/3 of the
correspondences bogus (noise ratio 2) the winning 3-point samples are
ill-conditioned, and the two Horn fits' summation orders (the port's fixed
order, JAX's einsum) move their poses by up to 2.9e-5: held to 1e-4 there.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tpu3dm.core.cloud import from_numpy as j_from_numpy
from tpu3dm.core.config import PipelineConfig as JConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.preprocess import pipeline as jpipe
from tpu3dm.viz import export as jexport
from tpu3dm.viz import trace as jtrace
from tpu3dm_torch.core.cloud import from_numpy, from_reference_arrays
from tpu3dm_torch.core.config import RansacConfig
from tpu3dm_torch.ops.nn_sparse import nn_blocksparse, pad_sorted
from tpu3dm_torch.ops.ransac_score import (
    DENSE_MAX_ENTRIES,
    score_hypotheses,
    score_hypotheses_dense,
)
from tpu3dm_torch.viz import export, trace

CFG = JConfig.with_voxel_size(0.3)


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrays(pc):
    return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}


@pytest.fixture(scope="module")
def pair():
    """A 4000-point arch pair preprocessed by JAX and carried to the port."""
    sp, tp, T_true = make_benchmark_pair(4000, seed=1, sigma=0.005)
    sd, td = (jpipe.preprocess_points(x, CFG.preprocess).down for x in (sp, tp))
    return (sd, td, from_reference_arrays(_arrays(sd), device="cpu"),
            from_reference_arrays(_arrays(td), device="cpu"), T_true)


def _jax_trace_randomness(key, chunk, n_chunks, ns, n_src, n_tgt):
    """JAX's traced_ransac draws: (k_corr, key) = split(key); the noise from
    split(k_corr, 3); chunk i's bits from the i-th (key, k) = split(key)."""
    k_corr, key = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k_corr, 3)
    draws = (_t(jax.random.uniform(k1, (ns,))), _t(jax.random.randint(k2, (ns,), 0, n_src)),
             _t(jax.random.randint(k3, (ns,), 0, n_tgt)))
    bits = []
    for _ in range(n_chunks):
        key, k = jax.random.split(key)
        bits.append(np.asarray(jax.random.bits(k, (chunk, 2), np.uint32)).astype(np.int64))
    return torch.from_numpy(np.stack(bits)), draws


def _traced_both(pair, noise_ratio, *, chunk=256, max_iterations=4096, seed=3):
    sd, td, ps, pt, _ = pair
    rc = RansacConfig(voxel_size=0.3)
    key = jax.random.PRNGKey(seed)
    jres, jrows = jtrace.traced_ransac(sd, td, CFG.ransac, key=key, noise_ratio=noise_ratio,
                                       chunk=chunk, max_iterations=max_iterations)
    bits, draws = _jax_trace_randomness(key, chunk, -(-max_iterations // chunk), ps.capacity,
                                        int(ps.mask.sum()), int(pt.mask.sum()))
    pres, prows = trace.traced_ransac(ps, pt, rc, sample_bits=bits, noise_ratio=noise_ratio,
                                      noise_draws=draws if noise_ratio > 0 else None,
                                      chunk=chunk, max_iterations=max_iterations)
    return jres, jrows, pres, prows


@pytest.mark.parametrize("noise_ratio", [0.0, 2.0])
def test_traced_ransac_matches_jax(pair, noise_ratio):
    jres, jrows, pres, prows = _traced_both(pair, noise_ratio)
    n_valid = int(pair[2].mask.sum())
    pose_tol = 1e-5 if noise_ratio == 0 else 1e-4
    assert [(r["iteration"], r["early_stop"]) for r in prows] == \
        [(r["iteration"], r["early_stop"]) for r in jrows]
    for jr, pr in zip(jrows, prows):
        for k in ("current_fitness", "best_fitness"):
            assert abs(pr[k] - jr[k]) <= 1.0 / n_valid + 1e-4, (k, pr[k], jr[k])
        np.testing.assert_allclose(pr["best_T"], jr["best_T"], atol=pose_tol)
    assert abs(float(pres.fitness) - float(jres.fitness)) <= 1.0 / n_valid + 1e-6
    assert int(pres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(pres.transformation.numpy(), np.asarray(jres.transformation),
                               atol=pose_tol)
    assert float(pres.inlier_rmse) == pytest.approx(float(jres.inlier_rmse), abs=1e-5)


def test_traced_ransac_early_stop_and_generator(pair):
    """On the clean pair the search stops early (fitness > 0.5), and a
    generator instead of bits gives a trace of the same layout."""
    _, _, ps, pt, _ = pair
    rc = RansacConfig(voxel_size=0.3)
    _, rows = trace.traced_ransac(ps, pt, rc, generator=torch.Generator().manual_seed(0),
                                  early_stop_threshold=0.0, chunk=128, max_iterations=100_000)
    assert rows[-1]["early_stop"] and rows[-1]["iteration"] < 100_000
    bests = [r["best_fitness"] for r in rows]
    assert all(b2 >= b1 for b1, b2 in zip(bests, bests[1:]))
    with pytest.raises(ValueError, match="sample_bits"):
        trace.traced_ransac(ps, pt, rc, sample_bits=torch.zeros((2, 128, 2), dtype=torch.int64),
                            chunk=128, max_iterations=1024)


@pytest.mark.parametrize("w, c, k", [(0.0, 0.99, 3), (0.005, 0.99, 3), (0.3, 0.99, 3),
                                     (0.5, 0.99, 3), (0.9, 0.999, 3), (0.99, 0.99, 4),
                                     (1.0, 0.99, 3)])
def test_compute_required_iterations_equals_jax(w, c, k):
    assert trace.compute_required_iterations(w, c, k) == \
        jtrace.compute_required_iterations(w, c, k)


# ---------------------------------------------------------------------------
# Exports: byte-equal files
# ---------------------------------------------------------------------------


def _clouds(n_src, n_tgt, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n_src, 3)).astype(np.float32)
    t = rng.normal(size=(n_tgt, 3)).astype(np.float32)
    return (j_from_numpy(s), j_from_numpy(t), from_numpy(s, device="cpu"),
            from_numpy(t, device="cpu"))


def _pose(seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = rng.normal(size=3)
    return T.astype(np.float32)


def test_export_registration_ply_byte_equal(tmp_path):
    js, jt, ps, pt = _clouds(700, 500)
    T = _pose()
    jexport.export_registration_ply(tmp_path / "j.ply", js, jt, T)
    export.export_registration_ply(tmp_path / "p.ply", ps, pt, T)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("max_points, info, zoom", [(60_000, "", 0.7), (400, "fit=0.9", 1.3)])
def test_export_registration_html_byte_equal(tmp_path, max_points, info, zoom):
    js, jt, ps, pt = _clouds(700, 500, seed=1)
    T = _pose(1)
    kw = dict(info=info, zoom=zoom, max_points=max_points)
    jexport.export_registration_html(tmp_path / "j.html", js, jt, T, **kw)
    export.export_registration_html(tmp_path / "p.html", ps, pt, T, **kw)
    assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_trace_and_animation_exports_byte_equal(pair, tmp_path):
    sd, td, ps, pt, _ = pair
    _, jrows, _, prows = _traced_both(pair, 1.0, chunk=512, max_iterations=2048)
    jexport.export_iteration_trace(tmp_path / "j.jsonl", jrows)
    export.export_iteration_trace(tmp_path / "p.jsonl", jrows)
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()] == jrows
    for kw in ({}, {"max_points": 600, "frame_delay_ms": 10, "info": "replay"}):
        jexport.export_ransac_animation_html(tmp_path / "j.html", sd, td, jrows, **kw)
        export.export_ransac_animation_html(tmp_path / "p.html", ps, pt, jrows, **kw)
        assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    with pytest.raises(ValueError, match="best_T"):
        export.export_ransac_animation_html(tmp_path / "x.html", ps, pt, [{"iteration": 1}])


# ---------------------------------------------------------------------------
# The two public names the apps take from ops/
# ---------------------------------------------------------------------------


def _score_inputs(k, n, seed, dyadic):
    """k hypotheses near one rotation over n noisy correspondences, 10%
    masked.  ``dyadic``: every coordinate a multiple of 1/16 and R a signed
    permutation, so every product and sum of the score is exact in fp32."""
    rng = np.random.default_rng(seed)
    if dyadic:
        perm = np.eye(3)[rng.permutation(3)] * rng.choice([-1.0, 1.0], size=(3, 1))
        R = np.tile(perm[None], (k, 1, 1))
        t = rng.integers(-4, 5, size=(k, 3)) / 16.0
        p = rng.integers(-32, 33, size=(n, 3)) / 16.0
        q = p @ perm.T + rng.integers(-2, 3, size=(n, 3)) / 16.0
    else:
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = np.tile(rot[None], (k, 1, 1)) + 0.01 * rng.normal(size=(k, 3, 3))
        t = 0.05 * rng.normal(size=(k, 3))
        p = rng.normal(size=(n, 3))
        q = p @ rot.T + 0.05 * rng.normal(size=(n, 3))
    return [a.astype(np.float32) for a in (R, t, p, q)] + [rng.random(n) > 0.1]


@pytest.mark.parametrize("k, n, dyadic", [(256, 1000, False), (64, 262_656, True),
                                          (64, 262_656, False)])
def test_score_hypotheses_equals_jax(k, n, dyadic):
    """Dense up to DENSE_MAX_ENTRIES (equal to JAX's counts), one lane of
    score_features above: equal counts where the arithmetic is exact
    (dyadic inputs), and on random inputs both packages' counts inside the
    float64 bracket of the fp32 rounding (``score_count_bracket``)."""
    from tpu3dm.ops.ransac_score import score_hypotheses as j_score
    from tpu3dm_torch.ops.ransac_score import (
        FP32_CHAIN_REL,
        corres_features,
        hypothesis_features,
        score_count_bracket,
    )

    R, t, p, qq, mask = _score_inputs(k, n, k + n, dyadic)
    thr = float(np.float32(0.1) ** 2) if not dyadic else 0.0625
    args = [_t(a) for a in (R, t, p, qq, mask)]
    got = score_hypotheses(*args, thr)
    want = np.asarray(j_score(R, t, p, qq, mask, thr))
    assert got.dtype == torch.int32 and got.shape == (k,)
    if dyadic or k * n <= DENSE_MAX_ENTRIES:
        np.testing.assert_array_equal(got.numpy(), want)
    if k * n <= DENSE_MAX_ENTRIES:
        assert torch.equal(got, score_hypotheses_dense(*args, thr))
    else:
        F, c = corres_features(args[2], args[3])
        H, e = hypothesis_features(args[0], args[1])
        sure, near = score_count_bracket(H[None], e[None], F[None], c[None], args[4][None], thr,
                                         FP32_CHAIN_REL)
        sure, near = sure[0].numpy(), near[0].numpy()
        for counts in (got.numpy(), want):
            assert ((counts >= sure) & (counts <= sure + near)).all()


@pytest.mark.parametrize("block, w", [(256, 4), (512, 8)])
def test_nn_blocksparse_equals_jax(block, w):
    from tpu3dm.ops import nn_sparse as jsp

    rng = np.random.default_rng(block)
    q = rng.normal(size=(3000, 3)).astype(np.float32)
    t = (q + 0.01 * rng.normal(size=q.shape)).astype(np.float32)[::-1].copy()
    qs = pad_sorted(q[jsp.kd_perm(q, block)], block)
    ts = pad_sorted(t[jsp.kd_perm(t, block)], block)
    d2, idx, lb = nn_blocksparse(_t(qs), _t(ts), block=block, w=w)
    jd2, jidx, jlb = (np.asarray(x) for x in jsp.nn_blocksparse(qs, ts, block=block, w=w))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    # Both expand |q - t|^2 = |t|^2 - 2 q.t + |q|^2 in their own order; the
    # cancellation leaves ~eps * (|q|^2 + |t|^2) (up to ~20 here) per entry.
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(lb.numpy(), jlb, rtol=1e-6)
