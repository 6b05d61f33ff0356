"""Port parity for the tiled and block-sparse NN searches (CPU, small shapes).

The plain versions of the port's kernels 4-6 (``nn_search_tiled_plain``,
``nn_search_table_plain``) are held against the JAX package's Pallas
kernels in interpret mode and against its XLA references.  XLA on the CPU
may contract a multiply and an add into one FMA where PyTorch rounds each
step, so distances agree to the last bits, and indices wherever no two
targets tie within that rounding.

The JAX ``kd_perm`` calls its native C++ partition, its default; the port
calls its own copy of that C++.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3dm.native
from tpu3dm.io.synthetic import dental_arch_cloud
from tpu3dm.ops import nn as jnn
from tpu3dm.ops import nn_sparse as jsp
from tpu3dm_torch.ops import nn as pnn
from tpu3dm_torch.ops import nn_sparse as psp


@pytest.fixture(scope="module", autouse=True)
def native_tier():
    """The JAX native tier loaded, after any build race at collection (see
    tests/test_torch_host.py:native_tier)."""
    if not tpu3dm.native.available():
        tpu3dm.native._tried = False
        tpu3dm.native._lib = None
        tpu3dm.native.lib()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n, d, frac_masked=0.2):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, rng.random(n) > frac_masked


# ---------------------------------------------------------------------------
# Kernels 4 and 5: the tiled search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [3, 33])
def test_tiled_plain_matches_pallas_interpret(d):
    """Same arithmetic as the TPU kernels: equal indices; d2 within a few ulp
    at d = 3 (relative 5e-7: XLA fuses the sum of squares into FMAs) and
    within 2e-5 at d = 33 (|t|^2 - 2 q.t summed in another order at
    |t|^2 ~ 33)."""
    rng = np.random.default_rng(d)
    q, _ = _cloud(rng, 700, d)
    t, tm = _cloud(rng, 5000, d)
    dj, ij = jnn.nn_search_pallas(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tm),
                                  tile_t=1024, interpret=True)
    dp, ip = pnn.nn_search_tiled(_t(q), _t(t), None, _t(tm))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    if d == 3:
        np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=5e-7, atol=1e-12)
    else:
        np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=0, atol=2e-5)
    assert tm[ip.numpy()].all()


def _grid_query_mask(case, rng, n):
    """A query mask of the kind each caller passes: the valid prefix of a
    padded cloud (the downsampled ICP and evaluation), every third row, a
    random ~80%."""
    if case == "prefix":
        m = np.zeros(n, bool)
        m[: n * 5 // 6] = True
        return m
    if case == "strided":
        return np.arange(n) % 3 != 1
    return rng.random(n) > 0.2


@pytest.mark.parametrize("case", ["prefix", "strided", "random"])
def test_tiled_plain_with_query_mask_matches_pallas_on_integer_grid(case):
    """d = 3 on an integer grid, where every distance is exact in both
    packages and ties abound (duplicated targets, masked twins): on the
    valid query rows the plain version's picks and distances equal the TPU
    kernel's in interpret mode exactly.  JAX never reads the query mask; the
    port's plain version computes masked rows too, and the d = 3 kernel
    skips them (idx 0, d2 = BIG: held on the card in test_torch_kernels.py)."""
    rng = np.random.default_rng({"prefix": 1, "strided": 2, "random": 3}[case])
    q = rng.integers(-3, 4, size=(1500, 3)).astype(np.float32)
    t = rng.integers(-3, 4, size=(2600, 3)).astype(np.float32)
    t[2100:2300] = t[:200]
    tm = rng.random(2600) > 0.25
    tm[:100] = False  # the first copy of some duplicated targets is masked
    qm = _grid_query_mask(case, rng, 1500)
    dj, ij = jnn.nn_search_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qm),
                                  jnp.asarray(tm), tile_t=512, interpret=True)
    dp, ip = pnn.nn_search_tiled(_t(q), _t(t), _t(qm), _t(tm))
    np.testing.assert_array_equal(ip.numpy()[qm], np.asarray(ij)[qm])
    np.testing.assert_array_equal(dp.numpy()[qm], np.asarray(dj)[qm])
    assert tm[ip.numpy()[qm]].all()


@pytest.mark.parametrize("case", ["prefix", "strided", "random"])
def test_tiled_plain_d33_with_query_mask_matches_pallas_on_integer_grid(case):
    """d = 33 (the FPFH width, kernel 5) with the query mask the port's
    callers pass, on an integer grid where every dot and norm is exact in
    both packages and ties abound (twin targets, a masked first copy): on
    the valid query rows the plain version's picks and distances equal the
    TPU kernel's in interpret mode exactly.  The d = 33 kernel skips masked
    rows (idx 0, d2 = BIG: held on the card in test_torch_kernels.py)."""
    rng = np.random.default_rng({"prefix": 4, "strided": 5, "random": 6}[case])
    q = rng.integers(0, 4, size=(700, 33)).astype(np.float32)
    t = rng.integers(0, 4, size=(1300, 33)).astype(np.float32)
    t[1100:1200] = t[:100]
    q[:50] = t[:50]  # rows at distance 0 from a twin pair
    tm = rng.random(1300) > 0.25
    tm[:30] = False  # the first copy of some twins is masked
    qm = _grid_query_mask(case, rng, 700)
    dj, ij = jnn.nn_search_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qm),
                                  jnp.asarray(tm), tile_t=512, interpret=True)
    dp, ip = pnn.nn_search_tiled(_t(q), _t(t), _t(qm), _t(tm))
    np.testing.assert_array_equal(ip.numpy()[qm], np.asarray(ij)[qm])
    np.testing.assert_array_equal(dp.numpy()[qm], np.asarray(dj)[qm])
    assert tm[ip.numpy()[qm]].all()


@pytest.mark.parametrize("d", [3, 33])
def test_tiled_plain_matches_xla_reference(d):
    """nn_search_xla expands every d as |t|^2 - 2 q.t + |q|^2 (the port's d = 3
    path sums true squared differences): d2 within 1e-5 (cancellation at
    |q|^2 ~ d), indices equal away from near-ties (>= 99.9%)."""
    rng = np.random.default_rng(10 + d)
    q, _ = _cloud(rng, 900, d)
    t, tm = _cloud(rng, 4500, d)
    dx, ix = jnn.nn_search_xla(jnp.asarray(q), jnp.asarray(t), None, jnp.asarray(tm))
    dp, ip = pnn.nn_search_tiled_plain(_t(q), _t(t), None, _t(tm))
    assert (ip.numpy() == np.asarray(ix)).mean() >= 0.999
    np.testing.assert_allclose(dp.numpy(), np.asarray(dx), rtol=0, atol=2e-5)


def test_tiled_plain_is_chunk_independent(monkeypatch):
    """Chunking over queries changes nothing: one chunk and many agree bit for bit."""
    rng = np.random.default_rng(3)
    q, _ = _cloud(rng, 1000, 3)
    t, tm = _cloud(rng, 3000, 3)
    d_one, i_one = pnn.nn_search_tiled_plain(_t(q), _t(t), None, _t(tm))
    real = pnn.lane_slices
    monkeypatch.setattr(pnn, "lane_slices", lambda n, e: real(n, e, max_entries=e * 7))
    d_many, i_many = pnn.nn_search_tiled_plain(_t(q), _t(t), None, _t(tm))
    assert torch.equal(d_one, d_many) and torch.equal(i_one, i_many)


@pytest.mark.parametrize("nq", [4000, 4200])  # 16.4M and 17.2M entries: dense, then tiled
@pytest.mark.parametrize("d", [3, 33])
def test_nn_search_both_sides_of_dense_max(nq, d):
    nt = 4096
    assert (nq * nt > pnn.DENSE_MAX_ENTRIES) == (nq == 4200)
    rng = np.random.default_rng(nq + d)
    q, qm = _cloud(rng, nq, d)
    t, tm = _cloud(rng, nt, d)
    dj, ij = jnn.nn_search(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qm), jnp.asarray(tm))
    dp, ip = pnn.nn_search(_t(q), _t(t), _t(qm), _t(tm))
    # JAX's CPU route above the limit is nn_search_xla (matmul form at every d).
    assert (ip.numpy() == np.asarray(ij))[qm].mean() >= 0.999
    np.testing.assert_allclose(dp.numpy()[qm], np.asarray(dj)[qm], rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [2000, 4200])  # 4M and 17.6M entries: one matrix, then two searches
def test_nn_mutual_both_sides_of_dense_max(n):
    rng = np.random.default_rng(n)
    a, am = _cloud(rng, n, 33, 0.1)
    b, bm = _cloud(rng, n + 10, 33, 0.1)
    fj, bj = jnn.nn_mutual(jnp.asarray(a), jnp.asarray(b), jnp.asarray(am), jnp.asarray(bm))
    fp, bp = pnn.nn_mutual(_t(a), _t(b), _t(am), _t(bm))
    assert (fp.numpy() == np.asarray(fj))[am].mean() >= 0.999
    assert (bp.numpy() == np.asarray(bj))[bm].mean() >= 0.999
    mutual_j = np.asarray(bj)[np.asarray(fj)] == np.arange(n)
    mutual_p = bp.numpy()[fp.numpy()] == np.arange(n)
    assert (mutual_j == mutual_p)[am].mean() >= 0.999 and mutual_p[am].any()


# ---------------------------------------------------------------------------
# Host partition and candidate selection
# ---------------------------------------------------------------------------


def test_kd_perm_and_pad_sorted_equal_jax():
    """The C++ partitions of both packages (JAX's native tier, the port's
    csrc/host.cpp) give the same permutation."""
    assert tpu3dm.native.available()
    pts = dental_arch_cloud(9000, seed=4).astype(np.float32)
    for block in (128, 512):
        perm = psp.kd_perm(pts, block)
        np.testing.assert_array_equal(perm, jsp.kd_perm(pts, block))
        np.testing.assert_array_equal(np.sort(perm), np.arange(9000))
        np.testing.assert_array_equal(psp.pad_sorted(pts[perm], block),
                                      jsp.pad_sorted(pts[perm], block))
    assert psp.pad_sorted(pts[:1024], 512).shape == (1024, 3)


def _sorted_pair(n, block):
    tgt = dental_arch_cloud(n, seed=0).astype(np.float32)
    qry = dental_arch_cloud(n, seed=1).astype(np.float32) + 0.005
    tp = jsp.pad_sorted(tgt[jsp.kd_perm(tgt, block)], block)
    qp = jsp.pad_sorted(qry[jsp.kd_perm(qry, block)], block)
    return qp, tp


@pytest.mark.parametrize("w", [4, 8])
def test_candidate_blocks_equal_jax(w):
    qp, tp = _sorted_pair(4000, 128)
    ij, cj = jsp.candidate_blocks(jnp.asarray(qp), jnp.asarray(tp), 128, w)
    ip, cp = psp.candidate_blocks(_t(qp), _t(tp), 128, w)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    assert ip.dtype == torch.int32 and ip.is_contiguous()


# ---------------------------------------------------------------------------
# Kernel 6: the block-sparse search
# ---------------------------------------------------------------------------


def test_blocksparse_plain_matches_pallas_interpret_and_xla():
    """n = 4000, block 128, w 8 (as tests/test_large.py runs the Pallas kernel).
    d2 within 2e-5: |t|^2 - 2 q.t + |q|^2 cancels at |q|^2 ~ 30, and XLA sums
    the cross term in another order; indices equal on >= 99.9% of real rows
    (near-ties within that rounding), and the certificates within 1 ulp."""
    qp, tp = _sorted_pair(4000, 128)
    real = qp[:, 0] < 1e5
    d2t, ixt, ct = psp.nn_search_blocksparse(_t(qp), _t(tp), block=128, w=8)
    for fn in (lambda *a, **k: jsp.nn_search_blocksparse(*a, interpret=True, **k),
               jsp.nn_search_blocksparse_xla):
        d2j, ixj, cj = (np.asarray(x) for x in fn(jnp.asarray(qp), jnp.asarray(tp), block=128, w=8))
        assert (ixt.numpy() == ixj)[real].mean() >= 0.999
        np.testing.assert_allclose(d2t.numpy()[real], d2j[real], rtol=0, atol=2e-5)
        np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-6)  # jit fuses the box distances


def test_blocksparse_ties_go_to_first_row_and_earlier_block():
    """Duplicate target points: the winner is the first row of the
    earliest-ranked visited block, as the TPU kernel's running min keeps it."""
    block = 4
    t = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0], [5, 5, 5],
                  [1, 0, 0], [9, 9, 9], [1, 0, 0], [8, 8, 8]], np.float32)
    q = np.array([[1, 0, 0]] * 4, np.float32)
    for order, expect in (([0, 1], 1), ([1, 0], 4)):
        table = torch.tensor([order], dtype=torch.int32)
        d2, idx = psp.nn_search_table(_t(q), _t(t), table, block=block)
        assert (idx.numpy() == expect).all() and (d2.numpy() == 0).all()


def test_blocksparse_with_every_block_is_exact():
    """w = every block: the same answers as the dense search."""
    qp, tp = _sorted_pair(2000, 128)
    real = qp[:, 0] < 1e5
    d2, idx, _ = psp.nn_search_blocksparse(_t(qp), _t(tp), block=128, w=tp.shape[0] // 128)
    dd, idd = pnn.nn_search_dense(_t(qp), _t(tp))
    assert (idx.numpy() == idd.numpy())[real].mean() >= 0.999
    np.testing.assert_allclose(d2.numpy()[real], dd.numpy()[real], rtol=0, atol=2e-5)


def test_table_plain_is_chunk_independent(monkeypatch):
    qp, tp = _sorted_pair(3000, 128)
    table, _ = psp.candidate_blocks(_t(qp), _t(tp), 128, 8)
    d_one, i_one = psp.nn_search_table_plain(_t(qp), _t(tp), table, block=128)
    real = psp.lane_slices
    monkeypatch.setattr(psp, "lane_slices", lambda n, e: real(n, e, max_entries=e * 3))
    d_many, i_many = psp.nn_search_table_plain(_t(qp), _t(tp), table, block=128)
    assert torch.equal(d_one, d_many) and torch.equal(i_one, i_many)
