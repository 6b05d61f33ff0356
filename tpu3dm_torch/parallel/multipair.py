"""Fixed-budget RANSAC over a batch of pairs (port of tpu3dm/parallel/multipair.py).

``ransac_pair_step`` is the JAX single-pair step with the pair dimension
written out: every tensor carries a leading [B] lane axis, the hypothesis
chunks run as a Python loop, and the sample bits come from the caller or a
``torch.Generator`` in place of a ``jax.random`` key.  It runs single-mode
(optionally with two-stage scoring), two-mode (the leader and the best
rotation-far hypothesis) and N-mode (``n_modes`` rotation-separated support
peaks), with the roll or the gather sampler and the adaptive budget.
``batched_ransac`` runs it with the pair axis sharded over a mesh
(parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch.ops.compact import compaction_permutation
from tpu3dm_torch.ops.ransac_score import corres_features
from tpu3dm_torch.ops.rowsum import chain_sum, ordered_sum, small_matvec
from tpu3dm_torch.parallel.mesh import PAIR_AXIS, map_shards
from tpu3dm_torch.registration.hypotheses import (
    fit_score_gathers,
    refit_inliers,
    rescore_rows,
    rolled_sample_gathers,
    rot_cos_planar,
    sample_distinct_triples,
    sample_fit_score,
    sample_row_count,
    winner_T,
)

# The adaptive budget's extra chunks draw from fold_in(key, EXTRA_KEY_SALT)
# in JAX, a stream disjoint from the fixed chunks'.
EXTRA_KEY_SALT = 0x5F5E


def f32_square(x: float) -> float:
    """``jnp.float32(x) ** 2`` as a Python float: the exact fp32 threshold
    the JAX package compares against."""
    return float(np.float32(x) * np.float32(x))


def draw_bits(shape: tuple[int, ...], generator: torch.Generator | None = None) -> torch.Tensor:
    """int64 tensor of ``shape`` holding uniform uint32 values, drawn on the
    CPU from ``generator`` (torch's default generator when None)."""
    return torch.randint(0, 1 << 32, shape, generator=generator, dtype=torch.int64)


def chunk_bits_shape(m: int, batch_size: int, sample_mode: str = "roll",
                     sample_rows: int = 0) -> tuple[int, ...]:
    """The bits one hypothesis chunk takes: (m_s,) for the roll sampler
    (JAX: ``jax.random.bits(k_chunk, (m_s,))``, m_s = ``sample_row_count``),
    (batch_size, 2) for the gather sampler (``bits(k_chunk, (K, 2))``)."""
    if sample_mode == "roll":
        return (sample_row_count(m, batch_size, sample_rows),)
    if sample_mode == "gather":
        return (batch_size, 2)
    raise ValueError(f"sample_mode must be 'roll' or 'gather', got {sample_mode!r}")


def extra_chunk_count(iterations: int, adapt_iterations: int, batch_size: int) -> int:
    """The most chunks the adaptive budget adds: ceil((adapt_iterations -
    iterations) / batch_size), 0 when adapt_iterations <= iterations."""
    return max(0, -(-(adapt_iterations - iterations) // batch_size))


def checked_bits(name: str, bits, shape: tuple[int, ...], generator, device) -> torch.Tensor:
    """``bits`` of ``shape`` on ``device`` (drawn from ``generator`` when None)."""
    if bits is None:
        bits = draw_bits(shape, generator)
    if tuple(bits.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(bits.shape)}")
    return bits.to(device=device, dtype=torch.int64)


def f32_cos_deg(deg: float) -> float:
    """``jnp.cos(jnp.deg2rad(jnp.float32(deg)))`` as a Python float."""
    return float(np.cos(np.deg2rad(np.float32(deg))))


def rot_cos(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """cos of the rotation angle between Ta and Tb ([..., 4, 4] each):
    (trace(Ra^T Rb) - 1) / 2."""
    return (chain_sum((Ta[..., :3, :3] * Tb[..., :3, :3]).flatten(-2)) - 1.0) * 0.5


def _at(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[b, k[b]] for x [B, K, ...] and k [B]."""
    return x[torch.arange(x.shape[0], device=x.device), k]


def _peaks(R, t, counts, n_modes: int, cos_thr: float):
    """The n_modes best rotation-separated hypotheses of a chunk: iterative
    argmax, masking every hypothesis rotation-near the one taken.  Returns
    (Ts [B, n, 4, 4], counts [B, n])."""
    Ts, cs, cw = [], [], counts
    for _ in range(n_modes):
        k = torch.argmax(cw, dim=-1)
        Tk = winner_T(R, t, k)
        Ts.append(Tk)
        cs.append(_at(cw, k))
        cw = torch.where(rot_cos_planar(Tk, R) >= cos_thr, -1, cw)
    return torch.stack(Ts, 1), torch.stack(cs, 1)


def _reselect(allT, allc, n_modes: int, cos_thr: float):
    """Greedy re-selection of n_modes rotation-separated modes from carried
    and new candidates (allT [B, C, 4, 4], allc [B, C]); a rotation
    duplicate of a taken mode counts -1."""
    outT, outc, aw = [], [], allc
    for _ in range(n_modes):
        k = torch.argmax(aw, dim=-1)
        Tk = _at(allT, k)
        outT.append(Tk)
        outc.append(_at(aw, k))
        aw = torch.where(rot_cos(Tk[:, None], allT) >= cos_thr, -1, aw)
    return torch.stack(outT, 1), torch.stack(outc, 1)


def _where_T(cond: torch.Tensor, Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[:, None, None], Ta, Tb)


def _merge(T1, c1, T2, c2, Tc, cc, cos_thr: float):
    """Fold candidate (Tc, cc) into the two mode slots (branchless, per
    lane): a better candidate takes slot 1 whether or not it is
    rotation-near the leader; nearness to the leader only gates slot 2."""
    near1 = rot_cos(T1, Tc) >= cos_thr
    up = cc > c1
    far_T2 = _where_T(up, T1, _where_T(cc > c2, Tc, T2))
    far_c2 = torch.where(up, c1, torch.maximum(cc, c2))
    return (_where_T(up, Tc, T1), torch.maximum(cc, c1),
            _where_T(near1, T2, far_T2), torch.where(near1, c2, far_c2))


def ransac_pair_step(
    p_all: torch.Tensor,
    q_all: torch.Tensor,
    valid: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    iterations: int,
    batch_size: int,
    edge_length_ratio: float = 0.9,
    refit: bool = True,
    approx_score: bool = False,
    two_mode: bool = False,
    mode_angle_deg: float = 15.0,
    score_subset: int = 0,
    rescore_top: int = 128,
    sample_mode: str = "roll",
    sample_rows: int = 0,
    adapt_iterations: int = 0,
    confidence: float = 0.999,
    n_modes: int = 2,
    extra_bits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget RANSAC per pair lane, with the exact refit.

    Args:
      p_all, q_all: [B, M, 3] correspondence points; valid: [B, M] bool.
      sample_bits: [B, n_chunks, *chunk] int64 of uint32 values, chunk =
        ``chunk_bits_shape``: (m_s,) for ``sample_mode="roll"`` (JAX draws
        ``jax.random.bits(split(key, n_chunks)[i], (m_s,))``), (K, 2) for
        ``"gather"`` (``bits(k_i, (K, 2))``); drawn from ``generator`` when
        None.  ``sample_rows`` sets m_s (``sample_row_count``).
      two_mode: also track the best hypothesis whose rotation is more than
        ``mode_angle_deg`` from the leader (``n_modes == 2``), or the
        ``n_modes`` best rotation-separated support peaks (``n_modes > 2``).
      score_subset, rescore_top: single mode with 0 < S < M scores on the
        stride subset F[::max(1, M // S)][:S], rescores the top
        min(rescore_top, K) of each chunk exactly over all M (fp32) and
        elects on the exact counts.
      adapt_iterations > iterations: after the fixed chunks, lanes whose
        support w = count / n_valid leaves log(1 - confidence) /
        log(1 - w^3) above the hypotheses run so far take extra chunks, up
        to ``extra_chunk_count``; a lane that is done keeps its carry, so
        its j-th extra chunk draws ``extra_bits[:, j]``
        ([B, max_extra, *chunk]; JAX: the j-th ``split`` of
        ``fold_in(key, 0x5F5E)``), drawn from ``generator`` when None.
        The loop syncs with the host once an extra chunk.
      refit: re-fit each elected mode on its inliers (exact Horn).

    Both clouds are shifted to the valid-correspondence centroid before the
    hypothesis work (the precondition of ``approx_score``); every returned
    mode is re-fitted on its inliers and un-shifted.

    Returns (T [B, 4, 4], count [B] int32), or with ``two_mode``
    (Ts [B, n_modes, 4, 4], counts [B, n_modes]), the leader first.
    """
    b, m = valid.shape
    dev = valid.device
    thresh_sq = f32_square(dist_thresh)
    if sample_mode == "roll":
        rank_to_idx = compaction_permutation(valid)
    else:
        # The gather sampler draws ranks among the compacted valid rows.
        order = compaction_permutation(valid).to(torch.int64)
        p_all = torch.gather(p_all, 1, order[..., None].expand(-1, -1, 3))
        q_all = torch.gather(q_all, 1, order[..., None].expand(-1, -1, 3))
        valid = torch.gather(valid, 1, order)
        rank_to_idx = None
    n_valid = torch.sum(valid, dim=-1)
    w = valid.to(torch.float32)[..., None]
    denom = torch.clamp_min(ordered_sum(w, dim=-2), 1.0)
    c0 = ordered_sum((p_all + q_all) * 0.5 * w, dim=-2) / denom  # [B, 3]
    p_all = torch.where(valid[..., None], p_all - c0[:, None, :], 0.0)
    q_all = torch.where(valid[..., None], q_all - c0[:, None, :], 0.0)
    n_chunks = max(1, iterations // batch_size)
    pq = torch.cat([p_all, q_all], dim=-1)
    F, c = corres_features(p_all, q_all)

    use_subset = not two_mode and 0 < score_subset < m
    Fx, cx, vx = F, c, valid
    if use_subset:
        stride = max(1, m // score_subset)
        Fx, cx, vx = (x[:, ::stride][:, :score_subset].contiguous() for x in (F, c, valid))
        n_top = min(rescore_top, batch_size)

    chunk = chunk_bits_shape(m, batch_size, sample_mode, sample_rows)
    sample_bits = checked_bits("sample_bits", sample_bits, (b, n_chunks) + chunk, generator, dev)
    max_extra = extra_chunk_count(iterations, adapt_iterations, batch_size)
    if max_extra > 0:
        extra_bits = checked_bits("extra_bits", extra_bits, (b, max_extra) + chunk, generator,
                                   dev)

    def fit_chunk(bits):
        kw = dict(edge_length_ratio=edge_length_ratio, approx_score=approx_score,
                  return_features=use_subset)
        if sample_mode == "roll":
            ga, gb, gc = rolled_sample_gathers(bits, pq, n_valid, batch_size,
                                               rank_to_idx=rank_to_idx)
            return fit_score_gathers(ga, gb, gc, Fx, cx, vx, thresh_sq, **kw)
        triples = sample_distinct_triples(bits, n_valid)
        return sample_fit_score(pq, Fx, cx, vx, triples, thresh_sq, **kw)

    def finalize(T, count):
        """Refit on the inliers and un-shift: T [B, 4, 4], or [B, n, 4, 4]
        with the correspondences broadcast over the n modes (one call for
        all modes)."""
        lead = T.shape[:-2]
        one = (b,) + (1,) * (len(lead) - 1)

        def per_mode(x):
            return x.reshape(one + x.shape[1:]).expand(lead + x.shape[1:])

        count = torch.clamp_min(count, 0)
        if refit:
            T, count = refit_inliers(T, count, per_mode(p_all), per_mode(q_all),
                                     per_mode(valid), thresh_sq)
        # T_world = Shift(c0) . T_centered . Shift(-c0).
        c = c0.reshape(one + (3,))
        T = T.clone()
        T[..., :3, 3] = T[..., :3, 3] + c - small_matvec(T[..., :3, :3], c)
        return T, count

    def run(chunk_fn, carry, count_of):
        """The fixed chunks, then the adaptive extension (JAX's ``extend``)."""
        for ch in range(n_chunks):
            carry = chunk_fn(carry, sample_bits[:, ch])
        if max_extra == 0:
            return carry
        log1mc = np.float32(np.log(max(1.0 - confidence, 1e-12)))
        active = torch.ones(b, dtype=torch.bool, device=dev)
        for j in range(max_extra):
            # N = log(1-c) / log(1-w^3) in fp32, +inf at w = 0 (run to the cap).
            wv = torch.clamp(count_of(carry).to(torch.float32)
                             / torch.clamp_min(n_valid.to(torch.float32), 1.0), 0.0, 1.0)
            w3 = torch.clamp(wv * wv * wv, 0.0, 0.999999)
            needed = torch.full_like(w3, log1mc) / torch.clamp_max(torch.log1p(-w3), -1e-12)
            done_h = np.float32(iterations) + np.float32(j) * np.float32(batch_size)
            active = active & (float(done_h) < needed)
            if not bool(torch.any(active)):
                break
            new = chunk_fn(carry, extra_bits[:, j])
            carry = tuple(torch.where(active.reshape((b,) + (1,) * (x.ndim - 1)), x_new, x)
                          for x_new, x in zip(new, carry))
        return carry

    eye = torch.eye(4, dtype=torch.float32, device=dev).repeat(b, 1, 1)
    none = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if not two_mode:
        def chunk1(carry, bits):
            best_T, best_count = carry
            if use_subset:
                R, t, counts, H, e = fit_chunk(bits)
                # Stage 2: exact rescore of the subset top-n_top over every
                # correspondence.  A stable descending sort keeps ties in
                # index order, as lax.top_k does; -1 (checker failures)
                # stays -1.
                top_c, top_i = torch.sort(counts, dim=-1, descending=True, stable=True)
                top_c, top_i = top_c[:, :n_top], top_i[:, :n_top]
                H_top = torch.gather(H, 1, top_i[..., None].expand(-1, -1, H.shape[-1]))
                exact = rescore_rows(H_top, torch.gather(e, 1, top_i), F, c, valid, thresh_sq)
                exact = torch.where(top_c < 0, -1, exact)
                j = torch.argmax(exact, dim=-1)
                k, cand = _at(top_i, j), _at(exact, j)
            else:
                R, t, counts = fit_chunk(bits)
                k = torch.argmax(counts, dim=-1)
                cand = _at(counts, k)
            better = cand > best_count
            return (_where_T(better, winner_T(R, t, k), best_T),
                    torch.where(better, cand, best_count))

        return finalize(*run(chunk1, (eye, none), lambda cr: cr[1]))

    cos_thr = f32_cos_deg(mode_angle_deg)
    if n_modes > 2:
        def chunk_n(carry, bits):
            Ts, cs = carry
            newT, newc = _peaks(*fit_chunk(bits), n_modes, cos_thr)
            return _reselect(torch.cat([Ts, newT], 1), torch.cat([cs, newc], 1), n_modes, cos_thr)

        carry = (eye[:, None].repeat(1, n_modes, 1, 1), none[:, None].repeat(1, n_modes))
        return finalize(*run(chunk_n, carry, lambda cr: cr[1][:, 0]))

    def chunk2(carry, bits):
        T1, c1, T2, c2 = carry
        R, t, counts = fit_chunk(bits)
        ka = torch.argmax(counts, dim=-1)
        Ta, ca = winner_T(R, t, ka), _at(counts, ka)
        far = torch.where(rot_cos_planar(Ta, R) < cos_thr, counts, -1)
        kb = torch.argmax(far, dim=-1)
        Tb, cb = winner_T(R, t, kb), _at(far, kb)
        T1, c1, T2, c2 = _merge(T1, c1, T2, c2, Ta, ca, cos_thr)
        return _merge(T1, c1, T2, c2, Tb, cb, cos_thr)

    T1, c1, T2, c2 = run(chunk2, (eye, none, eye, none), lambda cr: cr[1])
    return finalize(torch.stack([T1, T2], 1), torch.stack([c1, c2], 1))


def batched_ransac(
    mesh,
    p_batch: torch.Tensor,
    q_batch: torch.Tensor,
    valid_batch: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    iterations: int = 4096,
    batch_size: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Register a batch of pairs, the pair axis sharded over the mesh.

    Args:
      mesh: a ``parallel.mesh.Mesh``; P must be a multiple of its pair axis.
      p_batch, q_batch: [P, M, 3] correspondence points; valid_batch [P, M].
      sample_bits: [P, n_chunks, m_s] (``ransac_pair_step``'s roll-sampler
        bits, one row a pair: JAX's per-pair key), drawn from ``generator``
        when None.  Each shard runs ``ransac_pair_step`` on its own pairs'
        bits, so a pair's result does not depend on the mesh.

    Returns (T [P, 4, 4], fitness [P] = count / max(n_valid, 1)) on the
    mesh's home device.
    """
    b, m = valid_batch.shape
    n_chunks = max(1, iterations // batch_size)
    sample_bits = checked_bits("sample_bits", sample_bits,
                               (b, n_chunks) + chunk_bits_shape(m, batch_size), generator, "cpu")

    def shard(dev, p, q, v, bits):
        return ransac_pair_step(p, q, v, bits, dist_thresh=dist_thresh, iterations=iterations,
                                batch_size=batch_size)

    Ts, counts = map_shards(mesh.line(PAIR_AXIS), shard, p_batch, q_batch, valid_batch,
                            sample_bits, out=2)
    n_valid = torch.clamp_min(torch.sum(valid_batch.to(torch.int32), dim=1), 1).to(counts.device)
    return Ts, counts.to(torch.float32) / n_valid.to(torch.float32)
