"""The gate arithmetic against the batch gate's closed form (rotation error
by arccos of the trace, alignment RMSE from the cloud's moments) and
against moving the cloud."""

import numpy as np
import pytest

from perfbench.lib import gate


def _pose(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    T[:3, 3] = rng.uniform(-1, 1, 3)
    return T


def _closed_form(T_all, T_true, pts):
    """The batch gate as the repository's benchmark writes it."""
    M_all = T_all[:, :3, :3] @ T_true[:3, :3].T
    tr = np.clip((np.trace(M_all, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot = np.degrees(np.arccos(tr))
    mu = pts.mean(axis=0)
    M2 = pts.T @ pts / pts.shape[0]
    A = T_all[:, :3, :3] - T_true[:3, :3]
    b = T_all[:, :3, 3] - T_true[:3, 3]
    sq = (np.einsum("bij,jk,bik->b", A, M2, A) + 2.0 * np.einsum("bi,bij,j->b", b, A, mu)
          + (b * b).sum(1))
    return rot, np.sqrt(np.maximum(sq, 0.0))


@pytest.mark.parametrize("deg", [0.5, 3.0, 30.0, 120.0])
def test_gate_matches_the_closed_form(deg):
    rng = np.random.default_rng(int(deg * 10))
    pts = rng.normal(size=(2000, 3)) * [5.0, 3.0, 1.0]
    T_true = _pose(rng, 20.0)
    T_all = np.stack([_pose(rng, deg) @ T_true for _ in range(8)])
    rot_ref, rmse_ref = _closed_form(T_all, T_true, pts)
    mu, M2 = gate.moments(pts)
    assert np.allclose(gate.rotation_deg(T_all, T_true[None]), rot_ref, atol=1e-6)
    assert np.allclose(gate.alignment_rmse(T_all, T_true[None], mu, M2), rmse_ref, rtol=1e-9)
    moved_a = pts @ T_all[:, :3, :3].transpose(0, 2, 1) + T_all[:, None, :3, 3]
    moved_b = pts @ T_true[:3, :3].T + T_true[:3, 3]
    direct = np.sqrt(((moved_a - moved_b) ** 2).sum(-1).mean(-1))
    assert np.allclose(gate.alignment_rmse(T_all, T_true[None], mu, M2), direct, rtol=1e-9)


def test_rotation_keeps_digits_below_a_micro_degree():
    rng = np.random.default_rng(3)
    T = _pose(rng, 0.0)
    assert gate.rotation_deg(_pose(np.random.default_rng(3), 1e-7), T) > 0.0
    assert np.isclose(gate.rotation_deg(_pose(np.random.default_rng(3), 1e-7) @ T, T), 1e-7,
                      rtol=1e-3)


def test_gate_misses_flags_outside_and_non_finite_poses():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(500, 3))
    mu, M2 = gate.moments(pts)
    T_true = _pose(rng, 10.0)
    good = _pose(rng, 0.5) @ T_true
    good[:3, 3] = T_true[:3, 3]
    far = _pose(rng, 60.0) @ T_true
    bad = np.full((4, 4), np.nan)
    rot, rmse, missed = gate.gate_misses(np.stack([good, far, bad]), T_true[None], mu, M2,
                                         2.0, 0.1)
    assert missed.tolist() == [False, True, True]
    assert rot[2] == np.inf and rmse[2] == np.inf
