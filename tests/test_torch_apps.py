"""Port parity for tpu3dm_torch's crash suite (apps/crashtest.py), its
degenerate clouds (io/synthetic.py), STL and crop I/O (io/stl.py,
io/crop.py) and ``ops/nn_sparse.py:morton_perm``, on the CPU.

The host modules are NumPy copies of JAX's: their outputs must be equal
bit for bit.  Each crash case passes on the CPU, as it does in JAX; the
RANSAC cases, given JAX's own bits (its single-mode schedule: (key, k) =
split(key), bits(k, (K, 2)) a chunk), also give JAX's fitness, iteration
count and pose (within 1e-6 in fitness, 1e-3 in the pose's entries, the
bounds of tests/test_torch_pipeline.py's RANSAC test scaled for the crash
case's coordinates near 1000).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.apps import crashtest as jcrash
from tpu3dm.io import crop as jcrop
from tpu3dm.io import stl as jstl
from tpu3dm.io import synthetic as jsyn
from tpu3dm.io.ply import read_ply as j_read_ply
from tpu3dm.ops.nn_sparse import morton_perm as j_morton_perm
from tpu3dm.registration.ransac import ransac_from_correspondences as j_ransac
from tpu3dm_torch.apps import crashtest
from tpu3dm_torch.io import crop, stl
from tpu3dm_torch.io import synthetic as psyn
from tpu3dm_torch.io.ply import write_ply
from tpu3dm_torch.ops.nn_sparse import morton_perm
from tpu3dm_torch.registration.ransac import chunk_count


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Degenerate clouds, morton_perm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kw", [
    ("minimal_cloud", dict(n=3, seed=0)),
    ("minimal_cloud", dict(n=50, seed=4)),
    ("collinear_cloud", dict(n=10)),
    ("coplanar_cloud", dict(n=16, seed=1)),
    ("duplicate_cloud", dict(n=10)),
    ("random_cloud", dict(n=500, scale=3.0, seed=2)),
    ("sphere_cloud", dict(n=2000, radius=1.5, seed=3)),
])
def test_degenerate_clouds_equal_jax(name, kw):
    np.testing.assert_array_equal(getattr(psyn, name)(**kw), getattr(jsyn, name)(**kw))


@pytest.mark.parametrize("bits", [4, 10])
def test_morton_perm_equals_jax(bits):
    pts = jsyn.dental_arch_cloud(3000, seed=1)
    pts[::7] = pts[3]  # ties keep their input order (stable sort)
    np.testing.assert_array_equal(morton_perm(pts, bits), j_morton_perm(pts, bits))
    np.testing.assert_array_equal(morton_perm(psyn.duplicate_cloud(9)),
                                  j_morton_perm(jsyn.duplicate_cloud(9)))


# ---------------------------------------------------------------------------
# STL and crop I/O
# ---------------------------------------------------------------------------


def _mesh():
    """Four triangles of a tetrahedron sharing vertices, with facet normals."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    return v[tris], np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])


def _write_binary(path, header=b"binary stl"):
    tris, normals = _mesh()
    with open(path, "wb") as f:
        f.write(header.ljust(80, b" "))
        f.write(np.uint32(len(tris)).tobytes())
        for t, nrm in zip(tris, normals):
            f.write(nrm.astype("<f4").tobytes() + t.astype("<f4").tobytes() + b"\0\0")


def _write_ascii(path, with_normals=True):
    tris, normals = _mesh()
    lines = ["solid tet"]
    for t, nrm in zip(tris, normals):
        lines.append("facet normal %g %g %g" % tuple(nrm) if with_normals else "facet")
        lines.append("outer loop")
        lines += ["vertex %r %r %r" % tuple(float(x) for x in p) for p in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid tet")
    path.write_text("\n".join(lines) + "\n")


def _assert_meshes_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("kind", ["binary", "binary_named_solid", "ascii", "ascii_no_normals"])
def test_read_stl_equals_jax(tmp_path, kind):
    path = tmp_path / "m.stl"
    if kind == "binary":
        _write_binary(path)
    elif kind == "binary_named_solid":
        _write_binary(path, header=b"solid but binary")
    else:
        _write_ascii(path, with_normals=kind == "ascii")
    got = stl.read_stl(path)
    _assert_meshes_equal(got, jstl.read_stl(path))
    assert got["vertices"].shape == (4, 3) and got["triangles"].shape == (4, 3)
    np.testing.assert_array_equal(stl.stl_to_point_cloud(path), jstl.stl_to_point_cloud(path))


@pytest.mark.parametrize("payload", [b"tiny", b"\0" * 80 + np.uint32(5).tobytes() + b"\0" * 60,
                                     b"solid x\nendsolid x\n",
                                     b"solid x\nvertex 0 0 0\nvertex 1 0 0\nendsolid x\n"])
def test_read_stl_rejects_what_jax_rejects(tmp_path, payload):
    path = tmp_path / "bad.stl"
    path.write_bytes(payload)
    with pytest.raises(jstl.StlError) as jerr:
        jstl.read_stl(path)
    with pytest.raises(stl.StlError) as perr:
        stl.read_stl(path)
    assert str(perr.value) == str(jerr.value)
    assert issubclass(stl.StlError, ValueError)


@pytest.mark.parametrize("kw", [dict(bounds=[-2, 2, -6, -1, -1, 1]), dict(fraction=0.3),
                                dict(fraction=0.5, axis=2), dict(bounds=[50, 60, 50, 60, 50, 60])])
def test_crop_points_equals_jax(kw):
    pts = jsyn.dental_arch_cloud(2000, seed=5)
    np.testing.assert_array_equal(crop.crop_points(pts, **kw), jcrop.crop_points(pts, **kw))
    with pytest.raises(ValueError, match="bounds or fraction"):
        crop.crop_points(pts)


@pytest.mark.parametrize("kw", [dict(fraction=0.4), dict(bounds=[50, 60, 50, 60, 50, 60])])
def test_crop_file_equals_jax(tmp_path, kw):
    """A kept count and a written cloud equal to JAX's; an empty selection
    writes the whole cloud, as JAX's (and the reference's) does."""
    pts = jsyn.dental_arch_cloud(1500, seed=6)
    src = tmp_path / "in.ply"
    write_ply(src, pts)
    n_port = crop.crop_file(src, tmp_path / "port.ply", **kw)
    n_jax = jcrop.crop_file(src, tmp_path / "jax.ply", **kw)
    assert n_port == n_jax
    np.testing.assert_array_equal(j_read_ply(tmp_path / "port.ply")["points"],
                                  j_read_ply(tmp_path / "jax.ply")["points"])
    if "bounds" in kw:
        assert n_port == len(pts)


# ---------------------------------------------------------------------------
# The crash suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", crashtest.ALL_TESTS, ids=lambda f: f.__name__)
def test_crash_case_passes_on_cpu(case):
    jres = getattr(jcrash, case.__name__)()
    res = case(torch.device("cpu"))
    assert jres.passed
    assert res.passed, res.detail
    assert res.name == jres.name


def _chunk_bits(key, max_iterations, batch_size):
    rows = []
    for _ in range(chunk_count(max_iterations, batch_size)):
        key, k = jax.random.split(key)
        rows.append(np.asarray(jax.random.bits(k, (batch_size, 2), jnp.uint32)))
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def _ransac_cases():
    """(name, p, q, valid, seed, kwargs) of every RANSAC call of the suite."""
    zero = np.zeros((64, 3), np.float32)
    cases = [("zero", zero, zero, np.zeros(64, bool), 0,
              dict(dist_thresh=0.1, max_iterations=512, batch_size=128))]
    for ratio, p, q in crashtest.noise_sweep_inputs():
        cases.append((f"noise_{ratio}", p, q, np.ones(len(p), bool), 1,
                      dict(dist_thresh=0.1, max_iterations=8192, batch_size=2048)))
    p, q = crashtest.huge_transform_inputs()
    cases.append(("huge", p, q, np.ones(len(p), bool), 2,
                  dict(dist_thresh=1.0, max_iterations=1024, batch_size=256)))
    return cases


@pytest.mark.parametrize("case", _ransac_cases(), ids=lambda c: c[0])
def test_crash_ransac_matches_jax_with_its_bits(case):
    _, p, q, valid, seed, kw = case
    key = jax.random.PRNGKey(seed)
    jres = j_ransac(jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid), key, **kw)
    bits = _chunk_bits(key, kw["max_iterations"], kw["batch_size"])
    res = crashtest._ransac(p, q, valid, torch.device("cpu"), bits, seed, **kw)
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness), atol=1e-6)
    np.testing.assert_allclose(res.transformation.numpy(), np.asarray(jres.transformation),
                               atol=1e-3)


def test_crash_inputs_equal_jax():
    """The sweep's and the huge case's inputs are those JAX's cases build
    (the same generator calls in the same order)."""
    rng = np.random.default_rng(0)
    p = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    sweep = crashtest.noise_sweep_inputs()
    np.testing.assert_array_equal(sweep[0][1], p)
    q_true = p + np.array([0.5, -0.3, 0.2], np.float32)
    for ratio, _, q in sweep:
        n_noise = int(300 * ratio / (1 + ratio))
        want = q_true.copy()
        want[:n_noise] = rng.uniform(-2, 2, (n_noise, 3))
        np.testing.assert_array_equal(q, want)
    rng = np.random.default_rng(3)
    hp = (rng.normal(size=(50, 3)) * 1000).astype(np.float32)
    np.testing.assert_array_equal(crashtest.huge_transform_inputs()[0], hp)


def test_crash_suite_main_and_device(monkeypatch):
    """main() is 0 when every case passes and 1 when one fails or raises;
    the suite runs on CUDA unless told otherwise and raises without it."""
    assert crashtest.main(["--device", "cpu"]) == 0
    monkeypatch.setattr(crashtest, "ALL_TESTS", crashtest.ALL_TESTS[:2] + [
        lambda device: crashtest.CrashResult("failing", False)])
    assert crashtest.main(["--device", "cpu"]) == 1

    def crash(device):
        raise FloatingPointError("boom")

    monkeypatch.setattr(crashtest, "ALL_TESTS", [crash])
    (res,) = crashtest.run_all_crash_tests("cpu")
    assert not res.passed and "FloatingPointError" in res.detail
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        crashtest.run_all_crash_tests()
