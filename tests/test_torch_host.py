"""The port's host C++ library (tpu3dm_torch/csrc/host.cpp) against the JAX
package's native tier, which its host stages call by default.

The port keeps its own copy of ``t3n_kd_perm`` and ``t3n_voxel_downsample``
(it may not import ``tpu3dm.native``), built with the native tier's flags, so
KD blocks and voxel means must come out identical.  Each test first asserts
that the JAX native tier is built, so it never compares against the JAX
NumPy fallbacks by accident.
"""

import numpy as np
import pytest

import tpu3dm.native
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops import nn_sparse as jsp
from tpu3dm.preprocess.voxel import voxel_downsample_host as j_voxel
from tpu3dm_torch import csrc
from tpu3dm_torch.ops import nn_sparse as psp
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host as p_voxel
from tpu3dm_torch.preprocess.voxel import voxel_means


@pytest.fixture(scope="module", autouse=True)
def native_tier():
    """Load the JAX native tier once more if a build race left it unloaded.

    On a tree without tpu3dm/native/libtpu3dm_native.so (the library is not
    committed), every pytest-xdist worker calls ``tpu3dm.native.available()``
    while it collects tests/test_native.py, and the first call runs ``make``.
    g++ writes the library in place (native/Makefile), so a worker can load
    a half-written file; its loader then remembers the failure (``_tried``)
    and reports no native tier for the whole session, and every test here
    would fail on its first assert.  xdist sends no test before every worker
    has finished collecting, so by now every such build has ended: forget
    the failure and load the finished library.
    """
    if not tpu3dm.native.available():
        tpu3dm.native._tried = False
        tpu3dm.native._lib = None
        tpu3dm.native.lib()


@pytest.fixture(scope="module")
def cloud():
    sp, _, _ = make_benchmark_pair(300_000, seed=0, sigma=0.002)
    return sp


@pytest.mark.parametrize("n", [20_000, 300_000])  # 300k: the C++ fans out over threads
@pytest.mark.parametrize("block", [512, 256])
def test_kd_perm_equals_jax_native(cloud, n, block):
    assert tpu3dm.native.available()
    pts = cloud[:n]
    perm = psp.kd_perm(pts, block)
    np.testing.assert_array_equal(perm, jsp.kd_perm(pts, block))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))
    assert perm.dtype == np.int64


@pytest.mark.parametrize("voxel", [0.3, 0.1])
def test_voxel_means_equal_jax_native(cloud, voxel):
    """Bit for bit: the same C++ on the same float64 points."""
    assert tpu3dm.native.available()
    dj = j_voxel(cloud, voxel)
    dp = p_voxel(cloud, voxel, device="cpu")
    np.testing.assert_array_equal(dp.points.numpy(), np.asarray(dj.points))
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    assert dp.capacity == dj.capacity


def test_voxel_means_equal_jax_numpy_branch(cloud, monkeypatch):
    """The JAX package's NumPy branch computes the same means: tolerance 0,
    since both sum each voxel's float64 points in input order.  (The C++
    takes the voxel index as (x - lo) * (1 / v), NumPy as (x - lo) / v; the
    two could differ for a point within an ulp of a voxel face, which this
    cloud does not hold.)"""
    means = voxel_means(cloud, 0.3)
    monkeypatch.setattr(tpu3dm.native, "voxel_downsample", lambda *a, **k: None)
    dj = j_voxel(cloud, 0.3)
    np.testing.assert_array_equal(means, np.asarray(dj.points)[: means.shape[0]])
    assert not np.asarray(dj.mask)[means.shape[0]:].any()


def test_host_library_builds_once_and_raises_without_compiler(tmp_path, monkeypatch):
    lib = csrc.host_library()
    assert csrc.library_path(csrc.HOST_SOURCE).exists()
    assert csrc.host_library() is lib
    monkeypatch.setattr(csrc, "library_path", lambda src: tmp_path / f"{src}.so")
    monkeypatch.setattr(csrc, "_host_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="compiler"):
        csrc.host_library()
    with pytest.raises(RuntimeError, match="compiler"):
        psp.kd_perm(np.zeros((10, 3)), 4)


def test_host_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its output; nothing falls back."""
    bad = tmp_path / "host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(csrc, "SRC_DIR", tmp_path)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host.cpp"):
        csrc.build(["host.cpp"])
    assert not list((tmp_path / "build").glob("*.so"))
