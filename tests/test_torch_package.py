"""Package rules of tpu3dm_torch: no JAX, lazy kernels, no quiet CPU fallback."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpu3dm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_chip_smoke()  # its top level imports no torch and runs nothing


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "tpu3dm"}, roots


@pytest.mark.parametrize("name", ["mesh", "ring_nn", "sharded_ransac", "register", "sharded_icp",
                                  "multipair"])
def test_parallel_modules_are_scanned(name):
    """Every module of the port's parallel/ is in the scan above."""
    assert ROOT / "tpu3dm_torch" / "parallel" / f"{name}.py" in PORT_FILES


@pytest.mark.parametrize("name", ["apps/kernelbench.py", "apps/benchmark.py", "apps/cli.py",
                                  "apps/crashtest.py", "viz/export.py", "viz/trace.py"])
def test_app_and_viz_modules_are_scanned(name):
    """Every module of the port's application layer is in the scan above."""
    assert ROOT / "tpu3dm_torch" / name in PORT_FILES


def _counterpart(path: Path) -> Path:
    """The port's module for a JAX module: the same path under
    tpu3dm_torch/, with native/ (the host C++ tier) mapped to csrc/."""
    rel = path.relative_to(ROOT / "tpu3dm")
    if rel.parts[0] == "native":
        rel = Path("csrc", *rel.parts[1:])
    return ROOT / "tpu3dm_torch" / rel


@pytest.mark.parametrize("path", sorted((ROOT / "tpu3dm").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_jax_module_has_a_port(path):
    assert _counterpart(path).exists(), _counterpart(path)


def test_import_needs_no_triton_nvcc_or_gpu():
    """Every module imports in a process where triton cannot be imported and
    neither nvcc nor a host C++ compiler can be found, and importing loads
    no JAX and builds nothing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['triton'] = None\n"
        "import tpu3dm_torch\n"
        "for m in pkgutil.walk_packages(tpu3dm_torch.__path__, 'tpu3dm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tpu3dm_torch import csrc\n"
        "assert set(csrc.KERNELS) == {'lane_nn_smalld', 'lane_mutual', 'lane_mutual_bf16_cross',\n"
        "                             'ransac_score',\n"
        "                             'ransac_score_bf16',\n"
        "                             'nn_tiled_smalld', 'nn_tiled_wide', 'nn_blocksparse',\n"
        "                             'lane_nn_wide', 'row_sums', 'p2pl_sums'}, csrc.KERNELS\n"
        "assert all(k._fn is None for k in csrc.KERNELS.values())\n"
        "assert csrc._host_lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpu3dm')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent", PYTHONPATH=str(ROOT),
               CXX="/nonexistent/c++")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means CUDA; without it an entry point raises instead of
    running on the CPU."""
    from tpu3dm_torch import resolve_device
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.fused import escalated_register_step, fused_register_step
    from tpu3dm_torch.registration.large import prepare_large_cloud, register_arrays_large

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_points(np.random.default_rng(0).normal(size=(100, 3)))
    z3 = np.zeros((1, 8, 3), np.float32)
    f = np.zeros((1, 8, 33), np.float32)
    m = np.ones((1, 8), bool)
    for kw in ({}, {"mutual_filter": False}, {"rescue_restarts": 2},
               {"mutual_filter": False, "rescue_restarts": 3, "rescue_modes": 2},
               {"nn_impl": "values_b16", "score_subset": 4, "sample_mode": "gather"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            fused_register_step(z3, f, m, z3, z3, f, m, z3, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        escalated_register_step(z3, f, m, z3, f, m, z3)
    pts = np.random.default_rng(1).normal(size=(600, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        register_arrays_large(pts, pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_large_cloud(pts)
    assert resolve_device("cpu") == torch.device("cpu")


def test_batch_entry_points_raise_without_cuda(monkeypatch):
    """The batch API and its ingest default to CUDA too."""
    from tpu3dm_torch.io.loader import voxel_downsample_many
    from tpu3dm_torch.preprocess.pipeline import preprocess_points, preprocess_points_batch
    from tpu3dm_torch.registration import batch

    pts = np.random.default_rng(2).normal(size=(400, 3))
    cloud = preprocess_points(pts, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: preprocess_points_batch([pts]),
                 lambda: voxel_downsample_many([pts], 0.3),
                 lambda: batch.register_pairs_batched([(cloud, cloud)]),
                 lambda: batch.launch_pairs_batched([(cloud, cloud)]),
                 lambda: batch.ResidentTarget(cloud)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_precision_is_full_fp32():
    import tpu3dm_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_gpu():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("row", sorted(SMOKE.SOURCES))
def test_chip_smoke_row_names_its_kernel_source_and_tpu_kernel(row):
    """A row of the smoke's kernels line names a kernel of the port (through
    ROW_KERNEL where the row times that kernel at a second shape), that
    kernel's CUDA source, and the Pallas kernel it replaces by file and line."""
    from tpu3dm_torch.csrc import KERNELS
    from tpu3dm_torch.ops import nn, nn_lane, nn_sparse, ransac_score  # noqa: F401

    kernel = KERNELS[SMOKE.ROW_KERNEL.get(row, row)]
    source, replaces = SMOKE.SOURCES[row]
    assert source == f"tpu3dm_torch/csrc/{kernel.source}"
    path, line = replaces.split(":")
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _") and "kernel" in text, text


def test_chip_smoke_has_a_row_for_every_kernel():
    from tpu3dm_torch.csrc import KERNELS
    from tpu3dm_torch.ops import nn, nn_lane, nn_sparse, ransac_score  # noqa: F401

    from tpu3dm_torch.ops import rowsum  # noqa: F401

    rows = [*SMOKE.SOURCES, *SMOKE.PORT_ONLY_SOURCES]
    assert {SMOKE.ROW_KERNEL.get(row, row) for row in rows} == set(KERNELS)


@pytest.mark.parametrize("row", sorted(SMOKE.PORT_ONLY_SOURCES))
def test_chip_smoke_port_only_row_names_its_source(row):
    """A kernel that replaces no TPU kernel names its CUDA source and says
    so in its row's "replaces"."""
    from tpu3dm_torch.csrc import KERNELS
    from tpu3dm_torch.ops import rowsum  # noqa: F401

    source, replaces = SMOKE.PORT_ONLY_SOURCES[row]
    assert source == f"tpu3dm_torch/csrc/{KERNELS[row].source}"
    assert replaces.startswith("none: port-only repair")
