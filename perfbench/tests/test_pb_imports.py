"""No file under perfbench/ imports JAX or the JAX package (whole top-level
names), and the plain reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu3dm"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_comparison_is_whole_names():
    # The port's name begins with the JAX package's: it is not a match.
    assert "tpu3dm_torch" not in FORBIDDEN
    assert top_level_imports(BENCH / "runners" / "batch.py").isdisjoint(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "tpu3dm_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "torch", "numpy", "math"}


def test_scan_sees_imports_inside_functions(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("def f():\n    import jax.numpy as jnp\n    from tpu3dm.core import se3\n")
    assert top_level_imports(f) == {"jax", "tpu3dm"}
