"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the program, and
nothing reads the JAX package's own benchmarks."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & {"repro_torch", "perfbench"}


def test_prefix_names_are_told_apart(tmp_path):
    assert imported_tops(PKG / "snn.py") >= {"torch", "numpy", "perfbench"}
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.engine\nfrom repro_torch import k\n")
    assert imported_tops(probe) == {"repro_torch"}
