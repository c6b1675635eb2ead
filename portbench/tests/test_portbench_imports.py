"""Nothing of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program. Module names are compared by their whole
top-level name (the part before the first dot): the port's name begins
with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "heat_tpu"}
PROGRAM = "heat_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_source_imports_nothing_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.knn_predict, portbench.reference.cdist, portbench.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {PROGRAM})


def test_forbidden_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "heat_tpu_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "heat_tpu.core", object())
    assert harness.forbidden_modules() == ["heat_tpu"]
