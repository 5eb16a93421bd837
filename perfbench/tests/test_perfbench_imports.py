"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is the port and allowed), and the
plain references import nothing of the program.  The loaded modules of a
whole run are checked in ``test_perfbench_rehearsal.py``."""
import ast
from pathlib import Path

import pytest

from perfbench import harness

PB = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package(path):
    bad = set(_imports(path)) & set(harness.FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))
