"""What the harness may import and read: never JAX or the JAX package
(``repro``), compared by whole top-level module names; nothing under
``benchmarks/``; and the references nothing of the program at all."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from gpubench.lib import env

HARNESS = sorted(p for p in (env.ROOT / "gpubench").rglob("*.py")
                 if "tests" not in p.parts)
REFERENCE = sorted((env.ROOT / "gpubench" / "reference").glob("*.py"))
STDLIB = set(sys.stdlib_module_names)


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_harness_imports_no_jax(path):
    assert not imported_tops(path) & set(env.FORBIDDEN_MODULES)
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_plain_torch_only(path):
    assert imported_tops(path) <= {"torch", "numpy", "__future__"} | STDLIB


def test_forbidden_names_compare_whole():
    assert env.forbidden_loaded({"repro_torch", "repro_torch.fl",
                                 "jaxtyping", "reproducible"}) == []
    assert env.forbidden_loaded({"repro.core", "jax.numpy", "flax",
                                 "jaxlib"}) == ["flax", "jax", "jaxlib",
                                                "repro"]
