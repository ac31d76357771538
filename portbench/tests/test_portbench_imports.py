"""Nothing under portbench/ imports JAX, the JAX package or bench.py; the
plain reference imports nothing of the program."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "amrvolumerenderer_tpu", "bench"}
MODULES = sorted(p for p in ROOT.rglob("*.py"))


def imported(path: pathlib.Path):
    """Top-level names of every module ``path`` imports (the part before
    the first dot, whole); relative imports give none."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not imported(path) & (FORBIDDEN | {"amrvolumerenderer_torch", "portbench"})


def test_names_are_compared_whole():
    assert "amrvolumerenderer_torch" not in FORBIDDEN
    assert imported(pathlib.Path(__file__)) & FORBIDDEN == set()
