"""What the benchmark may import: nothing under ``portbench/`` imports
``jax`` or the JAX package ``dips_tpu`` (top-level names compared whole:
``dips_tpu_torch`` begins with ``dips_tpu``), and the reference imports
nothing of the program either."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
MODULES = sorted(PKG.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "dips_tpu"}


def top_level_imports(path: Path) -> set:
    """Top-level names of every import in a module, at any depth of the
    code (relative imports are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_finds_the_benchmark():
    rel = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"run.py", "reference/dips.py", "drivers/engine_stream.py",
            "metrics/frames_per_s.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(PKG).as_posix() for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"dips_tpu_torch", "torch"})
    assert names <= {"__future__", "dataclasses", "typing", "numpy"}


def test_whole_names_are_compared():
    src = "import dips_tpu_torch.ops\nfrom dips_tpu_torch import x\n"
    names = {n.split(".")[0] for n in ["dips_tpu_torch.ops"]}
    assert not names & FORBIDDEN
    tree = ast.parse(src)
    assert {a.name.split(".")[0] for a in tree.body[0].names} \
        == {"dips_tpu_torch"}
