"""What the benchmark may import: nothing under ``bench/`` imports the JAX
package or JAX (top-level names compared whole: ``repro_torch`` is the
program, ``repro`` the JAX package), and the reference imports nothing
of the program."""

import ast
from pathlib import Path

import pytest

from bench.harness import core

FILES = sorted(core.BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.kernels\nfrom repro.core import x\n"
                   "import jaxtyping\n")
    assert top_level_imports(src) == {"repro_torch", "repro", "jaxtyping"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(core.ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((core.BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax"}
    assert "repro_torch" not in path.read_text()
