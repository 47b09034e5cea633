"""No module of the benchmark, the kinds among them, imports JAX, Flax
or the JAX package, and the reference imports nothing of the program.
Top-level names are compared whole: `repro_torch` is the program, `repro`
the JAX package."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(PB.rglob("*.py"))


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_names(path) & BANNED


@pytest.mark.parametrize(
    "path", sorted((PB / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(PB)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = _top_names(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "torch", "numpy", "math"}


def test_the_guard_covers_every_kind():
    """Kinds may import the program; the guard reads each of them."""
    kinds = sorted((PB / "kinds").glob("*.py"))
    assert PB / "kinds" / "blobs.py" in kinds
    assert set(kinds) <= set(FILES)


def test_the_guard_sees_a_banned_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n"
                   "import repro_torch\n")
    assert _top_names(bad) & BANNED == {"repro", "jax"}


def test_the_run_s_module_check_compares_whole_names():
    from portbench.harness import banned_modules

    assert banned_modules(["repro_torch.core.session", "numpy",
                           "reprolint", "jaxtyping"]) == []
    assert banned_modules(["repro.core", "jaxlib.xla_client", "flax",
                           "repro_torch"]) == ["flax", "jaxlib", "repro"]
