"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program. Top-level names are
compared whole: the port's name, ``ant_quantization_tpu_torch``, begins
with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ant_quantization_tpu"}
PROGRAM = "ant_quantization_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


def test_sources_found():
    assert PKG / "run.py" in SOURCES and len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_name_comparison():
    src = "import ant_quantization_tpu_torch.serve\nimport jax.numpy\n"
    tmp = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tmp)
             if isinstance(n, ast.Import) for a in n.names}
    assert names & FORBIDDEN == {"jax"}


def test_run_refuses_with_jax_loaded(monkeypatch):
    import sys
    import types
    from portbench import run
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert run.forbidden_loaded() == ["jaxlib"]
