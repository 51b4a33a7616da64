"""Nothing under zfbench/ imports JAX or the JAX package (compared by whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

ZF = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in ZF.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ZF)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in SOURCES if "reference" in p.relative_to(ZF).parts]
    assert ref
    for p in ref:
        assert "repro_torch" not in top_level_imports(p), p
        assert not top_level_imports(p) & FORBIDDEN, p


def test_the_forbidden_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.data\nfrom repro.core import plan\n")
    assert top_level_imports(f) & FORBIDDEN == {"repro"}


def test_the_run_refuses_a_loaded_jax(monkeypatch):
    import types

    from zfbench.lib import harness

    for name in ("jax", "repro"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "repro_torch", types.ModuleType("repro_torch"))
    assert {"jax", "repro"} <= set(harness.jax_loaded())
    assert "repro_torch" not in harness.jax_loaded()
