"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
# the yardstick: the generator, the reference, the comparison, the
# trace reading and the work and peaks of the rooflines
YARDSTICK = ("generator.py", "reference.py", "compare.py", "tracing.py",
             "metrics/_roofline.py")


def top_level_imports(path: Path) -> set:
    """Top-level names (the part before the first dot, whole) of every
    absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in HERE.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_top_level_names_are_compared_whole(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import predictionio_tpu_torch.models.als\n"
                   "from predictionio_tpu_torch import ops\n")
    assert top_level_imports(src) == {"predictionio_tpu_torch"}
    src.write_text("import jax.numpy\n")
    assert top_level_imports(src) & set(run.FORBIDDEN) == {"jax"}


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    names = top_level_imports(HERE / name)
    assert names <= {"__future__", "bisect", "dataclasses", "math",
                     "torch"}, names


def test_forbidden_modules_reads_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "predictionio_tpu_torch_x",
                        types.ModuleType("predictionio_tpu_torch_x"))
    assert "predictionio_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.version",
                        types.ModuleType("jaxlib.version"))
    assert run.forbidden_modules() == ["jaxlib"]
