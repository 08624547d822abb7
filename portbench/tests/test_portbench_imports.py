"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name
(the part before the first dot) compared whole."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(p for p in HERE.rglob("*.py"))
REFERENCE = sorted((HERE / "reference").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "amps_tpu"}


def top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_names(path))
    assert names <= {"__future__", "functools", "math", "numpy", "torch",
                     "portbench"}, names
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_the_port_name_is_not_the_jax_package():
    # the port's name begins with the JAX package's: the check compares
    # the whole top-level name
    assert "amps_tpu_torch".split(".")[0] not in FORBIDDEN
