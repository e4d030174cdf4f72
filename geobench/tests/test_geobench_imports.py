"""Nothing under geobench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(b, f) for b, _, fs in os.walk(HERE) for f in fs if f.endswith(".py"))


def imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_a_plain_reference(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "mosaic_tpu"}, tops
    if os.path.relpath(path, HERE).startswith("reference"):
        assert "mosaic_tpu_torch" not in tops
        assert tops <= {"__future__", "numpy", "torch"}, tops


def test_the_check_compares_whole_names():
    assert "mosaic_tpu_torch".split(".")[0] != "mosaic_tpu"
