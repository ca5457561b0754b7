"""The port stands alone: no file of edl_tpu_torch/ and not chip_smoke.py
imports jax, flax, optax or anything of edl_tpu (an AST check, so
function-scoped imports count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "edl_tpu")
FILES = sorted((ROOT / "edl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_edl_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for mod, line in _imported(tree) if _forbidden(mod)]
    assert not bad, bad


def test_checker_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom edl_tpu.ops import pack\n"
           "import importlib\nimportlib.import_module('flax.linen')\n"
           "from edl_tpu_torch import bridge\nimport torch\n")
    found = [m for m, _ in _imported(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "edl_tpu.ops", "flax.linen"]
