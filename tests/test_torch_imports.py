"""The port imports torch and never JAX: no module of ``lattigo_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` (or a submodule of it) or the
JAX package ``lattigo_tpu`` (or a module of it), at top level or inside a
function.  Parsed with ``ast``, so a string that names them does not count."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lattigo_tpu_torch")
FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    + [os.path.join(ROOT, "chip_smoke.py")]
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lattigo_tpu")


def imported(path: str) -> list[str]:
    """Every module name ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


def test_the_rule_is_checked_on_the_port():
    assert len(FILES) > 40 and os.path.join(PORT, "parallel", "cross_ntt.py") in FILES


def test_the_bench_and_example_twins_are_checked():
    for rel in ("bench.py", "examples/ckks_sigmoid.py", "examples/dbfv_pir.py"):
        assert os.path.join(PORT, *rel.split("/")) in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [n for n in imported(path) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_check_sees_each_form(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import jax\nfrom jax import numpy\nimport lattigo_tpu.ops.ring as r\n"
                    "from lattigo_tpu_torch import x\ndef f():\n    import importlib\n"
                    "    importlib.import_module('lattigo_tpu.models')\n")
    got = [n for n in imported(str(path)) if _forbidden(n)]
    assert got == ["jax", "jax", "lattigo_tpu.ops.ring", "lattigo_tpu.models"]
