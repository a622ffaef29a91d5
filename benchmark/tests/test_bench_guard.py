"""The import guard compares top-level names whole, and nothing the
benchmark runs imports JAX, the JAX package, ``bench.py`` or
``chip_smoke.py``; the plain reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import guard
from benchmark.harness.registry import BENCH_DIR, REPO_ROOT

BANNED_IMPORTS = {"jax", "jaxlib", "flax", "textreid_tpu", "bench",
                  "chip_smoke"}


@pytest.mark.parametrize("names, found", [
    (["textreid_torch", "textreid_torch.ops.gru", "torch"], []),
    (["textreid_tpu.models"], ["textreid_tpu.models"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["jaxtyping", "flaxen", "textreid_tpux"], []),
])
def test_banned_names_are_compared_whole(names, found):
    assert guard.banned_modules(names) == found


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imports_of(path)}
    assert not tops & BANNED_IMPORTS


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imports_of(path)}
    assert "textreid_torch" not in tops
    assert "harness" not in path.read_text()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness.runner, textreid_torch.engine, "
            "textreid_torch.evaluation.metrics; "
            "from benchmark.harness import guard; "
            "print(guard.banned_modules())") % str(REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
