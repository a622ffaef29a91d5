"""On the card only: one short run of each cell comes out correct.  Run
there with ``python -m pytest -m gpu benchmark/tests``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.registry import REPO_ROOT

CELLS = [w["name"] for w in json.loads(
    (REPO_ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "3", "--trace", "0"], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
