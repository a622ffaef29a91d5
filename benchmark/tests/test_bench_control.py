"""The control: the plain reference in the program's place in the
precision below the configuration's (float8 towers; a bfloat16 ranking)
fails the cell's limits, here at the tiny cells' size (on the card, at
the cells' size: ``benchmark/tools/readings.py``, which calls the same
driver function)."""

import pytest
import torch

from benchmark.harness import judge, runner
from benchmark.tests import tiny


def readings_of(tmp_path, cell, seed=20241018):
    registry = tiny.registry(tmp_path)
    run = runner.Run(registry, registry.cell(cell), seed, 0.0, False, "cpu")
    got = []
    registry.driver(run.kind).readings(run, seed, True, False, got.append)
    return run, {r["what"]: r["numbers"] for r in got}


def test_the_train_control_fails_and_the_program_passes(tmp_path):
    run, numbers = readings_of(tmp_path, "tiny-rn50.train")
    assert judge.hold(numbers["program"], run.limits)["correct"]
    assert not judge.hold(numbers["control_fp8"], run.limits)["correct"]


def test_the_eval_control_fails_and_the_program_passes(tmp_path):
    run, numbers = readings_of(tmp_path, "tiny-rn50.eval")
    assert judge.hold(numbers["program"], run.limits)["correct"]
    assert not judge.hold(numbers["control_fp8_bf16"],
                          run.limits)["correct"]


def test_grad_gap_leaves_out_the_named_leaves():
    still = {n: torch.zeros(4, dtype=torch.bool) for n in "abc"}
    want = {"loss": [1.0], "still": still, "queue": torch.ones(2, 3),
            "grad": {n: torch.ones(4) for n in "abc"},
            "delta": {n: torch.ones(4) for n in "abc"}}
    got = {**want, "grad": {"a": torch.ones(4), "b": 1.01 * torch.ones(4),
                            "c": 3.0 * torch.ones(4)}}
    assert judge.train_numbers(got, want)["grad_gap"] == pytest.approx(2.0)
    numbers = judge.train_numbers(got, want, {"grad_gap": ["c"]})
    assert numbers["grad_gap"] == pytest.approx(0.01)
    with pytest.raises(KeyError):
        judge.train_numbers(got, want, {"grad_gap": ["no.such.leaf"]})
