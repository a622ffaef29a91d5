"""Whole runs of tiny cells on the CPU (the look for a card skipped): the
result line's schema, the numbers printed beside their limits, and
``correct`` coming out false under each planted fault and under the
control."""

import json
import math

import pytest

from benchmark.harness import runner
from benchmark.harness.registry import BENCH_DIR, REPO_ROOT, Registry
from benchmark.tests import tiny

CELLS = {"train": ["tiny-rn50.train", "tiny-vit.train"],
         "evaluate": ["tiny-rn50.eval"]}
DRIVERS = Registry()
SEED = "3000000019"  # above 2**31


def run(tmp_path, capsys, cell, hooks=None, trace=0):
    registry = tiny.registry(tmp_path)
    rc = runner.main(["--workload", cell, "--seed", SEED, "--seconds", "0.5",
                      "--trace", str(trace)], device="cpu",
                     registry=registry, hooks=hooks)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell", CELLS["train"] + CELLS["evaluate"])
def test_a_run_prints_the_result_line(tmp_path, capsys, cell):
    rc, line, err = run(tmp_path, capsys, cell)
    assert rc == 0 and line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
        assert math.isfinite(metric["value"])
    assert "setup_s" in line["metrics"]
    lines = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, check) in zip(lines, line["checks"].items()):
        assert text.startswith(f"check {name}: ")
        assert check["value"] <= check["limit"]


def test_a_traced_run_prints_per_layer_metrics(tmp_path, capsys):
    rc, line, _ = run(tmp_path, capsys, "tiny-rn50.eval", trace=1)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"eval.encode_s", "eval.rank_s"}


@pytest.mark.parametrize("kind, fault", [
    (kind, name) for kind in CELLS for name in DRIVERS.driver(kind).FAULTS])
def test_each_fault_turns_correct_false(tmp_path, capsys, kind, fault):
    cell = CELLS[kind][0]
    hooks = DRIVERS.driver(kind).FAULTS[fault]
    rc, line, _ = run(tmp_path, capsys, cell, hooks)
    assert rc == 0 and line["correct"] is False


def test_a_new_kind_of_traffic_is_new_files(tmp_path, capsys):
    """A mix whose ``kind`` names a driver file the harness has not seen
    runs through it; no file that is there changes."""
    registry = tiny.registry(tmp_path)
    (tmp_path / "drivers" / "replay.py").write_text(
        (BENCH_DIR / "drivers" / "train.py").read_text())
    (tmp_path / "traffic" / "replay.json").write_text(json.dumps(
        {**tiny.TRAIN, "kind": "replay"}))
    (tmp_path / "limits" / "tiny-rn50.replay.json").write_text(json.dumps(
        {"limits": tiny.TRAIN_LIMITS}))
    bench = registry.benchmark
    bench["workloads"].append({"name": "tiny-rn50.replay",
                               "config": "tiny-rn50", "traffic": "replay",
                               "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-rn50.train" in m.get("workloads", []):
            m["workloads"].append("tiny-rn50.replay")
    rc = runner.main(["--workload", "tiny-rn50.replay", "--seed", SEED,
                      "--seconds", "0.5", "--trace", "0"], device="cpu",
                     registry=registry)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert "train_img_per_s" in line["metrics"]
    assert not (REPO_ROOT / "benchmark" / "drivers" / "replay.py").exists()


def test_no_card_means_no_result(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(runner.torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "rn50-gru.train.bs128", "--seed", "1",
                      "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
