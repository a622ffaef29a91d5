"""The readers of the program's spans (``harness/spans.py`` and the
metrics that read it) over traced runs of the tiny cells on the CPU: the
first recording holds the traced calls' spans; the result line carries
none of the span metrics off the card; on that recording, read as from a
card, the host-span metrics and ``eval.host_syncs`` are the recording's
numbers and the device-time metrics have nothing to read; a program
without spans leaves every reader ``None``."""

import json
import statistics
import types

import pytest

from benchmark.harness import runner
from benchmark.harness.registry import REPO_ROOT, Registry
from benchmark.tests import tiny
from textreid_torch.utils import profiling

SEED = "3000000029"  # above 2**31
MOCO = ["train.ema", "train.key_forward", "train.query_forward",
        "train.backward", "train.optimizer", "train.enqueue"]
BENCH = json.loads((REPO_ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")}
DEVICE = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms",
          "train.ema_enqueue_ms", "eval.rerank_s")
READERS = Registry()


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced_run(tmp_path, capsys, cell):
    rc = runner.main(["--workload", cell, "--seed", SEED, "--seconds", "0.3",
                      "--trace", "1"], device="cpu",
                     registry=tiny.registry(tmp_path))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    return line


def on_card(kind):
    return types.SimpleNamespace(kind=kind, on_card=True, trace=True)


def read(kind):
    return {name: READERS.reader(name)(on_card(kind))
            for name in SPAN_METRICS}


def test_the_nine_span_metrics_are_the_ones_read():
    assert set(SPAN_METRICS) == {
        "train.host_dispatch_ms", "train.forward_ms", "train.backward_ms",
        "train.optimizer_ms", "train.ema_enqueue_ms", "eval.stage_s",
        "eval.fetch_s", "eval.rerank_s", "eval.host_syncs"}
    for m in SPAN_METRICS.values():
        assert m["moves"] == ("train_img_per_s" if m["name"].startswith(
            "train.") else "eval_s")


@pytest.mark.parametrize("cell", ["tiny-rn50.train", "tiny-vit.train"])
def test_a_traced_train_run_reads_its_first_recording(tmp_path, capsys,
                                                      cell):
    line = traced_run(tmp_path, capsys, cell)
    assert not set(SPAN_METRICS) & set(line["metrics"])
    first = profiling.recordings()[0]
    steps = [s for s in first["spans"] if s["parent"] is None]
    assert len(steps) == tiny.TRAIN["traced_steps"]
    for root in steps:
        assert [s["name"] for s in first["spans"]
                if s["parent"] == root["id"]] == MOCO
    got = read("train")
    assert got["train.host_dispatch_ms"] == statistics.median(
        s["host_ms"] for s in steps)
    assert all(got[name] is None for name in DEVICE)
    assert all(got[name] is None for name in SPAN_METRICS
               if name.startswith("eval."))


def test_a_traced_evaluation_reads_its_first_recording(tmp_path, capsys):
    line = traced_run(tmp_path, capsys, "tiny-rn50.eval")
    assert not set(SPAN_METRICS) & set(line["metrics"])
    first = profiling.recordings()[0]
    names = [s["name"] for s in first["spans"] if s["parent"] is None]
    assert names == ["eval.encode", "eval.rank"]
    encode = first["spans"][0]

    def host_s(name):
        return sum(s["host_ms"] for s in first["spans"]
                   if s["name"] == name and s["root"] == encode["id"]) / 1e3

    batches = sum(s["name"] == "eval.stage" for s in first["spans"])
    got = read("evaluate")
    assert got["eval.stage_s"] == pytest.approx(host_s("eval.stage"))
    assert got["eval.fetch_s"] == pytest.approx(host_s("eval.fetch"))
    assert got["eval.stage_s"] + got["eval.fetch_s"] <= \
        encode["host_ms"] / 1e3
    # two embeddings a batch; 4 grid columns, each one copy; 5 matrices
    assert got["eval.host_syncs"] == 2 * batches + 4 + 5
    assert got["eval.rerank_s"] is None
    assert all(got[name] is None for name in SPAN_METRICS
               if name.startswith("train."))


def test_a_program_without_spans_reads_none(tmp_path, capsys, monkeypatch):
    """The parent of the spans has no ``recordings``: every reader gives
    ``None`` and raises nothing."""
    traced_run(tmp_path, capsys, "tiny-rn50.eval")
    monkeypatch.delattr(profiling, "recordings")
    for kind in ("train", "evaluate"):
        assert set(read(kind).values()) == {None}
