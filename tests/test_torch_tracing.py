"""The program's spans (``textreid_torch/utils/profiling.py``: ``span``,
``count``, ``recording``, ``recordings``) on the CPU: the shared no-op
context while nothing records; nesting, parents, roots and counts; the
recordings a profiler's schedule makes; the spans on the clock of
``profile_trace``'s Chrome trace; the train steps' phases and an
evaluation's spans; the buffer's cap; ``tools/profile_step.py``'s split of
the card's time by phase and its timing of the spans.  On the CPU a span
has host times alone."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from textreid_torch.config import get_default_cfg
from textreid_torch.engine import (
    compute_embeddings,
    create_train_state,
    make_train_step,
)
from textreid_torch.evaluation.metrics import evaluation
from textreid_torch.models import build_model
from textreid_torch.solver import make_optimizer
from textreid_torch.tools import profile_step
from textreid_torch.utils import profiling

BATCH = 8
MOCO = ["train.ema", "train.key_forward", "train.query_forward",
        "train.backward", "train.optimizer", "train.enqueue"]
SIMPLE = ["train.query_forward", "train.backward", "train.optimizer"]
NS = 1e-6  # ms: the trace's microseconds since the epoch round below it


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def children(rec, parent):
    return [s for s in rec["spans"] if s["parent"] == parent["id"]]


def roots(rec):
    return [s for s in rec["spans"] if s["parent"] is None]


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    first = profiling.span("a")
    assert first is profiling.span("b")
    with first as got:
        profiling.count("n")
        with profiling.span("c"):
            pass
    assert got is None
    assert profiling.recordings() == []


def test_nesting_gives_parents_a_shared_root_and_counts():
    with profiling.recording():
        with profiling.span("step"):
            with profiling.span("a"):
                profiling.count("n", 2)
                with profiling.span("a.inner"):
                    profiling.count("n")
            with profiling.span("b"):
                pass
            profiling.count("m")
        with profiling.span("step"):
            pass
    with profiling.span("after"):
        pass
    [rec] = profiling.recordings()
    assert rec["dropped"] == 0
    step, a, inner, b, step2 = rec["spans"]
    assert [s["name"] for s in rec["spans"]] == ["step", "a", "a.inner", "b",
                                                 "step"]
    assert step["parent"] is None and step["root"] == step["id"]
    assert a["parent"] == b["parent"] == step["id"]
    assert inner["parent"] == a["id"]
    assert {s["root"] for s in (step, a, inner, b)} == {step["id"]}
    assert step2["parent"] is None and step2["root"] == step2["id"] != \
        step["id"]
    assert a["counts"] == {"n": 2} and inner["counts"] == {"n": 1}
    assert step["counts"] == {"m": 1} and b["counts"] == {}
    for s in rec["spans"]:
        assert s["device_ms"] is None and s["device_start_ns"] is None
        assert s["end_ns"] >= s["start_ns"]
        assert s["host_ms"] == (s["end_ns"] - s["start_ns"]) / 1e6
    for outer, kid in ((step, a), (a, inner), (step, b)):
        assert outer["start_ns"] <= kid["start_ns"] <= kid["end_ns"] \
            <= outer["end_ns"]


def test_recordings_follow_the_profilers_schedule():
    """A schedule's warm-up call records nothing, its active calls one
    recording; a second capture and a ``recording()`` block one each."""
    calls = iter(range(100))

    def call():
        with profiling.span(f"call{next(calls)}"):
            torch.ones(4) * 2

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=2,
                                       repeat=1)) as prof:
            for _ in range(3):
                call()
                prof.step()
    call()
    with profiling.recording():
        call()
    got = [[s["name"] for s in rec["spans"]]
           for rec in profiling.recordings()]
    assert got == [["call1", "call2"], ["call4", "call5"], ["call7"]]


def test_spans_lie_on_the_trace_clock(tmp_path):
    """``profile_trace`` writes the spans on a track of their own; each
    holds the aten calls run inside it, and the user annotation its
    ``record_function`` made."""
    with profiling.profile_trace(str(tmp_path)):
        with profiling.span("outer"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
            with profiling.span("inner"):
                x = x + 1
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    track = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(track) == {"outer", "inner"}
    assert all(e["pid"] == profiling.SPAN_PID and e["tid"] == "host"
               for e in track.values())
    annotations = {e["name"] for e in events
                   if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= annotations
    [rec] = profiling.recordings()
    base = trace["baseTimeNanoseconds"]
    for s in rec["spans"]:
        assert track[s["name"]]["ts"] == pytest.approx(
            (s["start_ns"] - base) / 1e3)

    def within(op, name):
        e = next(e for e in events if e.get("cat") == "cpu_op"
                 and e["name"] == op)
        span = track[name]
        return (span["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= span["ts"] + span["dur"])

    assert within("aten::mm", "outer") and within("aten::add", "inner")
    assert not within("aten::mm", "inner")


def tiny_cfg(head: str, accum: int):
    """A 2-layer ViT and a 2-layer text transformer, 32 wide, at 32x16."""
    cfg = get_default_cfg()
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 32, 16
    cfg.MODEL.NUM_CLASSES = 8
    cfg.MODEL.EMBEDDING.EMBED_HEAD = head
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.MOCO.K = 16
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    cfg.MODEL.VISUAL_MODEL = "vit"
    cfg.MODEL.VIT.PATCH_SIZE, cfg.MODEL.VIT.WIDTH = 8, 32
    cfg.MODEL.VIT.LAYERS, cfg.MODEL.VIT.HEADS = 2, 4
    cfg.MODEL.VIT.OUTPUT_DIM = 32
    cfg.MODEL.TEXTUAL_MODEL = "transformer"
    t = cfg.MODEL.TRANSFORMER
    t.ARCH, t.WIDTH, t.LAYERS, t.HEADS, t.OUTPUT_DIM = "", 32, 2, 4, 32
    t.VOCAB_SIZE, t.CONTEXT_LENGTH = 50, 10
    return cfg


def tiny_batch(n: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"pixels": rng.randn(n, 32, 16, 3).astype(np.float32),
            "token_ids": rng.randint(1, 50, (n, 10)).astype(np.int32),
            "lengths": rng.randint(2, 10, (n,)).astype(np.int32),
            "pids": rng.randint(0, 8, (n,)).astype(np.int32)}


@pytest.mark.parametrize("head, accum, phases", [
    ("moco", 1, MOCO), ("moco", 2, MOCO), ("simple", 1, SIMPLE),
    ("simple", 2, SIMPLE)])
def test_a_train_step_records_its_phases_in_order_under_one_root(
        head, accum, phases):
    cfg = tiny_cfg(head, accum)
    model = build_model(cfg, "cpu", train=True)
    state = create_train_state(cfg, model, make_optimizer(cfg, model), BATCH)
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(BATCH).items()}
    batch["pids"] = batch["pids"].long()
    step = make_train_step(cfg)
    step(state, batch)  # unrecorded
    with profiling.recording():
        step(state, batch)
    [rec] = profiling.recordings()
    [root] = roots(rec)
    assert root["name"] == "train.step"
    assert [s["name"] for s in children(rec, root)] == phases
    assert {s["root"] for s in rec["spans"]} == {root["id"]}
    assert len(rec["spans"]) == len(phases) + 1


@pytest.mark.parametrize("rerank, rank_spans, rank_syncs", [
    (True, ["eval.similarity", "eval.rerank", "eval.cmc_map", "eval.fetch"],
     {"eval.cmc_map": 4, "eval.fetch": 5}),
    (False, ["eval.similarity", "eval.cmc_map", "eval.fetch"],
     {"eval.cmc_map": 2, "eval.fetch": 3})])
def test_an_evaluation_records_each_batch_and_counts_host_syncs(
        rerank, rank_spans, rank_syncs):
    """Stage, forward and fetch once a batch, two copies back a batch;
    the ranking's phases, a copy for each of the grid's columns (CMC at
    1, 5, 10 and mAP together) and each matrix."""
    cfg = tiny_cfg("moco", 1)
    model = build_model(cfg, "cpu")
    batches = []
    for i in range(3):
        b = tiny_batch(4, seed=i)
        b.update(valid=np.array([True, True, True, i < 2]),
                 index=np.arange(4 * i, 4 * i + 4),
                 image_ids=np.arange(4 * i, 4 * i + 4) // 2)
        batches.append(b)
    with profiling.recording():
        embeds = compute_embeddings(model, batches)
        evaluation(embeds["v_embed"], embeds["t_embed"], embeds["pids"],
                   embeds["pids"], embeds["image_ids"], rerank=rerank)
    [rec] = profiling.recordings()
    encode, rank = roots(rec)
    assert (encode["name"], rank["name"]) == ("eval.encode", "eval.rank")
    batch_spans = children(rec, encode)
    assert [s["name"] for s in batch_spans] == [
        "eval.stage", "eval.forward", "eval.fetch"] * len(batches)
    assert [s["counts"] for s in batch_spans] == [
        {}, {}, {"host_syncs": 2}] * len(batches)
    assert [s["name"] for s in children(rec, rank)] == rank_spans
    assert {s["name"]: s["counts"]["host_syncs"]
            for s in children(rec, rank) if s["counts"]} == rank_syncs


def test_the_buffer_keeps_the_newest_spans_and_counts_the_dropped(
        monkeypatch):
    monkeypatch.setattr(profiling, "_TRACER", profiling.Tracer(cap=3))
    with profiling.recording():
        for i in range(4):
            with profiling.span(f"first{i}"):
                pass
    with profiling.recording():
        with profiling.span("second"):
            pass
    first, second = profiling.recordings()
    assert [s["name"] for s in first["spans"]] == ["first2", "first3"]
    assert first["dropped"] == 2
    assert [s["name"] for s in second["spans"]] == ["second"]
    assert second["dropped"] == 0


def test_profile_step_splits_the_cards_time_by_phase(tmp_path):
    """Kernels (as a card's trace holds them) go to the span holding their
    launch, each idle gap to the span holding its start; a launch outside
    every span to ``OUTSIDE``."""
    def fn():
        with profiling.span("train.step"):
            with profiling.span("train.a"):
                torch.ones(8) * 2
            with profiling.span("train.b"):
                torch.ones(8) + 1

    out = str(tmp_path / "trace")
    profile_step.capture(fn, 2, out, {"device": "cpu"})
    path = tmp_path / "trace" / "trace.json"
    trace = json.loads(path.read_text())
    track = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    a = [e for e in track if e["name"] == "train.a"]
    b = [e for e in track if e["name"] == "train.b"]
    assert len(a) == len(b) == 2
    end = max(e["ts"] + e["dur"] for e in trace["traceEvents"]
              if "dur" in e)
    # a kernel over the first half of each span, launched in its middle
    kernels = [(e["ts"], e["dur"] / 2, e["ts"] + e["dur"] / 2)
               for pair in zip(a, b) for e in pair]
    kernels.append((end + 10.0, 4.0, end + 5.0))
    for i, (ts, dur, launch) in enumerate(kernels):
        trace["traceEvents"] += [
            {"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts,
             "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": i}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 0.1, "pid": 1, "tid": 1,
             "args": {"correlation": i}}]
    path.write_text(json.dumps(trace))
    got = profile_step.summarize(out)["phases"]
    assert set(got) == {"train.a", "train.b", profile_step.OUTSIDE}
    for name, spans in (("train.a", a), ("train.b", b)):
        assert got[name]["device_ms"] == pytest.approx(
            sum(e["dur"] / 2 for e in spans) / 1e3 / 2, abs=NS)
        assert got[name]["launches"] == 1.0
    starts = [k[0] for k in kernels]
    ends = [k[0] + k[1] for k in kernels]
    # the gaps begin in a, b, a, b: half a span's length in, each
    assert got["train.a"]["idle_ms"] == pytest.approx(
        (starts[1] - ends[0] + starts[3] - ends[2]) / 1e3 / 2, abs=NS)
    assert got["train.b"]["idle_ms"] == pytest.approx(
        (starts[2] - ends[1] + starts[4] - ends[3]) / 1e3 / 2, abs=NS)
    assert got[profile_step.OUTSIDE] == {
        "device_ms": pytest.approx(4.0 / 1e3 / 2), "launches": 0.5,
        "idle_ms": 0.0}


def test_profile_step_times_the_steps_with_spans_off_and_on():
    calls = []

    def fn():
        with profiling.span("train.step"):
            with profiling.span("train.a"):
                calls.append(1)

    got = profile_step.time_spans(fn, 3)
    assert len(got["off_ms"]) == len(got["on_ms"]) == profile_step.SPAN_ROUNDS
    assert len(calls) == 2 * profile_step.SPAN_ROUNDS * 3
    assert list(got["spans"]) == ["train.step", "train.a"]
    step, a = got["spans"]["train.step"], got["spans"]["train.a"]
    assert step["device_ms"] is None and a["device_ms"] is None
    assert step["host_ms"] >= a["host_ms"] > 0.0


EVAL_SPANS = ["eval.encode", "eval.stage", "eval.forward", "eval.fetch",
              "eval.rank", "eval.similarity", "eval.rerank", "eval.cmc_map"]


def test_profile_step_eval_times_each_span_of_an_evaluation(monkeypatch,
                                                            capsys):
    """``profile_step --eval --spans``: each of the evaluation's spans
    with its host ms (and no device ms on the CPU), an evaluation a
    call; ``build_eval`` stood in for by the tiny model."""
    cfg = tiny_cfg("moco", 1)
    model = build_model(cfg, "cpu")
    batches = profile_step.test_batches(10, 5, 3, 4, 32, 16, 10, vocab=50)
    assert [len(b["index"]) for b in batches] == [4, 4, 4]
    assert [int(b["valid"].sum()) for b in batches] == [4, 4, 2]
    built = []

    def build_eval(variant, fused, device):
        built.append((variant, fused, device))
        return profile_step.eval_call(model, batches, "cpu"), {}

    monkeypatch.setattr(profile_step, "build_eval", build_eval)
    got = profile_step.main(["--eval", "--spans", "--steps", "1",
                             "--device", "cpu"])
    assert built == [("", False, "cpu")]
    assert list(got["spans"]) == EVAL_SPANS
    for name, row in got["spans"].items():
        assert row["host_ms"] > 0.0 and row["device_ms"] is None
    encode = got["spans"]["eval.encode"]["host_ms"]
    assert sum(got["spans"][n]["host_ms"] for n in
               ("eval.stage", "eval.forward")) <= encode
    printed = capsys.readouterr().out
    assert "ms a evaluation" not in printed and "ms an evaluation" in printed
    for name in EVAL_SPANS:
        assert f"  {name}\n" in printed


def test_build_eval_runs_test_nets_evaluation_of_the_flagship():
    """The flagship at its widths and input size, a split of 3 captions
    of 2 images in batches of 2: the four re-ranked grid columns and the
    matrices; an evaluation's work is not counted for the roofline."""
    fn, meta = profile_step.build_eval("", False, "cpu", batch_size=2,
                                       captions=3, images=2)
    assert meta["evaluation"] and (meta["height"], meta["width"]) == (384,
                                                                      128)
    with profiling.recording():
        got = fn()
    assert {"t2i", "i2t", "re_t2i", "re_i2t", "rvn_mat",
            "rtn_mat"} <= set(got)
    assert got["similarity"].shape == (3, 2)
    [rec] = profiling.recordings()
    assert [s["name"] for s in rec["spans"]].count("eval.forward") == 2
    assert profile_step.analytic_work(meta, {"K5": 12.0}) == {}
