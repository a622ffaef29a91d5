"""The ``evaluate`` driver: the protocol ``textreid_torch/test_net.py`` runs
(``engine/inference.py:inference`` with ``rerank=True``), as its two
calls: ``compute_embeddings`` over the test loader's batches, then
``evaluation/metrics.py:evaluation``.  Closed loop of whole evaluations
of a synthetic test split held in host memory as the test loader yields
it (each batch copied to the card by the program, as from the loader).

``eval_s`` is the window over the evaluations completed in it.  A sample
of them, drawn from the seed, is kept and judged after the window: the
embeddings of a sample of rows against the plain reference's towers, and
the similarity and the metric grid against the reference's ranking of
the program's own embeddings."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import flops, inputs, judge, trace
from benchmark.harness.program import launch_counts, load_weights, program_cfg
from benchmark.reference import model as reference
from benchmark.reference import ranking

BLOCK = 64  # rows the reference encodes at a time
# a re-ranking term's entry off by more than this differs: its values are
# 0.05 I / (10 - I) for the I = 0..5 neighbours two top-5 lists share, at
# least 0.0056 apart, so this tells a changed list from the rounding of a
# value
TERM_TOL = 1e-3


class EvalSide:
    def __init__(self, run):
        from textreid_torch.engine import compute_embeddings
        from textreid_torch.evaluation.metrics import evaluation
        from textreid_torch.models import build_model
        from textreid_torch.utils.platform import compute_dtype

        cfg = program_cfg(run.config)
        # test_net's model: the parameters in the compute dtype, eval mode
        self.model = build_model(cfg, run.device,
                                 compute_dtype(cfg, run.device))
        load_weights(self.model, run.weights())
        self.device = run.device
        self.encode = run.hooks.get("encode", lambda f: f)(compute_embeddings)
        self.rank = run.hooks.get("rank", lambda f: f)(evaluation)

    def evaluate(self, batches):
        """One evaluation: ``(embeddings, results, encode_s, rank_s)``."""
        t0 = time.perf_counter()
        embeds = self.encode(self.model, batches)
        t1 = time.perf_counter()
        results = self.rank(embeds["v_embed"], embeds["t_embed"],
                            embeds["pids"], embeds["pids"],
                            embeds["image_ids"], rerank=True,
                            device=self.device)
        return embeds, results, t1 - t0, time.perf_counter() - t1


def judged_rows(split: dict, n: int, seed: int) -> np.ndarray:
    """``n`` rows drawn from the seed, the longest caption among them."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(len(split["lengths"]), n, replace=False)
    longest = int(np.argmax(split["lengths"]))
    return np.unique(np.append(rows, longest))


def reference_embeddings(run, split: dict, rows: np.ndarray,
                         precision: str):
    """The plain reference's ``(v_embed, t_embed)`` of ``rows``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = run.weights()
    q = reference.Precision(precision)
    v_out, t_out = [], []
    with torch.no_grad():
        for start in range(0, len(rows), BLOCK):
            r = rows[start:start + BLOCK]

            def dev(x, dtype=None):
                return torch.as_tensor(np.ascontiguousarray(x)).to(
                    run.device, dtype)

            v, t = reference.encode(
                weights, run.ref_cfg,
                dev(split["images"][split["image_of"][r]]),
                dev(split["token_ids"][r]), dev(split["lengths"][r]),
                dev(split["batch_max"][r]), q)
            v_out.append(v.double().cpu().numpy())
            t_out.append(t.double().cpu().numpy())
    return np.concatenate(v_out), np.concatenate(t_out)


def reference_grid(results: dict, split: dict, device) -> dict:
    """The reference's ranking of the program's own similarity and
    re-ranking terms (their sums in the program's dtype), in float64."""
    _, text_pid, image_pid = ranking.gallery(split["pids"],
                                             split["image_ids"], device)

    def dev(name):
        return torch.as_tensor(results[name], device=device)

    sim, rvn, rtn = dev("similarity"), dev("rvn_mat"), dev("rtn_mat")
    return {"t2i": ranking.rank(sim.double(), text_pid, image_pid),
            "i2t": ranking.rank(sim.T.double(), image_pid, text_pid),
            "re_t2i": ranking.rank((rvn + sim).double(), text_pid,
                                   image_pid),
            "re_i2t": ranking.rank((rtn + sim.T).double(), image_pid,
                                   text_pid)}


def judge_evaluations(run, kept: list, split: dict, rows: np.ndarray,
                      ref_v: np.ndarray, ref_t: np.ndarray) -> dict:
    """The evaluation numbers of ``kept`` ``(embeddings, results)``, the
    worst over them: the sampled rows' embeddings against the reference
    towers'; the similarity (float64) and the re-ranking terms
    (float32) against the reference's, computed from the program's
    embeddings (a row of a term differs where any entry is off by more
    than ``TERM_TOL``); the grid against the reference's ranking of the
    program's own matrices."""
    numbers = {"image_embed_gap": 0.0, "text_embed_gap": 0.0,
               "similarity_gap": 0.0, "rerank_rows_gap": 0.0,
               "rank_gap": 0.0}

    def worse(name, value):
        numbers[name] = max(numbers[name], value)

    for embeds, results in kept:
        worse("image_embed_gap", judge.embed_gap(embeds["v_embed"][rows],
                                                 ref_v))
        worse("text_embed_gap", judge.embed_gap(embeds["t_embed"][rows],
                                                ref_t))
        def gap(name, dtype):
            want = ranking.evaluate(embeds["v_embed"], embeds["t_embed"],
                                    split["pids"], split["image_ids"],
                                    run.device, dtype)
            got = torch.as_tensor(results[name], device=run.device)
            return (got.double() - want[name].double()).abs()

        worse("similarity_gap", float(gap("similarity", torch.float64).max()))
        off = torch.cat([gap("rvn_mat", torch.float32).amax(dim=1),
                         gap("rtn_mat", torch.float32).amax(dim=1)])
        worse("rerank_rows_gap", float((off > TERM_TOL).double().mean()))
        worse("rank_gap", judge.rank_gap(
            results, reference_grid(results, split, run.device)))
    return numbers


def execute(run) -> dict:
    mix = run.traffic
    batches, split = inputs.test_split(mix, run.ref_cfg, run.seed,
                                       run.device)
    side = EvalSide(run)
    for _ in range(mix["warmup_evaluations"]):
        side.evaluate(batches)
    run.synchronize()
    run.reset_peak()
    run.setup_s = time.perf_counter() - run.t0

    # a reservoir of the window's evaluations, drawn from the seed
    rng = np.random.default_rng(run.seed)
    kept, size = [], mix["judged_evaluations"]
    encode_s, rank_s = [], []
    before = launch_counts()
    done, start = 0, time.perf_counter()
    deadline = start + run.seconds
    while True:
        embeds, results, t_enc, t_rank = side.evaluate(batches)
        if not all(math.isfinite(v) for c in judge.GRID
                   for v in results[c]["cmc"] + [results[c]["mAP"]]):
            run.failed += 1
        encode_s.append(t_enc)
        rank_s.append(t_rank)
        item = (embeds, results)
        if len(kept) < size:
            kept.append(item)
        else:
            slot = int(rng.integers(0, done + 1))
            if slot < size:
                kept[slot] = item
        done += 1
        if time.perf_counter() >= deadline:
            break
    seconds = time.perf_counter() - start
    after = launch_counts()
    pairs = len(split["lengths"])
    run.window = {"seconds": seconds, "calls": done,
                  "flops_per_call": flops.encode_forward(run.ref_cfg, pairs)}
    run.launches = {k: (after[k] - before[k]) / done for k in before}
    run.spans = {"encode_s": encode_s, "rank_s": rank_s}
    whole = sorted(a + b for a, b in zip(encode_s, rank_s))
    run.notes.append(f"evaluations {done}: seconds min {whole[0]:.4f} "
                     f"median {whole[len(whole) // 2]:.4f} max "
                     f"{whole[-1]:.4f}")
    e2e = {"eval_s": seconds / done}
    if run.trace:
        calls = mix["traced_evaluations"]
        run.trace_summary = trace.reduce(trace.capture(
            lambda: side.evaluate(batches), calls, False), calls)
        run.traced_calls = calls
    run.memory_peak = run.peak_bytes()

    del side
    run.release()
    rows = judged_rows(split, mix["judged_rows"], run.seed)
    ref_v, ref_t = reference_embeddings(run, split, rows, "float32")
    run.numbers = judge_evaluations(run, kept, split, rows, ref_v, ref_t)
    return e2e


def readings(run, seed: int, control: bool, faults: bool, emit) -> None:
    """The program's numbers on ``seed`` over one evaluation (the sound
    runs' lower readings); with ``control``, the reference's towers in
    float8 on the judged rows and the ranking of the program's embeddings
    in bfloat16; with ``faults``, each of ``FAULTS``'."""
    batches, split = inputs.test_split(run.traffic, run.ref_cfg, seed,
                                       run.device)
    rows = judged_rows(split, run.traffic["judged_rows"], seed)
    ref_v, ref_t = reference_embeddings(run, split, rows, "float32")

    def program(hooks):
        run.hooks = hooks
        side = EvalSide(run)
        embeds, results, _, _ = side.evaluate(batches)
        del side
        run.release()
        return embeds, results

    def report(what, kept, v=None, t=None):
        numbers = judge_evaluations(run, [kept], split, rows, ref_v, ref_t)
        if v is not None:
            numbers["image_embed_gap"] = judge.embed_gap(v, ref_v)
            numbers["text_embed_gap"] = judge.embed_gap(t, ref_t)
        emit({"seed": seed, "what": what, "numbers": numbers})

    sound = program({})
    report("program", sound)
    if control:
        v8, t8 = reference_embeddings(run, split, rows, "fp8")
        embeds = sound[0]
        low = ranking.evaluate(embeds["v_embed"], embeds["t_embed"],
                               split["pids"], split["image_ids"], run.device,
                               torch.bfloat16)
        report("control_fp8_bf16", (embeds, low), v8, t8)
    if faults:
        for name, hooks in FAULTS.items():
            report("fault_" + name, program(hooks))


# -- faults planted under the timed path ------------------------------------
# (each a ``hooks`` dict for ``runner.Run``, wrapping the program's
# ``compute_embeddings`` or its ``evaluation``)

def _rows_left_out(encode):
    """Half of every batch left out: its second half's rows are encoded
    from the first half's inputs."""
    def faulty(model, batches):
        def halved(batch):
            out = dict(batch)
            half = len(batch["valid"]) // 2
            for k in ("pixels", "token_ids", "lengths"):
                v = batch[k].copy()
                v[half:2 * half] = v[:half]
                out[k] = v
            return out
        return encode(model, [halved(b) for b in batches])
    return faulty


def _answer_altered(evaluation):
    """One answer altered where it is produced: the re-ranked t2i
    CMC@1, one point up."""
    def faulty(*args, **kwargs):
        results = evaluation(*args, **kwargs)
        results["re_t2i"]["cmc"][0] += 1.0
        return results
    return faulty


FAULTS = {"half_batch": {"encode": _rows_left_out},
          "answer_altered": {"rank": _answer_altered}}
