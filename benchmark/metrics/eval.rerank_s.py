"""``eval.rerank_s``: device seconds an evaluation of the program's
``eval.rerank`` span (both k-reciprocal re-ranking terms), over the
``eval.rank`` roots of the first recording (``harness/spans.py``; CUDA
events at each end of a span)."""

from statistics import mean

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "evaluate":
        return None
    ms = per_root(run, "eval.rank", ("eval.rerank",), "device_ms")
    return mean(ms) / 1e3 if ms else None
