"""``eval.fetch_s``: host seconds an evaluation in the program's
``eval.fetch`` spans under ``eval.encode`` (each batch's embeddings
copied back, the host waiting for the card), over the ``eval.encode``
roots of the first recording (``harness/spans.py``)."""

from statistics import mean

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "evaluate":
        return None
    ms = per_root(run, "eval.encode", ("eval.fetch",), "host_ms")
    return mean(ms) / 1e3 if ms else None
