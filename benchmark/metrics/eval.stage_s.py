"""``eval.stage_s``: host seconds an evaluation in the program's
``eval.stage`` spans (each batch's arrays made tensors and copied to the
card), over the ``eval.encode`` roots of the first recording
(``harness/spans.py``)."""

from statistics import mean

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "evaluate":
        return None
    ms = per_root(run, "eval.encode", ("eval.stage",), "host_ms")
    return mean(ms) / 1e3 if ms else None
