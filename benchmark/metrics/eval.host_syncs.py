"""``eval.host_syncs``: the program's ``host_syncs`` counter an
evaluation (each blocking copy to the host, counted where it runs, at
which the host waits for the work queued before it: the two embeddings
of every batch, each column of the metric grid, the matrices),
summed over the spans of the first recording over its ``eval.encode``
roots (``harness/spans.py``)."""

from benchmark.harness.spans import count_per_root


def read(run):
    if run.kind != "evaluate":
        return None
    return count_per_root(run, "eval.encode", "host_syncs")
