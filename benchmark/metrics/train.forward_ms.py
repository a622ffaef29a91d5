"""``train.forward_ms``: device milliseconds a step of the program's
``train.key_forward`` and ``train.query_forward`` spans (the key towers,
the L2 norms and the key gather; the query towers and the loss tail),
the mean over the traced steps of the first recording
(``harness/spans.py``; CUDA events at each end of a span)."""

from statistics import mean

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "train":
        return None
    ms = per_root(run, "train.step",
                  ("train.key_forward", "train.query_forward"), "device_ms")
    return mean(ms) if ms else None
