"""``train.backward_ms``: device milliseconds a step of the program's
``train.backward`` span (the loss's backward), the mean over the traced
steps of the first recording (``harness/spans.py``; CUDA events at each
end of a span)."""

from statistics import mean

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "train":
        return None
    ms = per_root(run, "train.step", ("train.backward",), "device_ms")
    return mean(ms) if ms else None
