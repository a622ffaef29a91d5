"""``train.host_dispatch_ms``: the median host milliseconds of the
program's ``train.step`` span over the traced steps of the first
recording (``harness/spans.py``): the time the host takes to issue a
step, beside ``train.device_step_ms``, the card's."""

from statistics import median

from benchmark.harness.spans import per_root


def read(run):
    if run.kind != "train":
        return None
    ms = per_root(run, "train.step", ("train.step",), "host_ms")
    return median(ms) if ms else None
