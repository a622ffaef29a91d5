"""``mfu.train``: the step's model operations (``harness/flops.py:
train_step``, counted from the configuration's shapes) times the steps of
the window, over the window's seconds, against the card's bf16 peak."""

from benchmark.harness.yardstick import device_peaks


def read(run):
    peaks = device_peaks(run.device_name) if run.on_card else None
    if run.kind != "train" or not peaks or not run.window:
        return None
    w = run.window
    rate = w["flops_per_call"] * w["calls"] / w["seconds"]
    return 100.0 * rate / peaks["ops_s"]["bfloat16"]
