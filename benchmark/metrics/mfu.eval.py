"""``mfu.eval``: the towers' and embedding layers' model operations of
every caption-image pair of an evaluation (``harness/flops.py:
encode_forward``) times the evaluations of the window, over its
seconds, against the card's bf16 peak."""

from benchmark.harness.yardstick import device_peaks


def read(run):
    peaks = device_peaks(run.device_name) if run.on_card else None
    if run.kind != "evaluate" or not peaks or not run.window:
        return None
    w = run.window
    rate = w["flops_per_call"] * w["calls"] / w["seconds"]
    return 100.0 * rate / peaks["ops_s"]["bfloat16"]
