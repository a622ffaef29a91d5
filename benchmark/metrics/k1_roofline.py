"""``k1_roofline``: the roofline bounds of K1's launches over their
device time, in the traced steps: a step launches K1's pooled-only
forward (the key tower), its training forward (the query tower) and its
backward kernel.  Each bound counts the recurrent products of the
batch's valid (row, step) pairs alone, which is all the function needs;
the backward's leaves out dW's product (an ``aten::bmm``).  The work
counts are the yardstick's frozen copies."""

from benchmark.harness.yardstick import (
    bound_ms,
    device_peaks,
    k1_backward_work,
    k1_forward_work,
)


def read(run):
    t = run.trace_summary
    peaks = device_peaks(run.device_name) if run.on_card else None
    if run.kind != "train" or not t or not peaks:
        return None
    ms = (t["by_family_ms"].get("K1 fwd", 0.0)
          + t["by_family_ms"].get("K1 bwd", 0.0)) * run.traced_calls
    if ms <= 0.0:
        return None
    b = run.ref_cfg["SOLVER"]["IMS_PER_BATCH"]
    seq = run.ref_cfg["INPUT"]["MAX_TEXT_LENGTH"]
    h = run.ref_cfg["MODEL"]["GRU"]["NUM_UNITS"]
    bound = 0.0
    for lengths in run.traced_lengths:
        steps = int(lengths.clamp(1, seq).sum())
        for work in (k1_forward_work(b, seq, h, train=True, steps=steps),
                     k1_forward_work(b, seq, h, steps=steps),
                     k1_backward_work(b, seq, h, steps, dw=False)):
            bound += bound_ms(*work, peaks)[0]
    return 100.0 * bound / ms
