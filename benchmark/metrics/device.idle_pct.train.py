"""``device.idle_pct.train``: the share of the traced window in which no
operation ran on the card (the union of the kernel, copy and memset
intervals of the trace)."""


def read(run):
    t = run.trace_summary
    if run.kind != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
