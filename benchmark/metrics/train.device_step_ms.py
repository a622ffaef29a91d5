"""``train.device_step_ms``: the card's busy time a step (the union of
its operation intervals) over the traced steps: the step's device time,
steadier than the host's clock."""


def read(run):
    t = run.trace_summary
    if run.kind != "train" or not t or not run.traced_calls:
        return None
    return 1e3 * t["busy_s"] / run.traced_calls
