"""``eval.rank_s``: the benchmark's span around
``evaluation/metrics.py:evaluation`` (similarity, CMC, mAP and
re-ranking), the mean over the window's evaluations (host clock; the
call ends with its matrices on the host)."""


def read(run):
    spans = run.spans.get("rank_s")
    if run.kind != "evaluate" or not spans:
        return None
    return sum(spans) / len(spans)
