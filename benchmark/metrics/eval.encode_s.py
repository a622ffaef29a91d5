"""``eval.encode_s``: the benchmark's span around
``engine/inference.py:compute_embeddings``, the mean over the window's
evaluations (host clock; the call ends with every embedding on the
host)."""


def read(run):
    spans = run.spans.get("encode_s")
    if run.kind != "evaluate" or not spans:
        return None
    return sum(spans) / len(spans)
