"""What the per-layer metrics read of the program's own spans
(``textreid_torch/utils/profiling.py:span``): the first recording of the
process.  A run's first traced capture makes it: the device-only capture
of ``drivers/train.py``'s traced steps, the capture of
``drivers/evaluate.py``'s traced evaluation (the untraced warm call
before each records nothing).  Spans are read on the card alone: on the
CPU (the tests' tiny cells) the host does the work it waits for on the
card, so its spans time no dispatch and no wait.  Every function returns
``None`` where there is nothing to read: a program without spans, a run
off the card or untraced, a root without the spans named, a span without
a device time."""

from __future__ import annotations

from typing import List, Optional, Sequence


def first_recording(run) -> Optional[dict]:
    """The process's first recording of spans (``{"id", "dropped",
    "spans"}``), or ``None``."""
    if not (run.on_card and run.trace):
        return None
    from textreid_torch.utils import profiling

    # a program before the spans has the module but not ``recordings``:
    # the traced runs of a checkout of it take these readers too
    read = getattr(profiling, "recordings", None)
    recordings = read() if read is not None else []
    return recordings[0] if recordings else None


def per_root(run, root: str, names: Sequence[str],
             field: str) -> Optional[List[float]]:
    """For each span ``root`` that opened no other (a root) in the first
    recording, the sum of ``field`` (``host_ms``, ``device_ms``) over the
    spans named ``names`` under it; ``None`` where a root has none of
    them or a value is missing."""
    rec = first_recording(run)
    if rec is None:
        return None
    sums = {s["id"]: [] for s in rec["spans"]
            if s["parent"] is None and s["name"] == root}
    for s in rec["spans"]:
        if s["root"] in sums and s["name"] in names:
            sums[s["root"]].append(s[field])
    if not sums or any(not v or None in v for v in sums.values()):
        return None
    return [sum(v) for v in sums.values()]


def count_per_root(run, root: str, counter: str) -> Optional[float]:
    """``counter`` summed over every span of the first recording, over
    the number of its roots named ``root``."""
    rec = first_recording(run)
    if rec is None:
        return None
    n = sum(1 for s in rec["spans"]
            if s["parent"] is None and s["name"] == root)
    if not n:
        return None
    return sum(s["counts"].get(counter, 0) for s in rec["spans"]) / n
