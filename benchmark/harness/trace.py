"""A ``torch.profiler`` trace of a few calls and what the per-layer
metrics read from it: the device's busy time (the union of its kernel
intervals) over the traced window, device time by kernel family (the
yardstick's table, convolutions and products by the aten call that
launched them), the longest kernels, and the longest idle gaps named by
the host-side call that was running when each began."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Callable, Dict, List

from .yardstick import CALL_FAMILIES, kernel_family

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
TOP = 10


def capture(fn: Callable[[], None], calls: int,
            host: bool) -> List[dict]:
    """The complete events of ``calls`` calls of ``fn``, from the
    profiler's Chrome trace (written to a temporary file and removed).
    One call runs under the profiler before them, untraced, so that the
    traced calls find it warm; the card is synchronised after it and
    after the last.  ``host``: the host's aten calls too, which the
    attribution of kernels to convolutions needs, at a cost on the host
    of some microseconds a call; without them the card's timeline is the
    window's, as the host paces it untraced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    activities = activities or [ProfilerActivity.CPU]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=calls,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for i in range(calls + 1):
                fn()
                if i in (0, calls) and torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals):
    """Total length and the gaps ``(start, end)`` of a set of intervals."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _outermost(spans):
    out = []
    for span in sorted(spans, key=lambda c: (c[0], -c[1])):
        if not out or span[0] >= out[-1][1]:
            out.append(span)
    return out


def reduce(events: List[dict], calls: int) -> Dict:
    """What a traced window holds: ``window_s`` (the first event's start
    to the last device event's end), ``busy_s``, ``by_family_ms``
    ({family: ms a call}), ``launches`` ({family: kernels a call}),
    ``device_ops`` and ``idle_gaps`` (the most time, ``[name,
    seconds]`` over the window: the host call running when a gap began,
    or without host events the kernel that ended it)."""
    device, launched = [], {}
    calls_by_tid = collections.defaultdict(list)
    host = collections.defaultdict(list)  # tid -> [(start, end, name)]
    for e in events:
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args", {})
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, name, cat, args.get("correlation")))
        elif cat in LAUNCH_CATEGORIES and "correlation" in args:
            launched[args["correlation"]] = (e.get("tid"), ts)
        elif cat in ("cpu_op", "user_annotation"):
            host[e.get("tid")].append((ts, ts + dur, name))
            if name in CALL_FAMILIES:
                calls_by_tid[e.get("tid")].append((ts, ts + dur, name))
    if not device:
        return {}
    outer = {tid: _outermost(v) for tid, v in calls_by_tid.items()}
    starts = {tid: [c[0] for c in v] for tid, v in outer.items()}
    by_call = {}
    for corr, (tid, ts) in launched.items():
        if tid in outer:
            at = bisect.bisect_right(starts[tid], ts) - 1
            if at >= 0 and outer[tid][at][1] >= ts:
                by_call[corr] = CALL_FAMILIES[outer[tid][at][2]]
    families = collections.Counter()
    launches = collections.Counter()
    kernels = collections.Counter()
    for s, e, name, cat, corr in device:
        family = kernel_family(name)
        if cat == "kernel":
            family = by_call.get(corr, family)
            launches[family] += 1
        families[family] += (e - s) / 1e3 / calls
        kernels[name] += (e - s) / 1e3 / calls
    busy_us, gaps = _union((s, e) for s, e, *_ in device)
    first = min([s for s, *_ in device]
                + [s for v in host.values() for s, _, _ in v])
    last = max(e for _, e, *_ in device)
    # the outermost host call running when each gap began, on the thread
    # with the most host events (the one that drives the calls)
    main_tid = max(host, key=lambda t: len(host[t])) if host else None
    main = _outermost(host[main_tid]) if main_tid is not None else []
    main_starts = [s for s, _, _ in main]

    def doing(ts):
        at = bisect.bisect_right(main_starts, ts) - 1
        if at >= 0 and main[at][1] >= ts:
            return main[at][2]
        return "host between calls"

    # without host events a gap takes the name of the kernel that ends it
    by_start = sorted((s, name) for s, _, name, *_ in device)
    starts_d = [s for s, _ in by_start]

    def ends(te):
        return "before " + by_start[bisect.bisect_left(starts_d, te)][1]

    idle = collections.Counter()
    for s, e in gaps:
        idle[doing(s) if host else ends(e)] += (e - s) / 1e6
    return {
        "window_s": (last - first) / 1e6,
        "busy_s": busy_us / 1e6,
        "by_family_ms": dict(families),
        "launches": {k: v / calls for k, v in launches.items()},
        "device_ops": [[name[:200], ms * calls / 1e3]
                       for name, ms in kernels.most_common(TOP)],
        "idle_gaps": [[name[:200], s] for name, s in idle.most_common(TOP)],
    }
