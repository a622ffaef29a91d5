"""Profiling and numerical-debugging utilities (counterpart of
``textreid_tpu/utils/profiling.py``).

* :func:`profile_trace` — a context manager around ``torch.profiler``
  writing a Chrome trace of the host and the card;
* :func:`step_timer` — wall timing of a block that ends in
  ``torch.cuda.synchronize`` (kernel launches return before the card is
  done: without it the timer reads the enqueue);
* :func:`nan_check` — raise on a non-finite floating tensor of a module or
  a (nested) dict;
* :func:`live_memory` — bytes the caching allocator holds live on each
  card (``torch.cuda.memory_stats``);
* :func:`device_time_by_family` — the card's time in a call, split by
  kernel family from a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture the host's and the card's activity into
    ``log_dir/trace.json`` (chrome://tracing, Perfetto); yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def step_timer(meters=None, name: str = "time"):
    """Wall-time a block up to the completion of its work on the card.
    Yields a dict whose ``"elapsed"`` holds the seconds afterwards;
    ``meters`` (a ``MetricLogger``) gets them as ``name``."""
    start = time.perf_counter()
    holder: Dict[str, float] = {}
    try:
        yield holder
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        holder["elapsed"] = time.perf_counter() - start
        if meters is not None:
            meters.update(**{name: holder["elapsed"]})


def _tensors(tree: Any, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, torch.Tensor):
        yield prefix or "tensor", tree
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _tensors(value, f"{prefix}.{key}" if prefix
                                else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _tensors(value, f"{prefix}[{i}]")


def nan_check(tree: Any, where: str = "") -> None:
    """Raise ``FloatingPointError`` if a floating tensor of ``tree`` (a
    module's parameters and buffers, a tensor, or dicts, lists and tuples
    of them) holds NaN or Inf.  Reads the values back to the host: call it
    sparingly."""
    bad = [name for name, t in _tensors(tree)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(
            f"Non-finite values{' in ' + where if where else ''}: {bad[:10]}")


def live_memory() -> Dict[str, int]:
    """Bytes of live allocations on each card (``allocated_bytes.all.
    current`` of ``torch.cuda.memory_stats``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current", 0))
            for i in range(torch.cuda.device_count())}


Families = Sequence[Tuple[str, Sequence[str]]]


def device_time_by_family(fn: Callable[[], Any], calls: int,
                          families: Families) -> Optional[Dict[str, float]]:
    """The card's time in ``fn`` by kernel family, from ``torch.profiler``
    over ``calls`` calls: ``{family: ms a call}`` with ``"other"``,
    ``"total"`` and ``"launches"`` (kernels a call).  ``families`` is
    ``((name, keys), ...)``: the first family one of whose keys a kernel's
    name holds (lower case) takes it; copies and memsets go to "other".
    ``None`` when the trace holds no device events (a profiler that cannot
    trace the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in families}
    out.update({"other": 0.0, "total": 0.0, "launches": 0})
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        name = evt.name.lower()
        if "memcpy" in name or "memset" in name:
            family = "other"
        else:
            family = next((fam for fam, keys in families
                           if any(k in name for k in keys)), "other")
            out["launches"] += 1
        out[family] += us / 1e3 / calls
        out["total"] += us / 1e3 / calls
    out["launches"] //= calls
    return out if out["total"] > 0.0 else None
