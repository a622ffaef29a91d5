"""Profiling and numerical-debugging utilities (counterpart of
``textreid_tpu/utils/profiling.py``).

* :func:`profile_trace` — a context manager around ``torch.profiler``
  writing a Chrome trace of the host and the card, the program's spans on
  a track of their own;
* :func:`span` / :func:`count` — named ranges of the program's work and
  counts inside them, recorded while a ``torch.profiler`` records or
  inside :func:`recording`, read by :func:`recordings` (below);
* :func:`nan_check` — raise on a non-finite floating tensor of a module or
  a (nested) dict;
* :func:`live_memory` — bytes the caching allocator holds live on each
  card (``torch.cuda.memory_stats``);
* :func:`device_time_by_family` — the card's time in a call, split by
  kernel family from a ``torch.profiler`` trace;
* ``STEP_FAMILIES`` — the train step's kernel families, which
  ``tools/profile_step.py:summarize`` classifies with (``chip_smoke.py``
  profiles its steps through it);
* ``DEVICE_PEAKS`` / :func:`device_peaks` / :func:`bound_ms` — a card's
  memory rate and peak operation rates by type, keyed by
  ``torch.cuda.get_device_name()``, and the roofline bound of a piece of
  work on it; :func:`k1_forward_work`, :func:`k1_backward_work` and
  :func:`attention_work` count the bytes and operations of the port's own
  kernels (K1, K1's backward, K5 and K6).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture the host's and the card's activity into
    ``log_dir/trace.json`` (chrome://tracing, Perfetto), each call's input
    shapes recorded (``tools/profile_step.py`` counts operations from
    them), and the spans recorded inside the block on a track of their
    own (:func:`_add_span_track`); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    first = _TRACER.begin()
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, [r for r in recordings() if r["id"] >= first])


# -- spans --------------------------------------------------------------------
#
# ``with span("train.ema"): ...`` names a range of the program's work.  While
# nothing records, ``span`` returns one shared context that does nothing: no
# allocation, no CUDA call, no lock (the path the benchmark times).  A span
# opened while no span is open on its thread is a root.  A root records while
# a ``torch.profiler`` records (``torch.autograd.profiler.
# _is_profiler_enabled``: off in a schedule's warm-up calls, on in its active
# ones) or inside :func:`recording`; every span opened under a recorded root
# records.  A recording is a run of recorded roots: a root opened while
# nothing records ends it.  Under a profiler each span also enters
# ``record_function(name)``, so a trace with the host's activity shows it as
# a user annotation.
#
# Times are ``time.time_ns()``, the clock of the profiler's Chrome trace
# (its ``ts`` plus ``baseTimeNanoseconds``).  In a process that has
# initialised CUDA a recorded span also records a CUDA event at each end on
# the current stream; a recording's first root synchronises and records an
# anchor event, which puts the events on the same clock.  Events are read
# when :func:`recordings` is called.  Spans are opened and closed on the
# thread that drives the work (the step, the evaluation).

SPAN_CAP = 1 << 16  # spans kept; past it the oldest go, counted


class _Off:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open(threading.local):
    span = None  # the innermost open recorded span of this thread


class _Recording:
    """A run of recorded roots, with the anchor of its device times."""

    __slots__ = ("id", "anchor", "anchor_ns", "dropped")

    def __init__(self, rid: int):
        self.id, self.dropped = rid, 0
        self.anchor = self.anchor_ns = None
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
            self.anchor_ns = time.time_ns()


class Span:
    """One recorded span; :func:`recordings` gives it as a dict."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "counts", "recording", "_tracer", "_up", "_events",
                 "_device", "_annotation")

    def __init__(self, tracer: "Tracer", name: str):
        self.name, self._tracer = name, tracer
        self.start_ns = self.end_ns = None
        self.counts: Dict[str, int] = {}
        self._events = self._device = self._annotation = None

    def __enter__(self):
        t = self._tracer
        self.id, self._up = next(t.ids), t.open.span
        if self._up is None:
            if t.current is None:
                t.made += 1
                t.current = _Recording(t.made)
            self.recording, self.parent, self.root = t.current, None, self.id
        else:
            self.recording = self._up.recording
            self.parent, self.root = self._up.id, self._up.root
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = _autograd_profiler.record_function(self.name)
            self._annotation.__enter__()
        t.keep(self)
        self.start_ns = time.time_ns()
        if self.recording.anchor is not None:
            self._events = [torch.cuda.Event(enable_timing=True)]
            self._events[0].record()
        t.open.span = self
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events.append(torch.cuda.Event(enable_timing=True))
            self._events[1].record()
        self.end_ns = time.time_ns()
        self._tracer.open.span = self._up
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False

    def as_dict(self) -> dict:
        """The span's fields; the device's times wait for the card to
        reach the span's end."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            anchor = self.recording.anchor
            self._device = (anchor.elapsed_time(start),
                            start.elapsed_time(end))
            self._events = None
        out = {"name": self.name, "id": self.id, "parent": self.parent,
               "root": self.root, "start_ns": self.start_ns,
               "end_ns": self.end_ns,
               "host_ms": (self.end_ns - self.start_ns) / 1e6,
               "device_ms": None, "device_start_ns": None,
               "counts": dict(self.counts)}
        if self._device is not None:
            after_ms, out["device_ms"] = self._device
            out["device_start_ns"] = self.recording.anchor_ns + round(
                after_ms * 1e6)
        return out


class Tracer:
    """A process's spans: the bounded buffer, the recordings, the switch of
    :func:`recording`.  The module's functions use one."""

    def __init__(self, cap: int = SPAN_CAP):
        self.spans: collections.deque = collections.deque(maxlen=cap)
        self.open = _Open()
        self.switch = 0  # open ``recording()`` blocks
        self.current: Optional[_Recording] = None  # the one roots join
        self.ids = itertools.count(1)
        self.made = 0  # recordings begun

    def keep(self, s: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.spans[0].recording.dropped += 1
        self.spans.append(s)

    def begin(self) -> int:
        """End the current recording; returns the id the next takes."""
        self.current = None
        return self.made + 1


_TRACER = Tracer()


def span(name: str):
    """A context naming a range of the program's work (see above): the
    shared no-op context while nothing records, else a recorded
    :class:`Span`."""
    t = _TRACER
    if (t.open.span is None and not t.switch
            and not _autograd_profiler._is_profiler_enabled):
        t.current = None
        return _OFF
    return Span(t, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open recorded
    span; nothing while none is open."""
    s = _TRACER.open.span
    if s is not None:
        s.counts[name] = s.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans inside the block without a profiler (the operator's
    switch): the roots opened in it make a recording of their own."""
    t = _TRACER
    t.begin()
    t.switch += 1
    try:
        yield
    finally:
        t.switch -= 1
        t.current = None


def recordings() -> List[dict]:
    """The recordings in the buffer, oldest first: ``{"id", "dropped"
    (its spans the buffer's cap pushed out), "spans"}``, the spans in the
    order they opened, those still open left out.  A span is ``name``,
    ``id``, ``parent`` (``None`` for a root), ``root`` (its root's id),
    ``start_ns`` and ``end_ns`` (``time.time_ns()``), ``host_ms``,
    ``counts``, and ``device_ms`` and ``device_start_ns`` (the CUDA
    events' interval, its start on the same clock; ``None`` without
    CUDA)."""
    out: Dict[int, dict] = {}
    for s in list(_TRACER.spans):
        rec = out.setdefault(s.recording.id, {
            "id": s.recording.id, "dropped": s.recording.dropped,
            "spans": []})
        if s.end_ns is not None:
            rec["spans"].append(s.as_dict())
    return list(out.values())


def clear_spans() -> None:
    """Empty the buffer and end the current recording."""
    _TRACER.spans.clear()
    _TRACER.current = None


SPAN_PID = "program spans"


def _add_span_track(path: str, recs: List[dict]) -> None:
    """Write the spans of ``recs`` into the Chrome trace at ``path`` on a
    track of their own (process ``SPAN_PID``: thread "host" the host's
    intervals, thread "device" the card's), on the trace's clock."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    events = trace.setdefault("traceEvents", [])
    for rec in recs:
        for s in rec["spans"]:
            args = {"id": s["id"], "parent": s["parent"], "root": s["root"],
                    "recording": rec["id"], **s["counts"]}
            for tid, start, ms in (("host", s["start_ns"], s["host_ms"]),
                                   ("device", s["device_start_ns"],
                                    s["device_ms"])):
                if ms is not None:
                    events.append({"ph": "X", "cat": "program_span",
                                   "name": s["name"], "pid": SPAN_PID,
                                   "tid": tid, "ts": (start - base) / 1e3,
                                   "dur": ms * 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


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

# the train step's kernel families: K1's backward before its forwards (the
# W-resident backward's name holds "bigru_resident" too), the streamed
# backward (f32 only) apart.  "convolutions" and "matrix products" have no
# name keys: ``tools/profile_step.py:summarize`` gives them the kernels
# their calls launched, as cuDNN runs 1x1 convolutions in kernels named
# like cuBLAS's products
STEP_FAMILIES: Families = (
    ("K5", ("attention_fwd",)), ("K6", ("attention_bwd",)),
    ("K1 bwd", ("bigru_resident_bwd_kernel",)),
    ("K1 bwd streamed", ("bigru_pooled_bwd_kernel",)),
    ("K1 fwd", ("bigru_pooled", "bigru_resident")),
    ("convolutions", ()),
    ("BN", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("matrix products", ()))


def kernel_family(name: str, families: Families) -> str:
    """The first family one of whose keys ``name`` holds (lower case), else
    "other"; copies and memsets are "other"."""
    name = name.lower()
    if "memcpy" in name or "memset" in name:
        return "other"
    return next((fam for fam, keys in families
                 if any(k in name for k in keys)), "other")


# dense peaks from the vendor's data sheet: bytes a second of device memory
# and operations a second by input type (f32 on the FP32 cores: the port
# turns TF32 off, utils/platform.py:require_cuda)
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bytes_s": 3.35e12,
        "ops_s": {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}},
}


def device_peaks(name: str) -> Optional[dict]:
    """The peaks of the card ``name`` (``torch.cuda.get_device_name()``),
    or ``None`` for a card the table lacks."""
    return DEVICE_PEAKS.get(name)


def bound_ms(n_bytes: float, n_ops, peaks: dict,
             dtype_name: Optional[str] = None) -> Tuple[float, str]:
    """(bound ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype_name``; ``n_ops`` may instead
    be a {dtype name: operations} dict, whose times at each rate add up."""
    by_bytes = n_bytes / peaks["bytes_s"] * 1e3
    if not isinstance(n_ops, dict):
        n_ops = {dtype_name: n_ops}
    by_ops = sum(n / peaks["ops_s"][name] for name, n in n_ops.items()) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def k1_forward_work(batch: int, seq: int, hidden: int,
                    train: bool = False) -> Tuple[int, Dict[str, int]]:
    """(bytes, {dtype: operations}) of K1's bf16 forward over both
    directions: x and W read, the pooled ``[B, 2H]`` written, T steps of
    ``[B, H] x [H, 3H]``; the training forward also writes the f32 state
    its backward reads (h_{t-1} and 4 gates a step) and the argmax."""
    b, t, h = batch, seq, hidden
    n_bytes = 2 * (2 * b * t * 3 * h + 2 * h * 3 * h + b * 2 * h)
    if train:
        n_bytes += 4 * 2 * b * t * 5 * h + 4 * b * 2 * h
    return n_bytes, {"bfloat16": 2 * t * 2 * b * h * 3 * h}


def k1_backward_work(batch: int, seq: int, hidden: int, steps: int,
                     dw: bool = True) -> Tuple[int, Dict[str, int]]:
    """(bytes, {dtype: operations}) of K1's bf16 backward over both
    directions: g, W, lengths, the saved f32 state and argmax read, dx
    written; per valid (row, step) pair (``steps``: those with ``t < len``)
    the serial ``[3H] x [3H, H]`` product at the bf16 rate, twice (the
    kernel runs it on the tensor cores as hi and lo products).  ``dw``: the
    whole function (``ops/gru.py:bigru_pooled_bwd``), with dW written and
    its share of the f32 product ``hp^T dhg``; else the kernel alone
    (``bigru_resident_bwd_kernel``), which writes the f32 ``dhg`` that
    product reads and does none of its operations."""
    b, t, h = batch, seq, hidden
    n_bytes = (2 * b * 2 * h + 2 * 2 * 3 * h * h + 4 * b
               + 4 * 2 * b * t * 5 * h + 4 * b * 2 * h
               + 2 * 2 * b * t * 3 * h)
    serial = {"bfloat16": 2 * 2 * steps * 2 * 3 * h * h}
    if not dw:
        return n_bytes + 4 * 2 * b * t * 3 * h, serial
    return n_bytes + 2 * 2 * h * 3 * h, {
        "float32": 2 * steps * 2 * 3 * h * h, **serial}


def attention_work(batch: int, seq: int, width: int, heads: int,
                   backward: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of K5 (``backward``: K6) in bf16: the ``[q|k|v]``
    slab read and the output written (K6: qkv and g read, dqkv written);
    QK^T and PV (K6: S, dP, dV, dQ, dK)."""
    matmul = 2 * batch * heads * seq * seq * (width // heads)
    if backward:
        return 2 * batch * seq * 7 * width, 5 * matmul
    return 2 * batch * seq * 4 * width, 2 * matmul


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
        if "memcpy" not in name and "memset" not in name:
            out["launches"] += 1
        out[kernel_family(name, families)] += us / 1e3 / calls
        out["total"] += us / 1e3 / calls
    out["launches"] //= calls
    return out if out["total"] > 0.0 else None
