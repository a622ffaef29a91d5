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

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture the host's and the card's activity into
    ``log_dir/trace.json`` (chrome://tracing, Perfetto), each call's input
    shapes recorded (``tools/profile_step.py`` counts operations from
    them); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
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
