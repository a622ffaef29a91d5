"""Capture and summarize a ``torch.profiler`` trace of the flagship's bf16
train step: the card's time a step by kernel family, the kernel count, the
longest kernels and, where the work can be counted, the share of the
roofline bound each family reaches.

Counterpart of the repository's ``tools/profile_step.py``:

    python -m textreid_torch.tools.profile_step [--steps 3] \
        [--out build/profile_step] [--json-out breakdown.json] \
        [--model ""|vit|fullclip] [--fused-attn] [--device cuda] \
        [--summarize-only | --spans] [--eval]

The step is the one ``chip_smoke.py`` times: ``config/flagship.py:
flagship_cfg(model, fused_attn)`` at batch 128 and 105 tokens
(``flagship_batch``), f32 masters, towers in bf16, Adam at lr 1e-4.  One
step runs before the trace; then ``--steps`` steps run under
``torch.profiler`` (with ``record_shapes``), whose Chrome trace is saved as
``OUT/trace.json`` beside ``OUT/step.json`` (the step's shapes and the
card's name).  ``--summarize-only`` re-reads both without running a step.

The step's spans (``utils/profiling.py:span``: ``train.step`` and its
phases) are in the trace on a track of their own; the summary splits the
card's time by phase: a kernel, copy or memset belongs to the innermost
span whose host interval holds its launch (the backward's launches come
from autograd's thread while the main thread waits in ``train.backward``),
and each idle gap of the card to the span the host was in when it began.
``--spans`` runs the steps with the profiler off instead, in turns without
spans and with them (``utils/profiling.py:recording``), ``SPAN_ROUNDS``
turns of ``--steps`` steps each way: ms a step each way, the cost of the
spans when on, and each span's host and device ms a step.

``--eval`` profiles a whole evaluation in place of the train step, as
``test_net`` runs it and the benchmark's eval cell times it
(``build_eval``): ``engine/inference.py:compute_embeddings`` over a
synthetic split of CUHK-PEDES's test sizes (6,156 captions of 3,074
images, batches of 128 in host memory), then ``evaluation/metrics.py:
evaluation`` with re-ranking; "a step" is then one evaluation, and the
phases are the evaluation's spans (``eval.stage``, ``eval.forward``,
``eval.fetch``; ``eval.similarity``, ``eval.rerank``, ``eval.cmc_map``,
``eval.fetch``), the work of the port's own kernels is not counted.

Families are ``utils/profiling.py:STEP_FAMILIES`` by kernel name, but for
"convolutions" and "matrix products", which take the kernels launched
inside the trace's ``aten::convolution`` / ``convolution_backward`` and
``aten::mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` calls (``CALL_FAMILIES``:
a kernel's correlation id gives its host-side launch, and the outermost
counted call on that thread whose span holds the launch takes it; cuDNN
runs 1x1 convolutions in kernels named like cuBLAS's products).
``chip_smoke.py:profile_steps`` summarizes its steps with this function.
Roofline shares (bound over the family's device time), each ``null``
where the work is not counted or the card is not in
``utils/profiling.py:DEVICE_PEAKS``:

* "convolutions" and "matrix products": the operations of those calls,
  counted from their recorded shapes (the operations
  ``torch.profiler(with_flops=True)`` reports for them; it leaves out the
  convolutions' backward, counted here too), each at the peak rate of its
  input type;
* "K1 fwd", "K1 bwd" (bi-GRU variants) and "K5", "K6" (the ViT tower):
  the port's own kernels, from the byte and operation counts of
  ``utils/profiling.py`` (the formulas of ``chip_smoke.py:kernel_bounds``)
  at the step's shapes; "K1 bwd" is the kernel alone, whose f32 ``dhg``
  the dW product (an ``aten::bmm``, under "matrix products") reads.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import time
from typing import Optional

import numpy as np

BATCH, TOKENS = 128, 105
LR = 1e-4
TOP_KERNELS = 15
SPAN_ROUNDS = 4
OUTSIDE = "(outside spans)"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
# the counted calls -> the family of the kernels they launch
CALL_FAMILIES = {**{op: "matrix products" for op in PRODUCT_OPS},
                 **{op: "convolutions" for op in CONV_OPS}}
ROOFLINE = ("convolutions", "matrix products", "K1 fwd", "K1 bwd", "K5",
            "K6")
# host-side launch events, which carry the correlation id of their kernel
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the trace's names of the input types -> the peak table's
TYPE_NAMES = {"c10::BFloat16": "bfloat16", "float": "float32",
              "c10::Half": "bfloat16"}


def build_step(variant: str = "", fused: bool = False, device="cuda",
               batch_size: int = BATCH, tokens: int = TOKENS):
    """(step, state, batch, meta): the flagship train step of ``variant``
    on ``device``, its state and one device batch; ``meta`` describes the
    shapes the analytic bounds need."""
    import torch

    from ..config import flagship_batch, flagship_cfg
    from ..engine import create_train_state, make_train_step
    from ..models import build_model
    from ..solver import make_optimizer, set_learning_rate
    from ..utils.platform import compute_dtype, require_cuda

    device = require_cuda(device)
    cfg = flagship_cfg(variant, fused_attention=fused, tokens=tokens)
    model = build_model(cfg, device, torch.float32,
                        compute_dtype(cfg, device), train=True)
    optimizer = make_optimizer(cfg, model)
    set_learning_rate(optimizer, LR)
    state = create_train_state(cfg, model, optimizer, batch_size)
    host = flagship_batch(batch_size, tokens)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    meta = {"variant": variant, "fused_attn": fused, "batch": batch_size,
            "tokens": tokens, "height": cfg.INPUT.HEIGHT,
            "width": cfg.INPUT.WIDTH,
            "text_tower": cfg.MODEL.TEXTUAL_MODEL,
            "hidden": cfg.MODEL.GRU.NUM_UNITS,
            "valid_steps": int(np.minimum(host["lengths"], tokens).sum()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}
    return make_train_step(cfg), state, batch, meta


# the CUHK-PEDES test split's sizes
EVAL_CAPTIONS, EVAL_IMAGES, EVAL_IDENTITIES = 6156, 3074, 1000


def test_batches(captions: int, images: int, identities: int,
                 batch_size: int, height: int, width: int, tokens: int,
                 vocab: int = 512, seed: int = 0) -> list:
    """The test loader's batches of a synthetic split, in dataset order:
    ``captions`` captions of ``images`` images (consecutive captions share
    an image), the images' identities in turn; numpy rows of
    ``batch_size``, the last batch padded with its last row and marked in
    ``valid``; uint8 NHWC pixels, captions of lognormal length around 23.5
    tokens (CUHK-PEDES's), clipped to 5-100 and to ``tokens``."""
    rng = np.random.RandomState(seed)
    image_of = np.arange(captions) * images // captions
    pixels = rng.randint(0, 255, (images, height, width, 3), dtype=np.uint8)
    lengths = np.clip(np.rint(rng.lognormal(np.log(23.5), 0.35, captions)),
                      min(5, tokens), min(100, tokens)).astype(np.int32)
    ids = rng.randint(1, vocab, (captions, tokens)).astype(np.int32)
    batches = []
    for start in range(0, captions, batch_size):
        rows = np.arange(start, min(start + batch_size, captions))
        valid = np.arange(batch_size) < len(rows)
        rows = np.concatenate([rows, np.full(batch_size - len(rows),
                                             rows[-1])])
        batches.append({"pixels": pixels[image_of[rows]],
                        "token_ids": ids[rows], "lengths": lengths[rows],
                        "pids": image_of[rows] % identities,
                        "image_ids": image_of[rows], "index": rows,
                        "valid": valid})
    return batches


def eval_call(model, batches: list, device):
    """One evaluation as ``test_net`` runs it: ``compute_embeddings`` over
    ``batches``, then ``evaluation`` with re-ranking on ``device``."""
    from ..engine import compute_embeddings
    from ..evaluation.metrics import evaluation

    def evaluate() -> dict:
        embeds = compute_embeddings(model, batches)
        return evaluation(embeds["v_embed"], embeds["t_embed"],
                          embeds["pids"], embeds["pids"],
                          embeds["image_ids"], rerank=True, device=device)

    return evaluate


def build_eval(variant: str = "", fused: bool = False, device="cuda",
               batch_size: int = BATCH, tokens: int = TOKENS,
               captions: int = EVAL_CAPTIONS, images: int = EVAL_IMAGES):
    """(evaluate, meta): one evaluation of the flagship ``variant`` on
    ``device`` (``test_net``'s model: the parameters in the compute dtype,
    eval mode) over ``test_batches`` at the flagship's input size."""
    import torch

    from ..config import flagship_cfg
    from ..models import build_model
    from ..utils.platform import compute_dtype, require_cuda

    device = require_cuda(device)
    cfg = flagship_cfg(variant, fused_attention=fused, tokens=tokens)
    model = build_model(cfg, device, compute_dtype(cfg, device))
    batches = test_batches(captions, images, EVAL_IDENTITIES, batch_size,
                           cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH, tokens)
    meta = {"variant": variant, "fused_attn": fused, "evaluation": True,
            "batch": batch_size, "tokens": tokens, "captions": captions,
            "images": images, "height": cfg.INPUT.HEIGHT,
            "width": cfg.INPUT.WIDTH,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}
    return eval_call(model, batches, device), meta


def capture(fn, steps: int, out: str, meta: dict) -> str:
    """Run ``fn`` ``steps`` times under ``torch.profiler`` (the card too
    when there is one; shapes recorded: ``utils/profiling.py:
    profile_trace``) and save ``out/trace.json`` and ``out/step.json``
    (``meta`` with ``steps``).  Returns ``out``."""
    from ..utils.profiling import profile_trace

    with profile_trace(out):
        for _ in range(steps):
            fn()
    with open(os.path.join(out, "step.json"), "w") as f:
        json.dump({**meta, "steps": steps}, f, indent=1)
    return out


def _concrete(args: dict, at: int):
    values = args.get("Concrete Inputs") or []
    return json.loads(values[at].lower()) if at < len(values) and values[
        at] not in ("", None) else None


def _conv_out(size, kernel, stride, padding, dilation):
    return (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def op_flops(name: str, args: dict) -> Optional[float]:
    """Operations of one traced call from its recorded shapes: ``2 M K N``
    for the products, ``2 N Co Ho Wo (Ci / groups) kh kw`` for a
    convolution (the backward: that for each gradient its output mask
    asks for); ``None`` when the trace lacks what the count needs."""
    dims = args.get("Input Dims") or []
    if name in ("aten::mm", "aten::addmm"):
        a, b = (dims[0], dims[1]) if name == "aten::mm" else (dims[1],
                                                               dims[2])
        return 2.0 * a[0] * a[1] * b[1] if len(a) == 2 and len(b) == 2 \
            else None
    if name in ("aten::bmm", "aten::baddbmm"):
        a, b = (dims[0], dims[1]) if name == "aten::bmm" else (dims[1],
                                                               dims[2])
        return 2.0 * a[0] * a[1] * a[2] * b[2] if len(a) == 3 and len(
            b) == 3 else None
    if name == "aten::convolution":
        x, w = dims[0], dims[1]
        stride, padding, dilation = (_concrete(args, i) for i in (3, 4, 5))
        transposed, groups = _concrete(args, 6), _concrete(args, 8)
        if len(x) != 4 or len(w) != 4 or None in (stride, padding, dilation,
                                                  groups) or transposed:
            return None
        ho = _conv_out(x[2], w[2], stride[0], padding[0], dilation[0])
        wo = _conv_out(x[3], w[3], stride[1], padding[1], dilation[1])
        return 2.0 * x[0] * w[0] * ho * wo * w[1] * w[2] * w[3]
    if name == "aten::convolution_backward":
        g, w = dims[0], dims[2]
        mask = _concrete(args, len(dims) - 1)
        if len(g) != 4 or len(w) != 4 or not isinstance(mask, list):
            return None
        per = 2.0 * g[0] * g[1] * g[2] * g[3] * w[1] * w[2] * w[3]
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    return None


def _outermost(spans: list) -> list:
    """The spans ``(start, end, ...)`` that lie inside no other, by
    start."""
    out = []
    for span in sorted(spans, key=lambda c: (c[0], -c[1])):
        if not out or span[0] >= out[-1][1]:
            out.append(span)
    return out


def _call_families(spans: dict, launched: dict) -> dict:
    """{correlation id: family} of the kernels launched inside a counted
    call: ``launched`` gives a kernel's host-side launch (thread, time),
    and the outermost counted call on that thread whose span holds it
    (``spans``: {thread: outermost (start, end, name, args)}) takes it."""
    import bisect

    starts = {tid: [c[0] for c in v] for tid, v in spans.items()}
    out = {}
    for corr, (tid, ts) in launched.items():
        if tid not in spans:
            continue
        at = bisect.bisect_right(starts[tid], ts) - 1
        if at >= 0 and spans[tid][at][1] >= ts:
            out[corr] = CALL_FAMILIES[spans[tid][at][2]]
    return out


def _type_of(args: dict) -> Optional[str]:
    types = args.get("Input type") or []
    named = [TYPE_NAMES.get(t) for t in types if t in TYPE_NAMES]
    return named[0] if named else None


def analytic_work(meta: dict, launches: dict) -> dict:
    """{family: (bytes, {dtype: operations})} a step of the port's own
    kernels at the step's shapes: K1 (the query tower's training forward,
    the key tower's pooled-only one; the backward kernel over the batch's
    valid (row, step) pairs, without dW's product) for a bi-GRU text tower, K5 and K6 at the ViT
    tower's shape (12 layers: 24 forwards and 12 backwards a step) for
    the ViT-B/16 variant; none for an evaluation."""
    from ..utils.profiling import (
        attention_work,
        k1_backward_work,
        k1_forward_work,
    )

    out = {}
    if meta.get("evaluation"):
        return out
    if meta.get("text_tower") == "bigru":
        b, t, h = meta["batch"], meta["tokens"], meta["hidden"]
        train_b, train_o = k1_forward_work(b, t, h, train=True)
        pool_b, pool_o = k1_forward_work(b, t, h)
        out["K1 fwd"] = (train_b + pool_b, {
            k: train_o[k] + pool_o[k] for k in train_o})
        out["K1 bwd"] = k1_backward_work(b, t, h, meta["valid_steps"],
                                         dw=False)
    if meta.get("variant") == "vit" and launches.get("K5"):
        b = meta["batch"]
        seq = 1 + (meta["height"] // 16) * (meta["width"] // 16)
        fwd_b, fwd_o = attention_work(b, seq, 768, 12)
        bwd_b, bwd_o = attention_work(b, seq, 768, 12, backward=True)
        out["K5"] = (24 * fwd_b, {"bfloat16": 24 * fwd_o})
        out["K6"] = (12 * bwd_b, {"bfloat16": 12 * bwd_o})
    return out


def _innermost(spans: list):
    """``at(t)``: the name of the innermost span of ``spans`` (the trace's
    host-side ``program_span`` events, properly nested) whose interval
    holds ``t``, else ``OUTSIDE``."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    starts = [e["ts"] for e in spans]
    by_id = {e["args"]["id"]: e for e in spans}

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        e = spans[i] if i >= 0 else None
        while e is not None and not e["ts"] <= t <= e["ts"] + e["dur"]:
            e = by_id.get(e["args"]["parent"])
        return e["name"] if e is not None else OUTSIDE

    return at


def phase_table(spans: list, device: list, launched: dict,
                steps: int) -> dict:
    """{phase: {"device_ms", "launches", "idle_ms"}} a step: each device
    event ``(start, end, category, correlation id)`` to the span holding
    its launch (``launched``: correlation id -> (thread, time)), each gap
    of the card's busy intervals to the span holding its start."""
    at = _innermost(spans)
    out = collections.defaultdict(
        lambda: {"device_ms": 0.0, "launches": 0.0, "idle_ms": 0.0})
    end = None
    for start, stop, cat, corr in sorted(device):
        phase = out[at(launched[corr][1]) if corr in launched else OUTSIDE]
        phase["device_ms"] += (stop - start) / 1e3 / steps
        phase["launches"] += (cat == "kernel") / steps
        if end is not None and start > end:
            out[at(end)]["idle_ms"] += (start - end) / 1e3 / steps
        end = stop if end is None else max(end, stop)
    return dict(out)


def summarize(trace_dir: str, json_out: str = "", families=None) -> dict:
    """Read ``trace_dir/trace.json`` and ``step.json``, print the breakdown
    a step and return it (and write it to ``json_out``): ``ms_per_step``,
    ``launches_per_step``, ``by_family_ms``, ``launches_by_family``,
    ``top_kernels`` (the ``TOP_KERNELS`` longest by total time, ms and
    calls a step), ``counted_ops`` ({"convolutions" | "matrix products":
    {dtype: operations a step}}, ``None`` where a call's shapes were not
    in the trace), ``roofline`` ({family of ``ROOFLINE``: {"bound_ms",
    "measured_ms", "share"}}; bound and share ``None`` where the work is
    not counted), ``device``, ``peaks``, ``steps``."""
    from ..utils.profiling import (
        STEP_FAMILIES,
        bound_ms,
        device_peaks,
        kernel_family,
    )

    families = STEP_FAMILIES if families is None else families
    trace = os.path.join(trace_dir, "trace.json")
    if not os.path.isfile(trace):
        raise FileNotFoundError(f"no trace at {trace}")
    with open(trace) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    with open(os.path.join(trace_dir, "step.json")) as f:
        meta = json.load(f)
    steps = int(meta["steps"])
    peaks = device_peaks(meta.get("device", ""))

    device = []  # (name, category, us, correlation id) of each device event
    timeline = []  # (start, end, category, correlation id), the same
    launched = {}  # correlation id -> (tid, ts) of the host-side launch
    spans = collections.defaultdict(list)  # tid -> [(start, end, name, args)]
    program = []  # the program's spans, their host intervals
    for e in events:
        name, args, cat = e.get("name", ""), e.get("args", {}), e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append((name, cat, e.get("dur", 0.0),
                           args.get("correlation")))
            ts = e.get("ts", 0.0)
            timeline.append((ts, ts + e.get("dur", 0.0), cat,
                             args.get("correlation")))
        elif cat == "program_span" and e.get("tid") == "host":
            program.append(e)
        elif cat in LAUNCH_CATEGORIES and "correlation" in args:
            launched[args["correlation"]] = (e.get("tid"), e.get("ts", 0.0))
        elif name in CALL_FAMILIES:
            ts = e.get("ts", 0.0)
            spans[e.get("tid")].append((ts, ts + e.get("dur", 0.0), name,
                                        args))
    spans = {tid: _outermost(v) for tid, v in spans.items()}
    by_call = _call_families(spans, launched)

    by_family = {name: 0.0 for name, _ in families}
    by_family.update({fam: 0.0 for fam in CALL_FAMILIES.values()})
    by_family["other"] = 0.0
    launches = collections.Counter()
    kernels = {}  # name -> [us, calls]
    for name, cat, us, corr in device:
        family = kernel_family(name, families)
        if cat == "kernel":
            family = by_call.get(corr, family)
            launches[family] += 1
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += us
            k[1] += 1
        by_family[family] += us / 1e3
    op_work = {fam: collections.Counter() for fam in CALL_FAMILIES.values()}
    uncounted = set()
    for calls in spans.values():
        for _, _, name, args in calls:
            family = CALL_FAMILIES[name]
            flops, dtype = op_flops(name, args), _type_of(args)
            if flops is None or dtype is None:
                uncounted.add(family)
            else:
                op_work[family][dtype] += flops
    total = sum(by_family.values())
    out = {
        "ms_per_step": total / steps,
        "launches_per_step": sum(launches.values()) / steps,
        "by_family_ms": {k: v / steps for k, v in by_family.items()},
        "launches_by_family": {k: v / steps for k, v in launches.items()},
        "top_kernels": [
            {"name": name, "ms": us / 1e3 / steps, "calls": n / steps}
            for name, (us, n) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]],
        "device": meta.get("device"), "peaks": peaks, "steps": steps,
        "shapes": meta,
        "counted_ops": {
            family: ({k: v / steps for k, v in counts.items()}
                     if family not in uncounted else None)
            for family, counts in op_work.items()},
    }
    work = {family: (0, out["counted_ops"][family])
            for family, counts in op_work.items()
            if counts and family not in uncounted}
    work.update(analytic_work(meta, out["launches_by_family"]))
    roofline = {}
    for what in ROOFLINE:
        ms_on_card = out["by_family_ms"].get(what, 0.0)
        if peaks is None or what not in work or ms_on_card <= 0.0:
            roofline[what] = {"bound_ms": None, "measured_ms": ms_on_card,
                              "share": None}
            continue
        ms, _ = bound_ms(*work[what], peaks)
        roofline[what] = {"bound_ms": ms, "measured_ms": ms_on_card,
                          "share": ms / ms_on_card}
    out["roofline"] = roofline
    out["phases"] = phase_table(program, timeline, launched, steps)

    call, a_call = (("evaluation", "an evaluation") if meta.get("evaluation")
                    else ("step", "a step"))
    print(f"device time {out['ms_per_step']:.2f} ms {a_call} over {steps} "
          f"{call}s, {out['launches_per_step']:.0f} kernels {a_call} "
          f"({out['device']})")
    for family, ms in sorted(out["by_family_ms"].items(),
                             key=lambda kv: -kv[1]):
        print(f"{ms:9.3f} ms/step  {family}")
    print("roofline (bound over the family's device time):")
    for what, roof in roofline.items():
        if roof["share"] is not None:
            print(f"  {what}: bound {roof['bound_ms']:.3f} ms of "
                  f"{roof['measured_ms']:.3f} ms a step "
                  f"({roof['share'] * 100:.1f}%)")
    print(f"the {TOP_KERNELS} longest kernels (ms a step, calls a step):")
    for k in out["top_kernels"]:
        print(f"  {k['ms']:8.3f} ms  {k['calls']:6.1f}  {k['name'][:110]}")
    print("by phase (the span holding the launch; idle: the span the host "
          f"was in when the card's gap began), {a_call}:")
    print(f"  {'device ms':>10} {'launches':>9} {'idle ms':>9}  phase")
    for name, p in sorted(out["phases"].items(),
                          key=lambda kv: -kv[1]["device_ms"]):
        print(f"  {p['device_ms']:10.3f} {p['launches']:9.1f} "
              f"{p['idle_ms']:9.3f}  {name}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {json_out}")
    return out


def time_spans(fn, steps: int, json_out: str = "",
               call: str = "step") -> dict:
    """``fn`` with the profiler off, ``SPAN_ROUNDS`` turns of ``steps``
    calls without spans and as many with them, in turns (off first, then
    on first): ``{"off_ms", "on_ms"}`` (each turn's ms a call, from a
    synchronised start to a synchronised end), ``cost_ms`` (the medians'
    difference) and ``spans`` ({name: {"host_ms", "device_ms"}} a call
    over the turns with spans; ``device_ms`` ``None`` without a card).
    ``call``: what one call is, for the printout."""
    a_call = ("an " if call[0] in "aeiou" else "a ") + call
    import torch

    from ..utils import profiling

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    times = {"off": [], "on": []}
    profiling.clear_spans()
    for turn in range(SPAN_ROUNDS):
        for mode in ("off", "on") if turn % 2 == 0 else ("on", "off"):
            with (profiling.recording() if mode == "on"
                  else contextlib.nullcontext()):
                sync()
                t0 = time.perf_counter()
                for _ in range(steps):
                    fn()
                sync()
                times[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    calls = SPAN_ROUNDS * steps
    by_name = {}
    for rec in profiling.recordings():
        for s in rec["spans"]:
            row = by_name.setdefault(s["name"], {"host_ms": 0.0,
                                                 "device_ms": 0.0})
            row["host_ms"] += s["host_ms"] / calls
            if s["device_ms"] is None or row["device_ms"] is None:
                row["device_ms"] = None
            else:
                row["device_ms"] += s["device_ms"] / calls
    off, on = statistics.median(times["off"]), statistics.median(times["on"])
    out = {"off_ms": times["off"], "on_ms": times["on"],
           "cost_ms": on - off, "steps": steps, "turns": SPAN_ROUNDS,
           "spans": by_name}
    print(f"profiler off, {SPAN_ROUNDS} turns of {steps} {call}s each way: "
          f"spans off {off:.3f} ms {a_call}, on {on:.3f} (cost "
          f"{on - off:+.3f} ms, {100 * (on - off) / off:+.2f}%)")
    print(f"  off turns {[round(t, 3) for t in times['off']]}, on turns "
          f"{[round(t, 3) for t in times['on']]}")
    print(f"  {'host ms':>9} {'device ms':>10}  span ({a_call}, spans on)")
    for name, row in by_name.items():
        dev = ("-" if row["device_ms"] is None
               else f"{row['device_ms']:.3f}")
        print(f"  {row['host_ms']:9.3f} {dev:>10}  {name}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {json_out}")
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="profile the flagship's bf16 train step")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=os.path.join("build",
                                                      "profile_step"),
                        help="directory of the trace (trace.json, "
                        "step.json)")
    parser.add_argument("--json-out", default="",
                        help="write the breakdown as JSON here")
    parser.add_argument("--summarize-only", action="store_true",
                        help="re-read the trace under --out without "
                        "running the step")
    parser.add_argument("--spans", action="store_true",
                        help="no trace: time the steps with the spans off "
                        "and on, in turns, and print each span's host "
                        "and device ms a step")
    parser.add_argument("--eval", action="store_true",
                        help="a whole evaluation (build_eval) in place of "
                        "the train step; --steps counts evaluations")
    parser.add_argument("--model", default="", choices=["", "vit",
                                                        "fullclip"],
                        help="flagship variant (config/flagship.py)")
    parser.add_argument("--fused-attn", action="store_true",
                        help="TPU.FUSED_ATTENTION (transformer variants)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Profile (unless ``--summarize-only``) and summarize, or with
    ``--spans`` time the spans; returns the breakdown."""
    args = parse_args(argv)
    if not args.summarize_only:
        if args.eval:
            fn, meta = build_eval(args.model, args.fused_attn, args.device)
        else:
            step, state, batch, meta = build_step(args.model,
                                                  args.fused_attn,
                                                  args.device)

            def fn():
                step(state, batch)
        fn()  # the warm-up call, outside the trace
        if args.spans:
            return time_spans(fn, args.steps, args.json_out,
                              "evaluation" if args.eval else "step")
        capture(fn, args.steps, args.out, meta)
    return summarize(args.out, args.json_out)


if __name__ == "__main__":
    main()
