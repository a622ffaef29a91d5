"""Time K2 (the f32 streaming top-k) and K4 (its int8-gallery form) against
the kernels they replaced, and variants of ``csrc/topk_similarity.cu``,
side by side.

A development aid.  The kernels they replaced (8-query blocks, synchronous
tiles, a second launch to merge; ``csrc/topk_tile8.cu``) stay in the port's
library under their own entry points, reached by no path but this module's
:func:`tile8_f32` and :func:`tile8_int8` (with their own split rule), so one
process times new and old in turns (old, new, new, old) on the same inputs
at D = 256, k = 10: one query and 256 queries over 3,074 and 98,304 rows,
as the host issues the launches and queued behind a device sleep (the
device's time, where the wrapper's host time is longer than the kernel).
With ``--breakdown`` it builds a copy instrumented with ``clock64`` and
launches it once at each shape: block (0, 0)'s warps print their cycles by
phase, and each query tile's last block those of the merge of the splits'
lists.  With ``--search-against`` another checkout (e.g. the parent
commit unpacked by ``git archive`` under ``build/``), it times one
``index.search`` of 256 queries over 98,304 rows there and here, in turns,
each in its own process.  With ``--variants`` it also builds text-patched
copies of
``topk_similarity.cu`` (the one marked "wrong" skips work and is there for
its time alone: without the selection, the share of a call spent choosing
the top-k) into ``build/int8_variants/`` (as that tool's) and times each
one's entry points the same way.  Needs a card:

    python -m textreid_torch.tools.topk_variants [--variants] [--breakdown]
        [--search-against OTHER_CHECKOUT]

Prints the card's name and power limit, each shape's plan, then the times.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, ranking
from ..ops.quant import quantize_rows
from .int8_variants import _ms, _start_build, queued_ms

# (Q, G) at D = 256, k = 10: a lone /search and a micro-batch, over the
# CUHK-PEDES test gallery and a ~100k-row one
SHAPES = ((1, 3074), (1, 98304), (256, 3074), (256, 98304))
DIM, K = 256, 10
VARIANTS = {  # name: [(text, replacement), ...] of topk_similarity.cu
    "as committed": [],
    # deliberately wrong, for the time alone: the scores are computed, but
    # none reaches a list (the share of a call that the selection takes)
    "without the selection (wrong)": [
        ("if (ranks_above(acc[e], row, th.v, th.i)) pending |= 1u << e;",
         "if (acc[e] > 3.0e38f) pending |= 1u << e;")],
}


# The breakdown: block (0, 0)'s warps 0, 3 and 7 print their cycles
# (clock64) waiting for stages, in the products, comparing scores with the
# thresholds, appending, at the per-tile barrier and in fold rounds, and
# the last block of each query tile those of the merge of the splits' lists
BREAKDOWN = [
    ("#include <mutex>", "#include <mutex>\n#include <cstdio>"),
    ("  const int rb = warp % S::RB, qb = warp / S::RB;\n  int it = 0;",
     "  const int rb = warp % S::RB, qb = warp / S::RB;\n  int it = 0;\n"
     "  long long t_wait = 0, t_math = 0, t_pend = 0, t_app = 0, t_bar = 0,"
     " t_fold = 0, t0 = 0, t1 = 0;\n  int rounds = 0;"),
    ("      mbar_wait(&full[s], (it / stages) & 1);",
     "      t0 = clock64();\n      mbar_wait(&full[s], (it / stages) & 1);\n"
     "      t_wait += clock64() - t0;\n      t0 = clock64();"),
    ("      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);",
     "      t_math += clock64() - t0;\n      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(&empty[s]);"),
    ("    // selection: the scores that beat their query's k-th entry",
     "    t0 = clock64();"),
    ("    // to the candidate buffers; a query's buffer is folded into its "
     "list",
     "    t1 = clock64();\n    t_pend += t1 - t0;\n    t0 = t1;"),
    ("    pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, "
     "cnt,\n                                 cands);\n"
     "    while (consumers_any(pending != 0)) {",
     "    pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, "
     "cnt,\n                                 cands);\n"
     "    t1 = clock64();\n    t_app += t1 - t0;\n    t0 = t1;\n"
     "    while (true) {\n"
     "      const bool more = consumers_any(pending != 0);\n"
     "      t1 = clock64();\n      t_bar += t1 - t0;\n      t0 = t1;\n"
     "      if (!more) break;\n      ++rounds;"),
    ("      pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, "
     "cnt,\n                                   cands);\n    }\n  }\n"
     "  consumers_sync();",
     "      pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, "
     "cnt,\n                                   cands);\n"
     "      t1 = clock64();\n      t_fold += t1 - t0;\n      t0 = t1;\n"
     "    }\n  }\n  consumers_sync();"),
    ("  if (splits == 1) return;",
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 &&\n"
     "      (warp == 0 || warp == 3 || warp == 7)) {\n"
     "    printf(\"  block (0, 0) warp %d, %d tiles: waiting %lld, products "
     "%lld, thresholds %lld, appends %lld, barrier %lld, fold rounds %lld (%d)"
     " cycles\\n\", warp, n_tiles, t_wait, t_math, t_pend, t_app, t_bar, "
     "t_fold, rounds);\n  }\n  if (splits == 1) return;"),
    ("  if (!misc[0]) return;\n  __threadfence();",
     "  if (!misc[0]) return;\n  __threadfence();\n"
     "  const long long t_merge = clock64();"),
    ("    consumers_sync();\n  }\n}\n\nusing KernelFn",
     "    consumers_sync();\n  }\n  if (tid == 0) {\n"
     "    printf(\"  last block (%d, %d): merge of the lists %lld cycles\\n\","
     " blockIdx.x, blockIdx.y, clock64() - t_merge);\n  }\n}\n\n"
     "using KernelFn"),
]


def tile8_splits(n_q: int, n_rows: int, sm_count: int,
                 tile_rows: int) -> int:
    """The replaced kernels' split rule: about two blocks an SM, at least 4
    tiles of ``tile_rows`` rows a split."""
    q_tiles = -(-n_q // 8)
    return max(1, min(2 * sm_count // q_tiles, -(-n_rows // tile_rows) // 4))


def _tile8_scratch(n_q, splits, k, dev):
    return (torch.empty(n_q, splits, k, device=dev),
            torch.empty(n_q, splits, k, dtype=torch.int32, device=dev))


def tile8_f32(queries, gallery, k, valid_gallery=0,
              compute_dtype=torch.float32):
    """``topk_similarity`` on the kernel it replaced (64-row tiles)."""
    n_q, dim = queries.shape
    n_g = gallery.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    dev = queries.device
    vals = torch.empty(n_q, k, device=dev)
    idx = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    splits = tile8_splits(n_q, valid, ranking._sm_count(dev.index), 64)
    part_vals, part_idx = _tile8_scratch(n_q, splits, k, dev)
    err = _build.library().topk_similarity_f32_tile8(
        queries.data_ptr(), gallery.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), part_vals.data_ptr(), part_idx.data_ptr(), n_q, n_g,
        dim, k, valid, splits, int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "topk_similarity_f32_tile8")
    return vals, idx


def tile8_int8(queries, values, scales, k, valid_gallery=0):
    """``topk_similarity_quantized`` on the kernel it replaced (128-row
    tiles)."""
    n_q, dim = queries.shape
    n_g = values.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    dev = queries.device
    vals = torch.empty(n_q, k, device=dev)
    idx = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    splits = tile8_splits(n_q, valid, ranking._sm_count(dev.index), 128)
    part_vals, part_idx = _tile8_scratch(n_q, splits, k, dev)
    err = _build.library().topk_similarity_int8_tile8(
        queries.data_ptr(), values.data_ptr(), scales.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), part_vals.data_ptr(),
        part_idx.data_ptr(), n_q, n_g, dim, k, valid, splits,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "topk_similarity_int8_tile8")
    return vals, idx


def unit_inputs(n_q, n_g, dim=DIM, seed=2):
    """Seeded unit queries and gallery on the card, with the gallery's int8
    form: ``(q, gallery, values, scales)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.nn.functional.normalize(
        torch.randn(n_q, dim, device="cuda", generator=g), dim=1)
    gal = torch.nn.functional.normalize(
        torch.randn(n_g, dim, device="cuda", generator=g), dim=1)
    quant = quantize_rows(gal)
    return q, gal, quant.values.contiguous(), quant.scales.contiguous()


def in_turns(new, old, reps):
    """(new, old) ms as issued and queued, timed old, new, new, old."""
    out = {}
    for name, timer in (("issued", _ms), ("queued", queued_ms)):
        o0, n0, n1, o1 = (timer(old, reps), timer(new, reps),
                          timer(new, reps), timer(old, reps))
        out[name] = ((n0 + n1) / 2, (o0 + o1) / 2)
    return out


def compare(n_q, n_g, reps=20):
    """K2 (f32) and K4 against the replaced kernels at one shape: {kernel:
    {"issued" | "queued": (new ms, old ms)}} and whether each pair's
    outputs agree (equal indices, scores within 1e-5)."""
    q, gal, values, scales = unit_inputs(n_q, n_g)
    calls = {
        "K2": (lambda: ranking.topk_similarity(q, gal, K),
               lambda: tile8_f32(q, gal, K)),
        "K4": (lambda: ranking.topk_similarity_quantized(q, values, scales,
                                                         K),
               lambda: tile8_int8(q, values, scales, K)),
    }
    out = {}
    for name, (new, old) in calls.items():
        (nv, ni), (ov, oi) = new(), old()
        agree = torch.equal(ni, oi) and (nv - ov).abs().max().item() <= 1e-5
        out[name] = dict(in_turns(new, old, reps), agree=agree)
    return out


def _variant_call(lib, entry, args):
    """A variant's entry point on ``args`` (f32: q, gallery; int8: q,
    values, scales), with the committed plan; returns (vals, idx)."""
    q = args[0]
    n_q, dim = q.shape
    n_g = args[1].shape[0]
    kind = "int8" if entry.endswith("int8") else "f32"
    plan = ranking.topk_plan(n_q, n_g, dim, ranking._sm_count(q.device.index),
                             kind)
    vals = torch.empty(n_q, K, device="cuda")
    idx = torch.empty(n_q, K, dtype=torch.int32, device="cuda")
    tickets, part_vals, part_idx = ranking._workspace(q.device, n_q, plan, K)
    ptrs = [t.data_ptr() for t in args] + [vals.data_ptr(), idx.data_ptr(),
                                          part_vals, part_idx, tickets]
    tail = [n_q, n_g, dim, K, n_g, plan.q_tile, plan.splits]
    if kind == "f32":
        tail.append(0)

    def call():
        err = getattr(lib, entry)(*ptrs, *tail,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} variant: cudaError_t {err}")
        return vals, idx
    return call


def variants(reps=20) -> None:
    """Build every variant of topk_similarity.cu, then time each one's two
    entry points in turns at every shape, as issued and queued."""
    builds = {name: _start_build(f"topk {name}", edits,
                                 _build.CSRC / "topk_similarity.cu")
              for name, edits in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        lib = ctypes.CDLL(str(path))
        for entry in ("topk_similarity_f32", "topk_similarity_int8"):
            getattr(lib, entry).argtypes = list(_build.SIGNATURES[entry])
        libs[name] = lib
    for n_q, n_g in SHAPES:
        q, gal, values, scales = unit_inputs(n_q, n_g)
        for entry, args in (("topk_similarity_f32", (q, gal)),
                            ("topk_similarity_int8", (q, values, scales))):
            calls = {v: _variant_call(lib, entry, args)
                     for v, lib in libs.items()}
            times = {v: [] for v in calls}
            for _ in range(2):  # every variant twice, in turns
                for v, call in calls.items():
                    times[v].append((_ms(call, reps), queued_ms(call, reps)))
            for v in calls:
                issued, queued = (min(each) for each in zip(*times[v]))
                print(f"variant {v}: {entry} Q={n_q} G={n_g} D={DIM} k={K}: "
                      f"as issued {issued:.4f} ms, queued {queued:.4f} ms",
                      flush=True)


def breakdown() -> None:
    """Build the clock64-instrumented copy of topk_similarity.cu and launch
    each entry point once at every shape (k = 10): the kernel prints where
    its cycles go."""
    path, proc = _start_build("topk breakdown", BREAKDOWN,
                              _build.CSRC / "topk_similarity.cu")
    log, _ = proc.communicate()
    if proc.returncode:
        print(f"breakdown: nvcc failed\n{log[-2000:]}")
        return
    lib = ctypes.CDLL(str(path))
    for entry in ("topk_similarity_f32", "topk_similarity_int8"):
        getattr(lib, entry).argtypes = list(_build.SIGNATURES[entry])
    for n_q, n_g in SHAPES:
        q, gal, values, scales = unit_inputs(n_q, n_g)
        for entry, args in (("topk_similarity_f32", (q, gal)),
                            ("topk_similarity_int8", (q, values, scales))):
            print(f"breakdown {entry} Q={n_q} G={n_g} D={DIM} k={K}:",
                  flush=True)
            _variant_call(lib, entry, args)()
            torch.cuda.synchronize()  # flushes the kernel's printf


# One index.search of 256 queries (the server's MAX_BATCH) over 98,304 seeded
# unit rows, from the float and the int8 gallery, under the 2-layer-GRU
# serving model (seeded weights): host time around a synchronised call and
# the time between CUDA events around it, medians of 10 after 2.  Uses only
# what every checkout of the port has, so --search-against can run it in
# another checkout (argv: the checkout, its config file).
SEARCH = r"""
import json, os, sys, time
import numpy as np, torch
from textreid_torch.config import get_default_cfg
from textreid_torch.models import build_model
from textreid_torch.ops.quant import quantize_rows
from textreid_torch.serving import RetrievalIndex
from textreid_torch.utils.platform import compute_dtype
root, config = sys.argv[1:3]
cfg = get_default_cfg()
cfg.merge_from_file(config)
cfg.TPU.ALLOW_RANDOM_VOCAB = True
cfg.ROOT = os.path.join(root, "build", "topk_search")
model = build_model(cfg, "cuda", compute_dtype=compute_dtype(cfg, "cuda"))
model.eval()
os.makedirs(cfg.ROOT, exist_ok=True)
path = os.path.join(cfg.ROOT, "unit_98304.idx")
g = torch.Generator().manual_seed(9)
gallery = torch.nn.functional.normalize(torch.randn(98304, 256, generator=g),
                                        dim=1)
quant = quantize_rows(gallery)
with open(path, "wb") as f:
    np.savez(f, gallery=gallery.numpy(), meta=np.arange(98304),
             quant_values=quant.values.numpy(),
             quant_scales=quant.scales.numpy())
rng = np.random.RandomState(7)
ids = rng.randint(1, 512, (256, 105)).astype(np.int32)
lens = rng.randint(5, 106, 256).astype(np.int32)
out = {}
for quantize in (False, True):
    index = RetrievalIndex(model, quantize=quantize)
    index.load_index(path)
    host, device = [], []
    for i in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        index.search(ids, lens, k=10)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            host.append((time.perf_counter() - t0) * 1000)
            device.append(start.elapsed_time(end))
    out["int8" if quantize else "float"] = (float(np.median(host)),
                                            float(np.median(device)))
print(json.dumps(out))
"""
SEARCH_CONFIG = ("configs/cuhkpedes/"
                 "moco_gru2l_freeze_cliprn50_ls_bs128_2048.yaml")


def search_against(other: Path) -> None:
    """The 256-query search (SEARCH) in ``other``'s checkout and this one,
    in turns (other, this, this, other), each in its own process."""
    import json
    import os

    here = Path(__file__).resolve().parents[2]
    for tree in (other, here, here, other):
        tree = tree.resolve()
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run(
            [sys.executable, "-c", SEARCH, str(tree),
             str(tree / SEARCH_CONFIG)], cwd=tree, env=env,
            capture_output=True, text=True)
        if res.returncode:
            print(f"search in {tree}: failed\n{res.stderr[-2000:]}")
            continue
        times = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"index.search of 256 queries, k=10, 98304 rows, 2-layer GRU "
              f"model, in {tree}: " + ", ".join(
                  f"{kind} gallery {h:.3f} ms host, {d:.3f} ms between "
                  f"events" for kind, (h, d) in times.items()), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the variants")
    parser.add_argument("--breakdown", action="store_true",
                        help="also print the kernel's cycles by phase")
    parser.add_argument("--search-against", type=Path,
                        help="another checkout: time a 256-query "
                             "index.search there and here, in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_variants needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    sms = ranking._sm_count(torch.cuda.current_device())
    for n_q, n_g in SHAPES:
        plans = {kind: tuple(ranking.topk_plan(n_q, n_g, DIM, sms, kind))
                 for kind in ("f32", "int8")}
        for name, res in compare(n_q, n_g).items():
            (ni, oi), (nq, oq) = res["issued"], res["queued"]
            print(f"{name} Q={n_q} G={n_g} D={DIM} k={K} (plan {plans}): "
                  f"new {ni:.4f} ms as issued, {nq:.4f} queued; replaced "
                  f"kernel {oi:.4f} / {oq:.4f}; outputs agree: "
                  f"{res['agree']}", flush=True)
    if args.variants:
        variants()
    if args.breakdown:
        breakdown()
    if args.search_against:
        search_against(args.search_against)
    return 0


if __name__ == "__main__":
    sys.exit(main())
