#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths on one
CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which either passes or ends the script with a non-zero exit
before the result line:

1. Environment: the card (name, power limit), torch and CUDA versions, and
   the build of the hand-written kernels from ``textreid_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it, with the tolerances stated below: K1 and K2 at
   the serving shapes; K3 (the one-direction GRU scan) at T=105, H=512 and
   B=256, 128 and a ragged 37, with a non-zero h0 and both scan orders; K4
   (the int8 streaming top-k) at Q=256, D=256, G=3,074 and 98,304, k=10
   and 64, with duplicated rows; K5 and K6 at the ViT-B/16 shape (B=128,
   S=193, W=768, 12 heads) in bf16 and f32 and at the causal CLIP-text
   shape (B=128, S=77, W=512, 8 heads); K1's and K3's autograd paths
   (kernel forward, plain recompute backward) against autograd through the
   plain versions.
3. The serving slice through its entry points at the flagship width
   (``flagship_cfg("")``: CLIP RN50 at 384x128, bi-GRU H=512, T=105,
   seeded weights): ``textreid_torch.tools.build_index`` on a synthetic
   CUHK-PEDES test split, ``textreid_torch.tools.serve`` booted in-process
   on port 0, HTTP ``/search`` and ``/search_image`` requests.  The kernels'
   launch counters are zeroed just before and read just after; the same
   queries through the plain versions on the card must agree.
4. Timings with CUDA events (kernels) or the host clock around work that
   ends in a synchronize (gallery encode, /search latency).
5. The evaluation slice through ``textreid_torch.test_net.main`` at the
   full width of ``configs/cuhkpedes/moco_gru2l_freeze_cliprn50_ls_bs128_
   2048.yaml`` (CLIP RN50 at 384x128, 2-layer bi-GRU H=512, T=105, bf16
   towers, seeded weights, random frozen token table) on a synthetic test
   split of 64 identities x 4 images: K3 twice and K1 once per eval batch;
   the four-column grid finite; the cached result replayed to the same
   grid; the same run through the plain versions to the same similarity
   matrix and grid.
6. Int8-gallery serving of the same model: ``build_index --quantize``,
   ``serve --quantize``, ``/search`` and ``/search_image``: K3, K1 and K4
   launched, K2 not; replies equal to the plain path on the card, and each
   returned id's float score within the int8 error of its quantized one.
   Then ``/search`` latency from the int8 gallery at 3,074 and 98,304 rows,
   and the index's search time from the float and the int8 gallery.
7. The training slice through ``textreid_torch.train_net.main`` at full
   width (``configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_2048.yaml``:
   ViT-B/16 at 384x128 + bi-GRU H=512, MoCo K=2048, batch 128, bf16
   towers, seeded weights, random frozen token table) on a synthetic
   CUHK-PEDES train split, for a few steps.  Launch counters are zeroed
   just before and read just after: K1 2, K5 24 and K6 12 per step.
   Losses must be finite, the queue pointer advanced, the checkpoint
   written.
8. One f32 step with the kernels against one with their plain versions,
   from the same state and batch: loss dicts and every parameter's update.
9. Step time (median, bf16, after warmup) with the kernels and with their
   plain versions, peak device memory, and the share of K1's plain
   recompute backward.
10. The ``kernels`` line: for each of the six kernels its launches on the
    driven paths, its error, its time beside its plain version's, its
    roofline bound computed from the timed shapes (bytes over 3.35 TB/s
    against operations over the peak rate of the input type), and the time
    of the one PyTorch call that computes the same function where there is
    one (a yardstick only: nothing in the port calls it).

The last line of standard output is the result JSON.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""

import base64
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# Stated tolerances (kernel against its plain version, same inputs, same card)
K1_TOL = {"float32": 1e-5,   # same f32 math, another summation order
          "bfloat16": 8e-3}  # f32 inside, one bf16 rounding of the output:
                             # 2 ulp of bf16 below 1.0 (h is tanh-bounded)
K2_TOL = 1e-5                # f32 dot products of length 256
K4_RTOL = 1e-5               # exact bf16 x int8 products, f32 sums of 256
                             # terms in another order than the matmul's
K4_ATOL = 1e-6               # ... whose terms cancel where a cosine is near 0
SLICE_TOL = 1e-4             # served scores against the plain path
DEEP_SLICE_TOL = 1e-3        # ... of a multi-layer bf16 text tower (see
                             # EVAL_SIM_TOL)
# K5/K6, max |kernel - plain| over max |plain| (the values are O(1)):
ATTN_TOL = {"float32": 1e-5,   # same f32 math, another summation order
            "bfloat16": 8e-3}  # p, ds and the outputs rounded to bf16 at
                               # the same points; a last-bit difference of
                               # an f32 sum moves one rounding by one ulp
                               # (2^-8 relative), so 2 ulp
K1_GRAD_TOL = 1e-5           # f32: the backward IS the plain recompute;
                             # only the forward differs, by <= 1e-5
STEP_LOSS_RTOL = 1e-4        # f32 step, kernels vs plain: loss values
# f32 step, kernels vs plain: ||update_kernel - update_plain|| over
# ||update_plain|| per parameter, over the entries whose gradient (weight
# decay included) is above 1e-6; below it Adam's g / (|g| + 1e-8) follows
# rounding noise (the attention's key bias has an exactly zero gradient)
STEP_UPDATE_RTOL = 1e-3
NOISE_FLOOR = 1e-6
VIT_YAML = "configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_2048.yaml"
TRAIN_STEPS = 3
SPLIT_IDS, SPLIT_IMAGES_PER_ID = 64, 4  # the synthetic test splits
GRU2L_YAML = "configs/cuhkpedes/moco_gru2l_freeze_cliprn50_ls_bs128_2048.yaml"
# eval through the kernels against eval through their plain versions, bf16
# towers: one bf16 ulp in a hidden state moves an embedding by ~1e-3
EVAL_SIM_TOL = 1e-3
# ... and may swap two gallery rows whose similarities are that close, so
# the CMC/mAP grids agree to this many percent points, not exactly
EVAL_GRID_TOL = 1.0
# the card's peaks (NVIDIA H100 SXM data sheet, dense): the roofline bounds
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}


def bound(n_bytes, n_ops, dtype_name):
    """(bound ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype_name``."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_OPS_S[dtype_name] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def fail(msg):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, after a warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel, plain, reps_kernel, reps_plain):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p0 = cuda_ms(plain, reps_plain)
    k0 = cuda_ms(kernel, reps_kernel)
    k1 = cuda_ms(kernel, reps_kernel)
    p1 = cuda_ms(plain, reps_plain)
    return (k0 + k1) / 2, (p0 + p1) / 2


# -- phase 2: kernels against their plain versions ---------------------------

def k1_inputs(batch, dtype, seed, seq=105, hidden=512):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def gates():
        return (torch.randn(batch, seq, 3 * hidden, device=dev, generator=g)
                * 0.6).to(dtype)

    def weight():
        w = torch.rand(hidden, 3 * hidden, device=dev, generator=g) * 2 - 1
        return (w / math.sqrt(hidden)).to(dtype)

    lengths = torch.randint(1, seq + 1, (batch,), device=dev, generator=g,
                            dtype=torch.int32)
    lengths[0] = seq  # a full-length row
    return gates(), gates(), weight(), weight(), lengths


def check_k1():
    import torch
    from textreid_torch.ops import gru

    worst = {}
    for batch in (64, 256):
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_inputs(batch, dtype, seed=batch)
            # the wrapper with serving's pool rule; the plain scan + the rule
            got = gru.bigru_pooled_scan(*args, pool_mode="always")
            want = gru.zero_participation(gru.bigru_pooled_scan_plain(*args),
                                          args[4], 105, "always")
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K1 B={batch} {name}: {got.shape}/{got.dtype} vs "
                     f"{want.shape}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            log(f"K1 bigru_pooled_fwd B={batch} T=105 H=512 {name}: "
                f"max_abs_err={err:.3e} (tol {K1_TOL[name]:.0e})")
            if not math.isfinite(err) or err > K1_TOL[name]:
                fail(f"K1 B={batch} {name} disagrees with its plain version")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def k2_inputs(n_g, seed, n_q=256, dim=256, duplicates=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit(n):
        x = torch.randn(n, dim, device="cuda", generator=g)
        return x / x.norm(dim=1, keepdim=True)

    q, gal = unit(n_q), unit(n_g)
    if duplicates:  # exact score ties: the larger row must rank first
        gal[n_g // 2:n_g // 2 + 64] = gal[:64]
        gal[n_g - 1] = gal[3]
        q[:8] = gal[:8]
    return q.contiguous(), gal.contiguous()


def check_k2():
    import torch
    from textreid_torch.ops import ranking

    cases = [(3074, k, 0, False) for k in (1, 10, 64)]
    cases += [(98304, k, 0, False) for k in (1, 10, 64)]
    cases += [(1001, 10, 990, False),   # ragged G, masked tail
              (40, 64, 0, False),       # k > G: sentinel slots
              (3074, 10, 0, True)]      # duplicated rows: exact ties
    worst = 0.0
    for n_g, k, valid, dup in cases:
        q, gal = k2_inputs(n_g, seed=n_g + k, duplicates=dup)
        vals, idx = ranking.topk_similarity(q, gal, k, valid)
        pv, pi = ranking.topk_similarity_plain(q, gal, k, valid)
        torch.cuda.synchronize()
        err = (vals - pv).abs().max().item()
        n_valid = valid or n_g
        scores = q @ gal[:n_valid].T
        swapped = (idx != pi)
        bad = 0
        for r, j in swapped.nonzero().tolist():
            i_k, i_p = idx[r, j].item(), pi[r, j].item()
            if i_k < 0 or i_p < 0 or abs(
                    scores[r, i_k].item() - scores[r, i_p].item()) > K2_TOL:
                bad += 1
        ties_ok = True
        if dup:  # rows 3 and n_g-1 hold one vector: n_g-1 must come first
            row3 = idx[3].tolist()
            ties_ok = row3.index(n_g - 1) < row3.index(3)
        log(f"K2 topk_similarity_f32 Q=256 D=256 G={n_g} k={k} "
            f"valid={n_valid}{' dup' if dup else ''}: max_abs_err={err:.3e} "
            f"(tol {K2_TOL:.0e}), index mismatches={int(swapped.sum())} "
            f"(non-tie {bad}), tie order ok={ties_ok}")
        if not math.isfinite(err) or err > K2_TOL or bad or not ties_ok:
            fail(f"K2 G={n_g} k={k} disagrees with its plain version")
        worst = max(worst, err)
    return worst


def attn_inputs(batch, seq, width, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, seq, 3 * width, device="cuda", generator=g)
    grad = torch.randn(batch, seq, width, device="cuda", generator=g)
    return qkv.to(dtype), grad.to(dtype)


ATTN_CASES = [  # (name, batch, seq, width, heads, causal)
    ("ViT-B/16", 128, 193, 768, 12, False),
    ("CLIP text", 128, 77, 512, 8, True),
]


def check_attention():
    """K5 and K6 against their plain versions; returns the worst absolute
    error per (kernel, dtype)."""
    import torch
    from textreid_torch.ops import attention as A

    worst = {}
    for name, batch, seq, width, heads, causal in ATTN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            qkv, g = attn_inputs(batch, seq, width, dtype, seed=seq)
            pairs = (("K5", A.fused_attention(qkv, heads, causal),
                      A.fused_attention_plain(qkv, heads, causal)),
                     ("K6", A.fused_attention_bwd(qkv, g, heads, causal),
                      A.fused_attention_bwd_plain(qkv, g, heads, causal)))
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[1]
            for kname, got, want in pairs:
                if got.shape != want.shape or got.dtype != want.dtype:
                    fail(f"{kname} {name} {dname}: {got.shape}/{got.dtype} "
                         f"vs {want.shape}/{want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                log(f"{kname} {name} B={batch} S={seq} W={width} H={heads} "
                    f"causal={causal} {dname}: max_abs_err={err:.3e}, "
                    f"relative {err / scale:.3e} (tol {ATTN_TOL[dname]:.0e})")
                if not math.isfinite(err) or err > ATTN_TOL[dname] * scale:
                    fail(f"{kname} {name} {dname} disagrees with its plain "
                         "version")
                if name == "ViT-B/16":
                    worst[(kname, dname)] = err
    return worst


def check_k1_grad():
    """K1's autograd Function (kernel forward, plain recompute backward)
    against autograd through the plain version, f32, training shapes."""
    import torch
    from textreid_torch.ops import gru

    args = k1_inputs(128, torch.float32, seed=9)
    g = torch.randn(128, 1024, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    out = gru.bigru_pooled_scan(*leaves, args[4], pool_mode="batch")
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    ref = gru.zero_participation(
        gru.bigru_pooled_scan_plain(*ref_leaves, args[4]), args[4], 105,
        "batch")
    want = torch.autograd.grad(ref, ref_leaves, g)
    worst = 0.0
    for name, a, b in zip(("xf", "xb", "w_f", "w_b"), got, want):
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        worst = max(worst, err)
        if a.grad_fn is not None or not math.isfinite(err) or (
                err > K1_GRAD_TOL) or b.abs().max().item() == 0:
            fail(f"K1 autograd: d/d{name} off by {err:.3e}")
    log(f"K1 autograd B=128 T=105 H=512 f32: gradients of xf, xb, w_f, w_b "
        f"within {worst:.3e} of autograd through the plain version "
        f"(tol {K1_GRAD_TOL:.0e})")
    return worst


def k3_inputs(batch, dtype, seed, seq=105, hidden=512):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, seq, 3 * hidden, device="cuda", generator=g)
         * 0.6).to(dtype)
    w = torch.rand(hidden, 3 * hidden, device="cuda", generator=g) * 2 - 1
    h0 = torch.randn(batch, hidden, device="cuda", generator=g) * 0.5
    return x, (w / math.sqrt(hidden)).to(dtype), h0.to(dtype)


def check_k3():
    """K3 against its plain version (f32 and bf16; B=256, 128 and a ragged
    B; non-zero h0; both scan orders), then the Function's gradient against
    autograd through the plain version."""
    import torch
    from textreid_torch.ops import gru

    worst = {}
    for batch, reverse in ((256, False), (128, True), (37, False)):
        for dtype in (torch.float32, torch.bfloat16):
            args = k3_inputs(batch, dtype, seed=batch)
            got = gru.gru_scan(*args, reverse=reverse)
            want = gru.gru_scan_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K3 B={batch} {name}: {got.shape}/{got.dtype} vs "
                     f"{want.shape}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            log(f"K3 gru_scan_fwd B={batch} T=105 H=512 reverse={reverse} "
                f"{name}: max_abs_err={err:.3e} (tol {K1_TOL[name]:.0e})")
            if not math.isfinite(err) or err > K1_TOL[name]:
                fail(f"K3 B={batch} {name} disagrees with its plain version")
            worst[name] = max(worst.get(name, 0.0), err)

    args = k3_inputs(128, torch.float32, seed=5)
    g = torch.randn(128, 105, 512, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in args]
    got = torch.autograd.grad(gru.gru_scan(*leaves), leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(gru.gru_scan_plain(*ref_leaves), ref_leaves, g)
    grad_err = 0.0
    for name, a, b in zip(("x_gates", "w_h", "h0"), got, want):
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        grad_err = max(grad_err, err)
        if not math.isfinite(err) or err > K1_GRAD_TOL or (
                b.abs().max().item() == 0):
            fail(f"K3 autograd: d/d{name} off by {err:.3e}")
    log(f"K3 autograd B=128 T=105 H=512 f32: gradients of x_gates, w_h, h0 "
        f"within {grad_err:.3e} of autograd through the plain version "
        f"(tol {K1_GRAD_TOL:.0e})")
    return worst


def k4_inputs(n_g, seed, n_q=256, dim=256, duplicates=False):
    """Unit queries and a quantized unit gallery (``quantize_rows``)."""
    from textreid_torch.ops.quant import quantize_rows

    q, gal = k2_inputs(n_g, seed, n_q, dim, duplicates)
    quant = quantize_rows(gal)
    return q, quant.values.contiguous(), quant.scales.contiguous()


def check_k4():
    """K4 against its plain version: scores within K4_RTOL relative (plus
    K4_ATOL for cosines near zero), indices equal except within sets of
    equal scores."""
    import torch
    from textreid_torch.ops import ranking
    from textreid_torch.ops.quant import QuantizedGallery, quantized_scores

    cases = [(3074, k, 0, False) for k in (10, 64)]
    cases += [(98304, k, 0, False) for k in (10, 64)]
    cases += [(1001, 10, 990, False),   # ragged G, masked tail
              (40, 64, 0, False),       # k > G: sentinel slots
              (3074, 10, 0, True)]      # duplicated rows: exact ties
    worst = 0.0
    for n_g, k, valid, dup in cases:
        q, values, scales = k4_inputs(n_g, seed=n_g + k, duplicates=dup)
        vals, idx = ranking.topk_similarity_quantized(q, values, scales, k,
                                                      valid)
        pv, pi = ranking.topk_similarity_quantized_plain(q, values, scales, k,
                                                         valid)
        torch.cuda.synchronize()
        real = pi >= 0
        if not torch.equal(real, idx >= 0):
            fail(f"K4 G={n_g} k={k}: sentinel slots differ")
        # |kernel - plain| over its allowance (1.0 = at the limit)
        err = ((vals - pv).abs() / (K4_RTOL * pv.abs() + K4_ATOL))[
            real].max().item()
        if not torch.equal(vals[~real], pv[~real]):
            fail(f"K4 G={n_g} k={k}: sentinel scores differ")
        n_valid = valid or n_g
        scores = quantized_scores(q, QuantizedGallery(values[:n_valid],
                                                      scales[:n_valid]))
        swapped = (idx != pi)
        bad = 0
        for r, j in swapped.nonzero().tolist():
            i_k, i_p = idx[r, j].item(), pi[r, j].item()
            s_k, s_p = scores[r, i_k].item(), scores[r, i_p].item()
            if i_k < 0 or i_p < 0 or abs(s_k - s_p) > (
                    K4_RTOL * abs(s_p) + K4_ATOL):
                bad += 1
        ties_ok = True
        if dup:  # rows 3 and n_g-1 hold one vector: n_g-1 must come first
            row3 = idx[3].tolist()
            ties_ok = row3.index(n_g - 1) < row3.index(3)
        log(f"K4 topk_similarity_int8 Q=256 D=256 G={n_g} k={k} "
            f"valid={n_valid}{' dup' if dup else ''}: worst error "
            f"{err:.3f} of its allowance (rtol {K4_RTOL:.0e} + atol "
            f"{K4_ATOL:.0e}), index mismatches={int(swapped.sum())} "
            f"(non-tie {bad}), tie order ok={ties_ok}")
        if not math.isfinite(err) or err > 1.0 or bad or not ties_ok:
            fail(f"K4 G={n_g} k={k} disagrees with its plain version")
        worst = max(worst, (vals - pv).abs()[real].max().item())
    return worst


# -- launch counters -----------------------------------------------------------

def wrappers():
    """Kernel entry point -> the wrapper that counts its launches."""
    from textreid_torch.ops import attention, gru, ranking

    return {"bigru_pooled_fwd": gru.bigru_pooled_scan,
            "gru_scan_fwd": gru.gru_scan,
            "topk_similarity_f32": ranking.topk_similarity,
            "topk_similarity_int8": ranking.topk_similarity_quantized,
            "fused_attention_fwd": attention.fused_attention,
            "fused_attention_bwd": attention.fused_attention_bwd}


def zero_counts():
    for wrapper in wrappers().values():
        wrapper.launches = 0


def read_counts(names=None):
    table = wrappers()
    return {name: table[name].launches for name in names or table}


SERVE_KERNELS = ("bigru_pooled_fwd", "topk_similarity_f32")
INT8_SERVE_KERNELS = ("gru_scan_fwd", "bigru_pooled_fwd",
                      "topk_similarity_int8", "topk_similarity_f32")
EVAL_KERNELS = ("gru_scan_fwd", "bigru_pooled_fwd")
TRAIN_KERNELS = ("bigru_pooled_fwd", "fused_attention_fwd",
                 "fused_attention_bwd")


# -- phase 3: the slice through its entry points ---------------------------

@contextmanager
def plain_kernels():
    """Route the encoder's scans and the index's ranking (float and int8)
    through their plain PyTorch versions, on the same card."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.serving as serving
    from textreid_torch.ops import gru, ranking

    def plain_scan(xf, xb, w_f, w_b, lengths, pool_mode):
        pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode)

    def plain_topk(queries, gallery, k=10, valid_gallery=0):
        return ranking.topk_similarity_plain(queries, gallery, k,
                                             valid_gallery)

    def plain_quantized_topk(queries, values, scales, k=10, valid_gallery=0):
        return ranking.topk_similarity_quantized_plain(
            queries, values, scales, k, valid_gallery)

    with mock.patch.object(gru_model, "bigru_pooled_scan", plain_scan), \
            mock.patch.object(gru_model, "gru_scan", gru.gru_scan_plain), \
            mock.patch.object(serving, "topk_similarity", plain_topk), \
            mock.patch.object(serving, "topk_similarity_quantized",
                              plain_quantized_topk):
        yield


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def check_reply(reply, n, k, meta_ids, what):
    scores = reply["scores"]
    if len(scores) != n or any(len(r) != k for r in scores):
        fail(f"{what}: scores shape is not [{n}, {k}]")
    if len(reply["meta"]) != n or any(len(r) != k for r in reply["meta"]):
        fail(f"{what}: meta shape is not [{n}, {k}]")
    real = min(k, len(meta_ids))  # slots past the gallery are sentinels
    for row, meta in zip(scores, reply["meta"]):
        if any(s is None or not math.isfinite(s) for s in row[:real]):
            fail(f"{what}: non-finite score {row}")
        if any(s is not None for s in row[real:]) or any(
                m != -1 for m in meta[real:]):
            fail(f"{what}: slots past the gallery are not sentinels")
        if any(b > a + 1e-6 for a, b in zip(row[:real], row[1:real])):
            fail(f"{what}: scores not sorted descending {row}")
        if not set(meta[:real]) <= meta_ids:
            fail(f"{what}: meta outside the index")


def agree_with_plain(reply, plain_scores, plain_meta, query_emb, index, what,
                     tol):
    """Served results against the plain path on the card: scores within
    ``tol``, meta equal except where two rows' plain scores tie within
    ``tol``."""
    real = min(plain_scores.shape[1], len(index.gallery_meta))
    got_s = np.asarray(reply["scores"], np.float64)[:, :real]
    got_m = np.asarray(reply["meta"])[:, :real]
    plain_scores, plain_meta = plain_scores[:, :real], plain_meta[:, :real]
    err = float(np.abs(got_s - plain_scores).max())
    row_of = {m: r for r, m in enumerate(index.gallery_meta.tolist())}
    if index.quantize:
        import torch
        from textreid_torch.ops.quant import quantized_scores

        full = quantized_scores(torch.from_numpy(query_emb).to(index.device),
                                index._quant_gallery).cpu().numpy()
    else:
        full = query_emb @ index.gallery.float().cpu().numpy().T
    swaps = 0
    for i, j in zip(*np.nonzero(got_m != plain_meta)):
        swaps += 1
        if abs(full[i, row_of[int(got_m[i, j])]] - plain_scores[i, j]) > tol:
            fail(f"{what}: meta {got_m[i, j]} at [{i},{j}] is not a tie of "
                 f"the plain path's {plain_meta[i, j]}")
    if err > tol:
        fail(f"{what}: scores differ from the plain path by {err:.3e}")
    return err, swaps


def write_config(root, quantized=False):
    """The flagship serving config, or the 2-layer-GRU model's YAML with
    what a synthetic workspace needs."""
    from textreid_torch.config import flagship_cfg, get_default_cfg

    if quantized:
        cfg = get_default_cfg()
        cfg.merge_from_file(os.path.join(REPO, GRU2L_YAML))
        cfg.TPU.ALLOW_RANDOM_VOCAB = True
    else:
        cfg = flagship_cfg("")
        cfg.TEST.IMS_PER_BATCH = 64
    cfg.DATASETS.TEST = ("cuhkpedes_test",)
    cfg.DATALOADER.NUM_WORKERS = 4
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, os.path.basename(GRU2L_YAML) if quantized
                        else "flagship.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    return cfg, path


def make_workspace(root, quantized):
    """Config, synthetic test split and seeded full-width checkpoint under
    ``root``; returns ``(root, cfg, config path, checkpoint path)``."""
    from textreid_torch.data import make_synthetic_dataset
    from textreid_torch.models import build_model
    from textreid_torch.utils.weight_convert import save_reference_checkpoint

    cfg, cfg_path = write_config(os.path.join(root, "configs", "cuhkpedes"),
                                 quantized)
    make_synthetic_dataset(
        os.path.join(root, "datasets", "cuhkpedes"),
        num_identities=SPLIT_IDS, images_per_id=SPLIT_IMAGES_PER_ID,
        image_size=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH),
        vocab_size=cfg.MODEL.GRU.VOCABULARY_SIZE, max_tokens=60, split="test")
    ckpt = os.path.join(root, "model.pth")
    save_reference_checkpoint(build_model(cfg, "cpu"), ckpt)  # seeded, f32
    return root, cfg, cfg_path, ckpt


def drive_slice(quantized=False, workspace=None):
    """build_index -> serve -> HTTP at full width: the flagship from a float
    gallery, or the 2-layer-GRU model from an int8 gallery
    (``--quantize``).  Returns the running (service, server, thread), the
    HTTP results and the launch counts of the run."""
    from textreid_torch.tools import build_index, serve

    root, cfg, cfg_path, ckpt = workspace or make_workspace(
        os.path.join(WORK, "serve"), quantized)
    height, width = cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH
    index_path = os.path.join(root, "gallery.idx")
    common = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
              ckpt, "--device", "cuda"] + (["--quantize"] if quantized else [])

    zero_counts()
    t0 = time.time()
    build_index.main(common + ["--output", index_path])
    service, server = serve.build_server(
        common + ["--index-file", index_path, "--port", "0",
                  "--k-buckets", "5,10,100", "--reload-dir", root])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]

    rng = np.random.RandomState(7)
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    text = []
    for n, k in [(1, 5), (3, 10), (16, 5), (8, 10), (2, 5), (5, 10), (1, 10),
                 (12, 5), (4, 100)]:
        lens = rng.randint(1, seq + 1, n).astype(np.int32)
        ids = np.zeros((n, seq), np.int32)
        for i, ln in enumerate(lens):
            ids[i, :ln] = rng.randint(1, cfg.MODEL.GRU.VOCABULARY_SIZE, ln)
        reply = post(base + "/search", {"token_ids": ids.tolist(),
                                        "lengths": lens.tolist(), "k": k})
        text.append((ids, lens, k, reply))
    images = []
    for n in (1, 2):
        pixels = rng.randint(0, 255, (n, height, width, 3), dtype=np.uint8)
        reply = post(base + "/search_image", {
            "images_b64": [base64.b64encode(p.tobytes()).decode()
                           for p in pixels], "k": 10})
        images.append((pixels, 10, reply))
    counts = read_counts(INT8_SERVE_KERNELS if quantized else SERVE_KERNELS)
    log(f"{'int8 ' if quantized else ''}slice: build_index + serve boot + "
        f"{len(text)} /search + {len(images)} /search_image in "
        f"{time.time() - t0:.1f} s; launches {counts}")
    return service, server, thread, base, text, images, counts


def check_slice(service, text, images, counts):
    index = service.index
    meta_ids = set(index.gallery_meta.tolist())
    for ids, lens, k, reply in text:
        check_reply(reply, len(ids), k, meta_ids, f"/search n={len(ids)} k={k}")
    for pixels, k, reply in images:
        check_reply(reply, len(pixels), k, meta_ids,
                    f"/search_image n={len(pixels)}")
    idle = ("topk_similarity_f32",) if index.quantize else ()
    for name, n in counts.items():
        if name in idle and n != 0:
            fail(f"the int8 path launched {name} {n} times")
        if name not in idle and n < 1:
            fail(f"the main path never launched {name}")

    # a 2-layer text tower in bf16 feeds layer 0's rounded states on: where
    # kernel and plain version round one of them apart, the query moves
    tol = DEEP_SLICE_TOL if index.model.textual_model.num_layers > 1 \
        else SLICE_TOL
    worst, swaps = 0.0, 0
    with plain_kernels():
        for ids, lens, k, reply in text:
            s, m = index.search(ids, lens, k=k)
            emb = index.encode_queries(ids, lens)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search", tol)
            worst, swaps = max(worst, e), swaps + w
        for pixels, k, reply in images:
            s, m = index.search_by_image(pixels, k=k)
            emb = index.encode_image_queries(pixels)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search_image",
                                    tol)
            worst, swaps = max(worst, e), swaps + w
    log(f"slice vs plain path on the card: max score diff {worst:.3e} "
        f"(tol {tol:.0e}), meta swaps within ties {swaps}")
    if index.quantize:
        check_int8_error(index, text)


def check_int8_error(index, text):
    """Each id the int8 gallery returned scores, from the float gallery,
    within the int8 rounding error of its quantized score: |q . (g -
    dequant(g))| <= ||q||_1 scale_g / 2, plus 2^-8 for the query's bf16
    rounding (unit vectors)."""
    gallery = index.gallery.float().cpu().numpy()
    scales = index._quant_gallery.scales.cpu().numpy()
    row_of = {m: r for r, m in enumerate(index.gallery_meta.tolist())}
    worst = 0.0
    for ids, lens, k, reply in text:
        emb = index.encode_queries(ids, lens)
        real = min(k, len(row_of))
        for i, (row, meta) in enumerate(zip(reply["scores"], reply["meta"])):
            for score, m in zip(row[:real], meta[:real]):
                g = row_of[m]
                err = abs(float(emb[i] @ gallery[g]) - score)
                allowed = 0.5 * scales[g] * np.abs(emb[i]).sum() + 2.0 ** -8
                worst = max(worst, err / allowed)
                if err > allowed:
                    fail(f"int8 score of id {m} is {err:.3e} from its float "
                         f"score (allowed {allowed:.3e})")
    log(f"int8 slice: float scores of the returned ids within "
        f"{worst:.3f} of the int8 rounding allowance")


# -- phase 4: timings -------------------------------------------------------

def time_kernels():
    import torch
    from textreid_torch.ops import gru, ranking

    out = {}
    for batch in (256, 64):  # the search bucket; encode_queries' chunk
        for dtype in (torch.bfloat16, torch.float32):
            args = k1_inputs(batch, dtype, seed=1)
            ms, plain_ms = interleaved_ms(
                lambda: gru.bigru_pooled_scan(*args, pool_mode="always"),
                lambda: gru.zero_participation(
                    gru.bigru_pooled_scan_plain(*args), args[4], 105,
                    "always"), 10, 3)
            name = str(dtype).split(".")[1]
            out[("K1", batch, name)] = (ms, plain_ms)
            log(f"time K1 B={batch} T=105 H=512 {name}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
    for batch in (256, 128):  # the search bucket; the eval batch
        for dtype in (torch.bfloat16, torch.float32):
            args = k3_inputs(batch, dtype, seed=1)
            ms, plain_ms = interleaved_ms(
                lambda: gru.gru_scan(*args),
                lambda: gru.gru_scan_plain(*args), 10, 3)
            name = str(dtype).split(".")[1]
            out[("K3", batch, name)] = (ms, plain_ms)
            log(f"time K3 B={batch} T=105 H=512 {name}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
    # one dependent step's latency: the slope of the time over T with one
    # cluster's worth of rows (B=8), where nothing but the chain waits
    for kname in ("K1", "K3"):
        ms_t = {}
        for seq in (5, 105):
            if kname == "K1":
                args = k1_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: gru.bigru_pooled_scan(
                    *args, pool_mode="always"), 20)
            else:
                args = k3_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: gru.gru_scan(*args), 20)
        step_us = (ms_t[105] - ms_t[5]) / 100 * 1e3
        out[(kname, "step_us")] = step_us
        log(f"time {kname} one dependent step (B=8, bf16, slope of T=5 -> "
            f"105): {step_us:.2f} us; the chain of 105 steps: "
            f"{105 * step_us / 1e3:.3f} ms")
    for n_g in (3074, 98304):
        q, gal = k2_inputs(n_g, seed=2)
        ms, plain_ms = interleaved_ms(
            lambda: ranking.topk_similarity(q, gal, 10),
            lambda: ranking.topk_similarity_plain(q, gal, 10), 20, 5)
        out[("K2", n_g)] = (ms, plain_ms)
        log(f"time K2 Q=256 D=256 G={n_g} k=10: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms ({n_g * 256 * 4 / ms / 1e6:.1f} GB/s "
            f"of gallery)")
        q, values, scales = k4_inputs(n_g, seed=2)
        ms, plain_ms = interleaved_ms(
            lambda: ranking.topk_similarity_quantized(q, values, scales, 10),
            lambda: ranking.topk_similarity_quantized_plain(
                q, values, scales, 10), 20, 5)
        out[("K4", n_g)] = (ms, plain_ms)
        log(f"time K4 Q=256 D=256 G={n_g} k=10: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms ({n_g * 256 / ms / 1e6:.1f} GB/s of "
            f"int8 gallery)")
    return out


def kernel_bounds():
    """Roofline bound (ms, what binds) of each kernel at the shape its row
    of the ``kernels`` line is timed at: every input read once, every
    output written once, against the operations of the function."""
    b, t, h = 256, 105, 512  # K1, K3: the /search bucket, bf16
    q, d, g, k = 256, 256, 3074, 10  # K2, K4: the 3,074-row gallery
    ab, s, w, heads = 128, 193, 768, 12  # K5, K6: ViT-B/16 at 384x128, bf16
    matmul = 2 * ab * heads * s * s * (w // heads)  # one [S,S] x [S,hd]
    return {
        # both directions: x and W read, the pooled [B, 2H] written;
        # T steps of [B, H] x [H, 3H]
        "bigru_pooled_fwd": bound(
            2 * (2 * b * t * 3 * h + 2 * h * 3 * h + b * 2 * h),
            2 * t * 2 * b * h * 3 * h, "bfloat16"),
        # one direction: x, W and h0 read, every h_t written
        "gru_scan_fwd": bound(
            2 * (b * t * 3 * h + h * 3 * h + b * h + b * t * h),
            t * 2 * b * h * 3 * h, "bfloat16"),
        "topk_similarity_f32": bound(
            4 * (q * d + g * d) + 8 * q * k, 2 * q * g * d, "float32"),
        # int8 rows and f32 scales; the products are bf16 x bf16
        "topk_similarity_int8": bound(
            4 * q * d + g * d + 4 * g + 8 * q * k, 2 * q * g * d, "bfloat16"),
        # qkv read, out written; QK^T and PV
        "fused_attention_fwd": bound(2 * ab * s * 4 * w, 2 * matmul,
                                     "bfloat16"),
        # qkv and g read, dqkv written; S, dP, dV, dQ, dK
        "fused_attention_bwd": bound(2 * ab * s * 7 * w, 5 * matmul,
                                     "bfloat16"),
    }


def time_serving(service, base, rows=3074, batch=128):
    """Gallery encode img/s of an in-memory gallery, then /search latency
    against it (swapped in over POST /reload_index)."""
    import torch
    from textreid_torch.serving import RetrievalIndex

    cfg_h, cfg_w = service.image_shape
    rng = np.random.RandomState(3)
    pixels = rng.randint(0, 255, (rows, cfg_h, cfg_w, 3), dtype=np.uint8)
    n_batches = -(-rows // batch)
    batches = [pixels[i * batch:(i + 1) * batch] for i in range(n_batches)]
    if len(batches[-1]) < batch:  # pad the tail, as build_index does
        pad = batch - len(batches[-1])
        batches[-1] = np.concatenate([batches[-1], batches[-1][-1:].repeat(
            pad, axis=0)])
    index = RetrievalIndex(service.index.model)
    index.build_gallery(batches[:1])  # warm cuDNN for this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build_gallery(batches, valid_rows=rows)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    img_s = rows / encode_s
    log(f"time gallery encode: {rows} images at batch {batch} in "
        f"{encode_s:.3f} s = {img_s:.1f} img/s")

    index.save_index(os.path.join(service.reload_dir, "gallery_3074.idx"))
    p50 = search_latency(service, base, "gallery_3074.idx", rows)
    return img_s, p50


def search_latency(service, base, file, rows):
    """Client p50 (ms) of single-query /search requests, k=10, against the
    index file swapped in over POST /reload_index."""
    reply = post(base + "/reload_index", {"file": file})
    if reply.get("gallery_rows") != rows:
        fail(f"/reload_index: {reply}")
    rng = np.random.RandomState(5)
    lat, device = [], []
    for i in range(60):
        ln = int(rng.randint(5, 60))
        ids = rng.randint(1, 512, (1, ln)).tolist()
        t0 = time.perf_counter()
        reply = post(base + "/search", {"token_ids": ids, "k": 10})
        if i >= 10:  # the first requests warm the path
            lat.append((time.perf_counter() - t0) * 1000)
            device.append(reply["device_ms"])
        if len(reply["scores"][0]) != 10:
            fail(f"/search on the {rows}-row gallery returned a short row")
    p50 = float(np.percentile(lat, 50))
    kind = "int8" if service.index.quantize else "float"
    log(f"time /search (1 query, k=10, {rows} rows, {kind} gallery, "
        f"{len(lat)} requests): client p50 {p50:.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms; device_ms p50 "
        f"{np.percentile(device, 50):.3f} ms")
    return p50


def write_unit_index(path, rows):
    """An index file of ``rows`` seeded 256-d unit vectors with its int8
    form, in the format of ``RetrievalIndex.save_index``."""
    import torch
    from textreid_torch.ops.quant import quantize_rows

    g = torch.Generator().manual_seed(9)
    gallery = torch.nn.functional.normalize(
        torch.randn(rows, 256, generator=g), dim=1)
    quant = quantize_rows(gallery)
    with open(path, "wb") as f:
        np.savez(f, gallery=gallery.numpy(), meta=np.arange(rows),
                 quant_values=quant.values.numpy(),
                 quant_scales=quant.scales.numpy())


def time_int8_serving(service, base):
    """/search latency from the int8 gallery at 3,074 and 98,304 rows, and
    the index's search time (one query, k=10; host clock around a
    synchronised call) from the float and the int8 form of each gallery
    under the same model."""
    import torch
    from textreid_torch.serving import RetrievalIndex

    out = {}
    model = service.index.model
    ids = np.random.RandomState(6).randint(1, 512, (1, 105)).astype(np.int32)
    lens = np.array([40], np.int32)
    for rows in (3074, 98304):
        file = f"unit_{rows}.idx"
        path = os.path.join(service.reload_dir, file)
        write_unit_index(path, rows)
        out[("p50", rows)] = search_latency(service, base, file, rows)
        for quantize in (False, True):
            index = RetrievalIndex(model, quantize=quantize)
            index.load_index(path)
            times = []
            for i in range(25):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                index.search(ids, lens, k=10)
                torch.cuda.synchronize()
                if i >= 5:
                    times.append((time.perf_counter() - t0) * 1000)
            out[("search", rows, quantize)] = float(np.median(times))
        log(f"time index.search (1 query in the 256 bucket, k=10, {rows} "
            f"rows, 2-layer GRU model): float gallery "
            f"{out[('search', rows, False)]:.3f} ms, int8 gallery "
            f"{out[('search', rows, True)]:.3f} ms (median of 20)")
    return out


# -- the evaluation slice ------------------------------------------------------

class GridCapture:
    """Collects what ``PersonSearch.inference`` logs: the metric grid is the
    last message of a run."""

    def __init__(self):
        import logging

        outer = self
        self.messages = []

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = Handler(logging.INFO)
        self.logger = logging.getLogger("PersonSearch.inference")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def grid(self):
        """{column: [CMC@1, CMC@5, CMC@10, mAP]} of the last logged table."""
        lines = [ln.split() for ln in self.messages[-1].strip().splitlines()]
        if lines[0] != ["topk", "t2i", "re_t2i", "i2t", "re_i2t"]:
            fail(f"eval grid columns: {lines[0]}")
        return {col: [float(ln[at]) for ln in lines[1:]]
                for at, col in enumerate(lines[0]) if at}


def drive_eval(workspace):
    """``textreid_torch.test_net.main`` on the card over the synthetic test
    split: a run that encodes and caches, a replay of the cache, and the
    same run through the plain versions of the kernels."""
    import torch
    from textreid_torch import test_net

    root, cfg, cfg_path, ckpt = workspace
    argv = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
            ckpt, "--device", "cuda", "--load-result"]
    cache = os.path.join(root, "output", "cuhkpedes",
                         os.path.basename(cfg_path)[:-5], "inference",
                         "cuhkpedes_test", "inference_data.npz")
    for stale in (cache, cache + ".kernels.npz"):
        if os.path.exists(stale):
            os.remove(stale)
    samples = SPLIT_IDS * SPLIT_IMAGES_PER_ID
    batches = -(-samples // cfg.TEST.IMS_PER_BATCH)

    with GridCapture() as cap:
        zero_counts()
        t0 = time.perf_counter()
        top1 = test_net.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(EVAL_KERNELS)
        grid = cap.grid()
        encode = [m for m in cap.messages if "Total inference time" in m]
        want = {"gru_scan_fwd": 2 * batches, "bigru_pooled_fwd": batches}
        if counts != want:
            fail(f"eval launches {counts}, expected {want}")
        if not os.path.isfile(cache) or not encode:
            fail("test_net --load-result wrote no inference_data.npz")
        for col, vals in grid.items():
            if len(vals) != 4 or not all(
                    math.isfinite(v) and 0.0 <= v <= 100.0 for v in vals):
                fail(f"eval grid column {col}: {vals}")
        if abs(top1["cuhkpedes_test"] - grid["t2i"][0]) > 0.006:
            fail(f"test_net returned {top1}, the grid says {grid['t2i'][0]}")
        log(f"eval slice: test_net.main on {samples} pairs in {batches} "
            f"batches of {cfg.TEST.IMS_PER_BATCH}, {wall:.1f} s; launches "
            f"{counts}; {encode[0]}; grid {grid}")

        zero_counts()
        cap.messages.clear()
        test_net.main(argv)
        if any(read_counts().values()) or not any(
                "Loading cached" in m for m in cap.messages):
            fail("--load-result did not replay the cache")
        if cap.grid() != grid:
            fail(f"the replayed grid differs: {cap.grid()} vs {grid}")

        os.replace(cache, cache + ".kernels.npz")
        with plain_kernels():
            zero_counts()
            test_net.main(argv)
            if any(read_counts().values()):
                fail("the plain eval run launched a kernel")
        plain_grid = cap.grid()
    with np.load(cache + ".kernels.npz") as a, np.load(cache) as b:
        sim_err = float(np.abs(a["similarity"] - b["similarity"]).max())
        shape = a["similarity"].shape
        finite = bool(np.isfinite(a["similarity"]).all())
    grid_err = max(abs(x - y) for col in grid
                   for x, y in zip(grid[col], plain_grid[col]))
    log(f"eval slice vs plain versions on the card: similarity {shape} "
        f"within {sim_err:.3e} (tol {EVAL_SIM_TOL:.0e}), grid within "
        f"{grid_err:.2f} points (tol {EVAL_GRID_TOL}); replay equal")
    if shape != (samples, samples) or not finite or sim_err > EVAL_SIM_TOL:
        fail("eval similarity disagrees with the plain versions")
    if grid_err > EVAL_GRID_TOL:
        fail(f"eval grids differ: {grid} vs {plain_grid}")
    return counts, grid


def time_eval(workspace, rows=3072, batch=128):
    """Encode seconds and img/s of the eval path (both towers per pair) at
    the YAML's batch, and the ranking and re-ranking time at the
    CUHK-PEDES test size (6,156 captions x 3,074 images)."""
    import torch
    from textreid_torch.engine.steps import encode_step
    from textreid_torch.evaluation.metrics import evaluation
    from textreid_torch.utils.bootstrap import build_eval_model
    from textreid_torch.utils.platform import compute_dtype

    root, cfg, cfg_path, ckpt = workspace
    model = build_eval_model(cfg, ckpt, "cuda", compute_dtype(cfg, "cuda"))
    rng = np.random.RandomState(8)
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    dev_batches = []
    for _ in range(4):  # 4 distinct device batches, cycled
        lens = rng.randint(5, 61, batch).astype(np.int32)
        ids = np.zeros((batch, seq), np.int32)
        for i, n in enumerate(lens):
            ids[i, :n] = rng.randint(1, 512, n)
        dev_batches.append({
            "pixels": torch.from_numpy(rng.randint(
                0, 255, (batch, cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH, 3),
                dtype=np.uint8)).cuda(),
            "token_ids": torch.from_numpy(ids).cuda(),
            "lengths": torch.from_numpy(lens).cuda()})
    encode_step(model, dev_batches[0])  # warm cuDNN
    torch.cuda.synchronize()
    steps = rows // batch
    zero_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        v, t = encode_step(model, dev_batches[i % 4])
        v.float().cpu(), t.float().cpu()  # as compute_embeddings drains them
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    counts = read_counts(EVAL_KERNELS)
    # the text tower alone, and its kernels alone, for the shares
    b0 = dev_batches[0]
    text_ms = cuda_ms(lambda: model.encode_text(b0["token_ids"],
                                                b0["lengths"]), 5)
    log(f"time eval encode: {rows} pairs at batch {batch} in {encode_s:.3f} s "
        f"= {rows / encode_s:.1f} pairs/s ({encode_s / steps * 1e3:.2f} ms a "
        f"batch; text tower {text_ms:.2f} ms of it; launches {counts})")

    g = torch.Generator().manual_seed(3)
    n_txt, n_img = 6156, 3074
    v = torch.randn(n_txt, 256, generator=g)
    t = v + 0.5 * torch.randn(n_txt, 256, generator=g)
    image_ids = np.arange(n_txt) // 2 % n_img
    pids = image_ids // 3
    rank_s = {}
    for rerank in (False, True):
        evaluation(v, t, pids, pids, image_ids, rerank=rerank, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluation(v, t, pids, pids, image_ids, rerank=rerank,
                         device="cuda")
        torch.cuda.synchronize()
        rank_s[rerank] = time.perf_counter() - t0
    if res["similarity"].shape != (n_txt, n_img):
        fail(f"evaluation at test size: {res['similarity'].shape}")
    log(f"time evaluation at {n_txt} x {n_img}: ranking (t2i + i2t) "
        f"{rank_s[False]:.3f} s, with k-reciprocal re-ranking "
        f"{rank_s[True]:.3f} s")
    del model
    torch.cuda.empty_cache()
    return encode_s, rows / encode_s, text_ms, rank_s


# -- the training slice ------------------------------------------

def drive_training():
    """``textreid_torch.train_net.main`` on a synthetic train split of
    TRAIN_STEPS batches.  Returns the counts, the state and meters."""
    import torch
    from textreid_torch import train_net
    from textreid_torch.data import make_synthetic_dataset

    root = os.path.join(WORK, "train")
    make_synthetic_dataset(
        os.path.join(root, "datasets", "cuhkpedes"),
        num_identities=32 * TRAIN_STEPS, images_per_id=4,
        image_size=(384, 128), vocab_size=512, max_tokens=60, split="train")
    argv = ["--root", root, "--config-file", os.path.join(REPO, VIT_YAML),
            "--device", "cuda", "SOLVER.EVALUATE_PERIOD", "0",
            "SOLVER.NUM_EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "SOLVER.LOG_PERIOD", "1", "TPU.DEBUG_NANS", "True",
            "TPU.ALLOW_RANDOM_VOCAB", "True", "DATALOADER.NUM_WORKERS", "8"]
    zero_counts()
    t0 = time.time()
    state, meters = train_net.main(argv)
    torch.cuda.synchronize()
    counts = read_counts(TRAIN_KERNELS)
    log(f"training slice: train_net.main, {state.step} steps in "
        f"{time.time() - t0:.1f} s; launches {counts}")
    ckpt = os.path.join(root, "output", "cuhkpedes",
                        "moco_gru_clipvitb16_ls_bs128_2048", "epoch_1.pth")
    return counts, state, meters, ckpt


def check_training(counts, state, meters, ckpt):
    import torch

    steps = state.step
    if steps != TRAIN_STEPS:
        fail(f"training slice ran {steps} steps, not {TRAIN_STEPS}")
    want = {"bigru_pooled_fwd": 2 * steps, "fused_attention_fwd": 24 * steps,
            "fused_attention_bwd": 12 * steps}
    if counts != want:
        fail(f"training slice launches {counts}, expected {want}")
    losses = list(meters.loss.deque)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"training losses {losses}")
    if state.queue_ptr != steps * 128 % 2048:
        fail(f"queue_ptr {state.queue_ptr} after {steps} steps")
    if not os.path.isfile(ckpt):
        fail(f"no checkpoint at {ckpt}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    if saved["queue_ptr"] != state.queue_ptr or saved["meta"]["iteration"] \
            != steps or not torch.isfinite(saved["v_queue"]).all():
        fail("the checkpoint does not hold the run's state")
    log(f"training slice: losses {[round(v, 4) for v in losses]}, "
        f"queue_ptr {state.queue_ptr}, checkpoint "
        f"{os.path.relpath(ckpt, REPO)} ({os.path.getsize(ckpt) >> 20} MB)")
    return losses


@contextmanager
def plain_train_kernels():
    """Route the ViT blocks' attention and the text tower's fused scan
    through their plain PyTorch versions (autograd through both)."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.models.vit as vit_model
    from textreid_torch.ops import attention, gru

    def plain_attention(qkv, heads, causal=False, scale=None):
        return attention.fused_attention_plain(qkv, heads, causal, scale)

    def plain_scan(xf, xb, w_f, w_b, lengths, pool_mode):
        pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode)

    with mock.patch.object(vit_model, "attention", plain_attention), \
            mock.patch.object(gru_model, "bigru_pooled_scan", plain_scan):
        yield


def train_setup(compute_dtype_name):
    """Full-width ViT-B/16 + bi-GRU MoCo state on the card and one device
    batch of 32 identities x 4."""
    import torch
    from textreid_torch.config import get_default_cfg
    from textreid_torch.engine import create_train_state, make_train_step
    from textreid_torch.models import build_model
    from textreid_torch.solver import make_optimizer, set_learning_rate
    from textreid_torch.utils.platform import compute_dtype

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, VIT_YAML))
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    cfg.TPU.COMPUTE_DTYPE = compute_dtype_name
    model = build_model(cfg, "cuda", torch.float32,
                        compute_dtype(cfg, "cuda"), train=True)

    def state_of(m):
        opt = make_optimizer(cfg, m)
        set_learning_rate(opt, cfg.SOLVER.BASE_LR)
        return create_train_state(cfg, m, opt, 128)

    rng = np.random.RandomState(11)
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    lengths = rng.randint(5, seq + 1, 128).astype(np.int32)
    ids = np.zeros((128, seq), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(1, 512, n)
    erase = np.zeros((128, 5), np.int32)
    erase[::4] = [1, 100, 20, 80, 40]
    batch = {"pixels": rng.randint(0, 256, (128, 384, 128, 3), np.uint8),
             "erase": erase, "token_ids": ids, "lengths": lengths,
             "pids": np.repeat(np.arange(32), 4)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    return cfg, model, state_of, make_train_step(cfg), batch


def compare_steps():
    """One f32 step with the kernels and one with their plain versions,
    from the same state and batch."""
    import copy

    import torch

    cfg, model, state_of, step, batch = train_setup("float32")
    states = [state_of(model), state_of(copy.deepcopy(model))]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zero_counts()
    got = step(states[0], batch)
    counts = read_counts(TRAIN_KERNELS)
    with plain_train_kernels():
        want = step(states[1], batch)
    torch.cuda.synchronize()
    if counts != {"bigru_pooled_fwd": 2, "fused_attention_fwd": 24,
                  "fused_attention_bwd": 12} or read_counts(TRAIN_KERNELS) != counts:
        fail(f"f32 step launches {counts}, then {read_counts(TRAIN_KERNELS)}")
    loss_err = 0.0
    for name in want:
        a, b = float(got[name]), float(want[name])
        err = abs(a - b) / max(abs(b), 1e-12)
        loss_err = max(loss_err, err)
        log(f"f32 step {name}: kernels {a:.6f}, plain {b:.6f}")
        if not math.isfinite(a) or err > STEP_LOSS_RTOL:
            fail(f"f32 step {name} differs by {err:.3e} (rtol "
                 f"{STEP_LOSS_RTOL:.0e})")
    decay = {id(p): g["weight_decay"]
             for g in states[1].optimizer.param_groups for p in g["params"]}
    worst, worst_name, masked, total = 0.0, "", 0, 0
    plain_params = dict(states[1].model.named_parameters())
    for name, p in states[0].model.named_parameters():
        q = plain_params[name]
        keep = (q.grad + decay[id(q)] * before[name]).abs() >= NOISE_FLOOR
        masked += int((~keep).sum())
        total += keep.numel()
        d_k = (p.detach() - before[name])[keep]
        d_p = (q.detach() - before[name])[keep]
        if d_p.numel() == 0:
            continue
        err = ((d_k - d_p).norm() / d_p.norm().clamp_min(1e-30)).item()
        if err > worst:
            worst, worst_name = err, name
        if not math.isfinite(err) or err > STEP_UPDATE_RTOL:
            fail(f"f32 step: the update of {name} differs by {err:.3e}")
    log(f"f32 step, kernels vs plain: losses within {loss_err:.3e} "
        f"(rtol {STEP_LOSS_RTOL:.0e}); worst update error {worst:.3e} at "
        f"{worst_name} (bound {STEP_UPDATE_RTOL:.0e}; {masked} of {total} "
        f"entries under the {NOISE_FLOOR:.0e} gradient floor left out)")
    del states, model, before
    torch.cuda.empty_cache()
    return loss_err, worst


def time_training(reps=8):
    """Median ms per bf16 step (kernels, then plain versions, then kernels
    again), peak memory, and K1's recompute backward at the step's shape."""
    import torch
    from textreid_torch.ops import gru

    cfg, model, state_of, step, batch = train_setup("bfloat16")
    state = state_of(model)
    torch.cuda.reset_peak_memory_stats()

    def timed(n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1000)
        return out

    timed(3)  # warmup
    kernel = timed(reps)
    peak = torch.cuda.max_memory_allocated()
    with plain_train_kernels():
        timed(2)
        plain = timed(reps)
    kernel += timed(reps)
    ms, plain_ms = float(np.median(kernel)), float(np.median(plain))

    # K1 at the step's shape: forward (kernel) and forward + backward
    # (plain recompute), bf16, B=128, T=105, H=512
    args = k1_inputs(128, torch.bfloat16, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    g = torch.randn(128, 1024, device="cuda", dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            gru.bigru_pooled_scan(*leaves, args[4])

    def fwd_bwd():
        torch.autograd.backward(
            gru.bigru_pooled_scan(*leaves, args[4]), g)

    k1_fwd = cuda_ms(fwd, 10)
    k1_both = cuda_ms(fwd_bwd, 3)
    log(f"time train step bf16 B=128 (ViT-B/16 384x128 + bi-GRU T=105, "
        f"K=2048): median {ms:.2f} ms with the kernels "
        f"({len(kernel)} steps), {plain_ms:.2f} ms with the plain versions "
        f"({len(plain)} steps); peak memory "
        f"{peak / 2**30:.2f} GiB ({card_line()})")
    log(f"time K1 at the step's shape bf16: forward (kernel) {k1_fwd:.3f} ms, "
        f"backward (plain recompute, autograd) {k1_both - k1_fwd:.3f} ms")
    del state, model
    torch.cuda.empty_cache()
    return ms, plain_ms, peak, k1_fwd, k1_both - k1_fwd


def time_attention():
    """K5 and K6 at the ViT-B/16 shape, kernel and plain version
    interleaved, and the library call's time beside them."""
    import torch
    from textreid_torch.ops import attention as A

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv, g = attn_inputs(128, 193, 768, dtype, seed=1)
        dname = str(dtype).split(".")[1]
        out[("K5", dname)] = interleaved_ms(
            lambda: A.fused_attention(qkv, 12),
            lambda: A.fused_attention_plain(qkv, 12), 10, 5)
        out[("K6", dname)] = interleaved_ms(
            lambda: A.fused_attention_bwd(qkv, g, 12),
            lambda: A.fused_attention_bwd_plain(qkv, g, 12), 10, 5)
        for k in ("K5", "K6"):
            ms, plain_ms = out[(k, dname)]
            log(f"time {k} B=128 S=193 W=768 H=12 {dname}: kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms")

    # The library's yardstick, timed here and called nowhere in the port:
    # scaled_dot_product_attention on the split bf16 slab, and autograd's
    # backward of that call.
    import torch.nn.functional as F

    qkv, g = attn_inputs(128, 193, 768, torch.bfloat16, seed=1)
    heads = qkv.view(128, 193, 3, 12, 64).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous().requires_grad_(True) for t in heads)
    g_heads = g.view(128, 193, 12, 64).transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    y = F.scaled_dot_product_attention(q, k, v)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (q, k, v), g_heads,
                                                 retain_graph=True), 10)
    out[("K5", "library")] = fwd_ms
    out[("K6", "library")] = bwd_ms
    log(f"time library yardstick bf16 B=128 S=193 12 heads x 64: "
        f"scaled_dot_product_attention {fwd_ms:.3f} ms, its autograd "
        f"backward {bwd_ms:.3f} ms")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, REPO)
    try:
        from textreid_torch.ops import _build
        from textreid_torch.utils.platform import require_cuda
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")

    card = card_line()
    require_cuda("cuda")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    lib_path, build_log = _build.build()
    _build.library()
    log(f"kernels built in {time.time() - t0:.1f} s: "
        f"{os.path.relpath(lib_path, REPO)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    k1_err = check_k1()
    k2_err = check_k2()
    k3_err = check_k3()
    k4_err = check_k4()
    attn_err = check_attention()
    check_k1_grad()

    service, server, thread, base, text, images, counts = drive_slice()
    try:
        check_slice(service, text, images, counts)
        times = time_kernels()
        img_s, p50 = time_serving(service, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    del service
    torch.cuda.empty_cache()

    workspace = make_workspace(os.path.join(WORK, "gru2l"), quantized=True)
    eval_launches, grid = drive_eval(workspace)
    encode_s, pairs_s, text_ms, rank_s = time_eval(workspace)

    (service, server, thread, base, text, images,
     int8_counts) = drive_slice(quantized=True, workspace=workspace)
    try:
        check_slice(service, text, images, int8_counts)
        int8_times = time_int8_serving(service, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    del service
    torch.cuda.empty_cache()

    train_launches, state, meters, ckpt = drive_training()
    check_training(train_launches, state, meters, ckpt)
    del state
    compare_steps()
    step_ms, step_plain_ms, peak, k1_fwd_ms, k1_bwd_ms = time_training()
    attn_times = time_attention()

    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "textreid_tpu")))
    if loaded:
        fail(f"the port imported {loaded}")
    log(f"summary: gallery encode {img_s:.1f} img/s, /search p50 {p50:.3f} ms "
        f"(flagship, float gallery, 3074 rows); eval encode {encode_s:.3f} s "
        f"for 3072 pairs ({pairs_s:.1f} pairs/s), ranking + re-ranking at "
        f"6156 x 3074 {rank_s[True]:.3f} s; int8 /search p50 "
        f"{int8_times[('p50', 3074)]:.3f} ms at 3074 rows, "
        f"{int8_times[('p50', 98304)]:.3f} ms at 98304; train step bf16 "
        f"{step_ms:.2f} ms (plain versions {step_plain_ms:.2f} ms), peak "
        f"{peak / 2**30:.2f} GiB, K1 recompute backward {k1_bwd_ms:.2f} ms "
        f"({card})")
    log(f"launches: serving {counts}; eval {eval_launches}; int8 serving "
        f"{int8_counts}; training {train_launches}")

    def launches(name):
        return sum(run.get(name, 0) for run in (
            counts, eval_launches, int8_counts, train_launches))

    bounds = kernel_bounds()
    rows = [  # (entry point, source, replaces, error, (ms, plain ms), library)
        ("bigru_pooled_fwd", "bigru_pooled.cu", "gru_pallas.py:396",
         k1_err["bfloat16"], times[("K1", 256, "bfloat16")], None),
        ("gru_scan_fwd", "gru_scan.cu", "gru_pallas.py:107",
         k3_err["bfloat16"], times[("K3", 256, "bfloat16")], None),
        ("topk_similarity_f32", "topk_similarity.cu", "ranking_pallas.py:211",
         k2_err, times[("K2", 3074)], None),
        ("topk_similarity_int8", "topk_similarity.cu", "ranking_pallas.py:372",
         k4_err, times[("K4", 3074)], None),
        ("fused_attention_fwd", "fused_attention.cu",
         "attention_pallas.py:429", attn_err[("K5", "bfloat16")],
         attn_times[("K5", "bfloat16")], attn_times[("K5", "library")]),
        ("fused_attention_bwd", "fused_attention.cu",
         "attention_pallas.py:694", attn_err[("K6", "bfloat16")],
         attn_times[("K6", "bfloat16")], attn_times[("K6", "library")]),
    ]
    for name, *_ in rows:
        if launches(name) < 1:
            fail(f"no driven path launched {name}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "textreid_torch/csrc/" + source,
         "replaces": "textreid_tpu/ops/" + replaces,
         "launches": launches(name), "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library}
        for name, source, replaces, err, (ms, plain_ms), library in rows]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
