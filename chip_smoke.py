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
   shapes its paths give it, with the tolerances stated below: K7, K8 and
   K9 (the int8 encoders' FFN, matmul-requant and requant kernels) at the
   ViT-B/16 gallery batch (24,704 rows, K=768, N=3072), a CLIP text batch
   (25,600 rows, K=512, N=2048) and 37 rows (K7 and K8 also 100 rows and
   the ViT's widths at 37 and 100; K7's cluster tile and K8's cluster
   kernel against the 16-row kernels, bit for bit, and K8's plan from the
   library against ``ops/int8_mm.py:matmul_plan``), f32 and bf16; K1 at
   the serving shapes; K2 and K4 (the streaming top-k, f32 and int8
   gallery) at Q=1, 3 and 256, D=256 over G=3,074, 98,304 and a ragged
   1,001 with 990 valid rows, k=1-64, with duplicated rows and with equal
   rows on either side of a split boundary of their plan (the larger row
   first), K2 also with its bf16 compute option, and their plan from the
   library held against ``ops/ranking.py:topk_plan``; K3 (the
   one-direction GRU scan) at T=105, H=512 and B=1, 37, 128 and 256 in
   bf16 (the W-resident kernel, its launch plan held against
   ``ops/gru.py:resident_plan``) and B=256 and 37 in f32 (the streamed
   kernel), with a non-zero h0 and both scan orders; K5 and K6 in bf16
   (tensor cores) and f32 (FP32 cores) at the ViT-B/16 shape (B=128,
   S=193, W=768, 12 heads), the causal CLIP-text shapes (B=128, S=77 and
   B=256, S=100; W=512, 8 heads), S=288 causal and not, S=257 and a ragged
   S=45 at head_dim 32,
   one token and one sample; K2 and K4 also at D = 100 and 1,024 (the
   wrappers' zero columns, the kernels' query slices past 768 columns);
   K1's forwards (bf16: the W-resident kernel,
   f32: the streamed one), pooled-only and training, at B=1, 37, 128 and
   256 (T=105, H=512, ragged lengths and two empty rows), with the bf16
   launch plan of the library held against ``ops/gru.py:resident_plan``;
   K1's training forward and backward kernels at the train step's shape
   (B=128, f32 and bf16) against their plain versions, and K1's and K3's
   autograd paths (K1: kernel forward and backward; K3: kernel forward,
   plain recompute backward) against autograd through the plain
   versions.
3. The serving slice through its entry points at the flagship width
   (``flagship_cfg("")``: CLIP RN50 at 384x128, bi-GRU H=512, T=105,
   seeded weights): ``textreid_torch.tools.build_index`` on a synthetic
   CUHK-PEDES test split, ``textreid_torch.tools.serve`` booted in-process
   on port 0, HTTP ``/search`` and ``/search_image`` requests.  The kernels'
   launch counters are zeroed just before and read just after; the same
   queries through the plain versions on the card must agree.
4. Timings with CUDA events (kernels) or the host clock around work that
   ends in a synchronize (gallery encode, /search latency), each kernel in
   turns with its plain version; K1's and K3's bf16 W-resident kernels
   also in turns with the streamed kernels they replaced (B=256, 128 and,
   for K3, 1; and one dependent step), K7's cluster tile and K8's cluster
   kernel with the 16-row kernels at both towers' shapes, K9 on the
   device alone, warm and with L2 flushed, and K2 and K4 at one and 256
   queries over 3,074 and 98,304 rows in turns with the kernels they
   replaced (``tools/topk_variants.py``), as issued and queued behind a
   device sleep, with each shape's bound and the rows that entered a
   split's top-k.  One query through the index launches K1 (and K3 twice a
   lower layer) on one row and K2 (K4 from an int8 gallery) once on one
   query, and agrees with the plain path.
5. The evaluation slice through ``textreid_torch.test_net.main`` at the
   full width of ``configs/cuhkpedes/moco_gru2l_freeze_cliprn50_ls_bs128_
   2048.yaml`` (CLIP RN50 at 384x128, 2-layer bi-GRU H=512, T=105, bf16
   towers, seeded weights, random frozen token table) on a synthetic test
   split of 64 identities x 4 images: K3 twice and K1 once per eval batch;
   the four-column grid finite; the cached result replayed to the same
   grid; the same run through the plain versions to the same similarity
   matrix and grid.
6. Int8-gallery serving of the same model: ``build_index --quantize``,
   ``serve --quantize``, ``/search`` and ``/search_image``: K3 twice and K1
   once a ``/search``, K4 launched, K2 not; replies equal to the plain path
   on the card, and each returned id's float score within the int8 error
   of its quantized one.
   Then ``/search`` latency from the int8 gallery at 3,074 and 98,304 rows,
   the index's search time from the float and the int8 gallery, and one
   ``index.search`` of 256 queries at 98,304 rows from each (host and
   device time).
7. Int8-encoder serving of the full-CLIP model at the full width of
   ``configs/cuhkpedes/moco_fullclip_vitb16_ls_bs128_2048.yaml`` (ViT-B/16
   at 384x128 + the CLIP text transformer, 12 layers each, T=100, bf16
   towers, seeded weights): ``build_index --int8-encode --quantize
   --text-calib-out``, ``serve --int8-text-calib``, ``/search`` and
   ``/search_image``.  One forward of the int8 ViT launches K9 36, K8 12 and
   K5 12 times, one of the int8 text tower K9 36, K7 12 and K5 12; the
   served results agree with the same path through the plain versions; each
   int8 tower's embeddings have cosine >= 0.999 to its float tower's.  Then
   K7-K9's times, gallery encode and text encode (int8 against float, each
   tower with ``fused_ffn`` on and off) and ``/search`` latency.
7b. The flagship's gallery in int8, at full width (``flagship_cfg("")``,
   seeded weights with BatchNorm settled by 20 train-mode forwards on the
   synthetic gallery): E1 (``csrc/int8_conv.cu:int8_conv_epilogue``, the
   int8 trunk's fused epilogue) and E2 (``int8_avg_pool``) against their
   plain versions bit for bit at the trunk's shapes at batch 128 (layer 1's
   conv3 with its identity, the stem's conv1, layer 2's downsample, layer
   4's last conv3 with a float output, the pixel quantize, a ragged 37
   rows; f32 and bf16 epilogues; E2 at the stem's and layer 2's pools);
   then ``build_index --int8-encode`` (the int8-dataflow trunk), again
   with ``--quantize``, ``serve`` of each, ``/search`` and
   ``/search_image``: E1 56 and E2 5 launches a trunk forward, K1 once and
   K2 (K4) once a /search, replies equal to the plain path, the gallery's
   minimum cosine to the float tower's >= 0.999, the int8 embeddings equal
   to the same trunk through E1's and E2's plain versions.  The
   interceptor on ``configs/cuhkpedes/baseline_gru_rn50_ls_bs128.yaml``
   (the torchvision ResNet-50): ``build_index --int8-encode``, served, its
   gallery at cosine >= 0.99 to the float tower's.  Then E1's and E2's
   times beside their plain versions (and ``torch._int_mm``'s product
   alone at the same convolution), and the flagship's gallery encode
   img/s at batch 128 over 3,074 rows: float, int8 dataflow and
   interceptor in turns, two readings each.
8. The training slice through ``textreid_torch.train_net.main`` at full
   width, for a few steps each, on a synthetic CUHK-PEDES train split
   (bf16 towers, seeded weights, random frozen token table, MoCo K=2048,
   batch 128, 384x128): ``configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_
   2048.yaml`` (ViT-B/16 + bi-GRU H=512), then the flagship,
   ``moco_gru_cliprn50_ls_bs128_2048.yaml`` (CLIP RN50, res5 stride 1,
   BatchNorm on batch statistics in both towers, + bi-GRU H=512) trained
   as shipped: its yaml with no ``SOLVER.EVALUATE_PERIOD`` override, for
   2 epochs of a few steps with an evaluation after each on a synthetic
   test split (64 identities x 4 images), ``CHECKPOINT_KEEP 1``, from a
   seeded CLIP-layout ``ROOT/pretrained/clip/RN50.pt`` that both trunks
   must hold when training starts (first convolution, a running variance,
   the positional embedding resized 7x7 -> 24x8).  Launch counters are
   zeroed just before and read just after each: K1's forward 2 (the query
   tower's training forward, the key tower's pooled-only one) and K1's
   backward 1 per step, and K1's pooled-only forward once an evaluation
   batch; K5 24 and K6 12 per ViT step, none per flagship step.  Losses
   must be finite, the queue pointer advanced, the checkpoint written; the
   flagship's holds both models' BatchNorm running statistics, moved and
   apart; ``top1`` logged and finite each epoch, ``best.pth`` and
   ``epoch_2.pth`` kept and ``epoch_1.pth`` pruned, ``test_net.main`` on
   ``best.pth`` within a point of the logged R@1.  Then one epoch plus
   ``--resume-from auto`` for the second (its losses against the straight
   run's, RESUME_LOSS_RTOL, cuDNN deterministic for this comparison), and
   a SIGTERM mid-epoch (``preempt.pth`` with the epoch pinned back, then
   ``--resume-from auto`` finishing).  Logged: the in-training evaluation,
   each checkpoint's snapshot and background write, the restart time.  The
   step's wait on the loader is logged.  Then every other shipped training
   yaml the same way, one epoch each (TRAIN_STEPS steps, accum8
   ACCUM8_STEPS so that its queue wraps), in a workspace of its own:
   ``moco_gru2l_freeze_cliprn50_ls_bs128_2048`` (2-layer bi-GRU, the text
   tower and the trunk's stem and layers 1-3 frozen: K1 2 and K3 4 a step,
   no K1 backward; the frozen parameters bit-identical after the run),
   ``baseline_gru_cliprn50_ls_bs128`` and ``baseline_gru_rn50_ls_bs128``
   (the simple head, CLIP RN50 and the torchvision ResNet-50 with a
   learnable 12k-row table: K1 1 / 1 a step, no key model, no queue),
   ``moco_fullclip_vitb16_ls_bs128_2048`` (ViT-B/16 + the CLIP text
   transformer, T=100, from a seeded ``ViT-B-16.pt`` whose visual and text
   halves both models must hold as training starts: K5 48 and K6 24 a
   step) and ``moco_gru_cliprn50_ls_bs1024_2048_accum8`` (bs1024 in 8
   microbatches: K1 24 / 8 a step); each run's launches gated (see
   TRAIN_MODELS), its losses finite, its queue pointer, its checkpoint
   restored whole by ``--resume-from``.
9. One f32 step with the kernels against one with their plain versions,
   from the same state and batch, for the ViT-B/16 model, the flagship
   and the full-CLIP model (K5 and K6 causal in training; cuDNN
   deterministic and without TF32 for this comparison only): loss dicts,
   every parameter's gradient and its update (see STEP_UPDATE_RTOL).
10. Step time (median, bf16, after warmup) with the kernels and with their
   plain versions, peak device memory, and a ``torch.profiler`` split of
   the step's device time by kernel family (convolutions, BatchNorm, K1
   forward and backward, K5, K6, matrix products, the rest), both ways,
   for the ViT-B/16 model and the flagship; the flagship's is the port's
   ``moco_train_step_ms_bs128``.  The accum8 step beside the single-pass
   bs128 flagship step, in turns: step and device ms, peak memory of each
   (accum8's gated at ACCUM8_PEAK_RATIO of the other's), and one
   microbatch's pass-1 against pass-2 embeddings (REPLAY_RTOL).  Then K1's
   backward
   at the step's shape beside its plain version and the plain recompute it
   replaced, and K5 and K6 alone at the ViT-B/16 shape and the served
   causal text shape, beside their plain versions and the library call.
11. The ``kernels`` line: for each of the twelve kernels its launches on the
    driven paths, its error, its time beside its plain version's, its
    roofline bound computed from the timed shapes (bytes over 3.35 TB/s
    against operations over the peak rate of the input type), and the time
    of the one PyTorch call that computes the same function where there is
    one (a yardstick only: nothing in the port calls it).
12. Last, after every host-paced timing, the device time of one int8
    ViT-B/16 forward and of one int8 flagship trunk forward (B=128) by
    kernel family (``torch.profiler``, ``utils/profiling.py``).
13. Data parallelism (``textreid_torch/parallel/mesh.py``; run after the
    accum8 timing, before K2's and K4's timings): (a) the flagship f32
    step on 2 ranks on the one card (two processes, ``python3
    chip_smoke.py --dp-rank``; gloo, which takes CUDA tensors, since NCCL
    refuses two ranks on one device), 64 rows each of the 128-row batch,
    2 steps, against one process on the 128 rows from the same start:
    losses (STEP_LOSS_RTOL), step 1's gradients and updates (the gates of
    phase 9), BatchNorm statistics (DP_STATS_RTOL), queues (DP_QUEUE_ATOL)
    and ids, the two ranks' states equal, K1 forward 2 and backward 1 a
    rank a step; (b) ``train_net.main`` on the flagship yaml under a
    one-rank NCCL group (``RANK=0``, ``WORLD_SIZE=1``, a free
    ``MASTER_PORT``), in turns with the same run outside a group: the bf16
    step times of both, one checkpoint a run; (c) ``RetrievalIndex(mesh=)``
    over ``[cuda:0] x 2`` and ``x 4`` at 3,074 rows (4 does not divide
    it: the augmented pad rows) and 98,304, float and int8, served over
    HTTP beside the unsharded index: replies equal (DP_SEARCH_TOL, rows
    equal outside ties), K2 / K4 once a shard a search, ``/search`` p50
    of each.  ``python3 chip_smoke.py --dp`` runs this phase alone (a
    development aid, no result line); ``--dp-f64`` runs (a) in f32 and
    then in f64 (masters and towers; the plain versions, as K1 has no f64
    kernel) and logs both distances from one process.
14. The tools and the quickstart (after K2's and K4's timings, before the
    int8 profiles; ``drive_tools``): ``tools.export_torch`` on phase 8's
    ``best.pth``, the file installed into a fresh state by
    ``install_reference_checkpoint`` equal bit for bit to ``best.pth``
    restored whole (query model, key towers, queues, pointer);
    ``tools.parity_eval`` on it against ``test_net``'s t2i row (both f32):
    rc 0, its npz replayed by ``test_net --load-result`` to the same row,
    and rc 1 with the row moved by twice the budget; ``tools.bench_loader``
    at 384x128 (4 and 8 threads, 32 batches of 128 an epoch, timed after
    the first batch) against the demand of phase 10's flagship step time;
    ``tools.int8_ffn_ab`` (its towers' minimum cosine, on against off, >=
    INT8_COSINE_BAR); ``python -m textreid_torch.quickstart`` on ``cuda``
    with K1 (forward, backward: one a step) and K2 launches counted into
    the ``kernels`` line; last ``tools.profile_step --steps 2`` on the
    flagship: K1's forward and backward, the convolutions and the products
    above 0, no streamed backward, the step's device time within
    PROFILE_TOOL_RTOL of ``profile_steps`` on the same step
    (``profile_step.build_step``) in this process.  Every step profile of
    the script (phases 10 and 14, accum8's) is the tool's summary
    (:func:`profile_steps`).

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
K1_GRAD_TOL = 1e-5           # f32 gradients through K1 or K3's Function
                             # against autograd through the plain version,
                             # over max(1, the largest |gradient|): the same
                             # f32 math, another summation order
# K1's backward kernel against bigru_pooled_bwd_plain on the same saved
# state, over the plain gradient's largest magnitude.  f32 dx: each step's
# dh carries a sum of 3H = 1536 products in another order, and the chain of
# 105 steps contracts it (dh z); f32 dW: then summed over B T = 13,440 rows
# of mixed sign, so the error relative to the largest entry grows with the
# cancellation.  bf16: f32 inside, one rounding of each result, which may
# land one ulp (2^-8 relative) apart: 2 ulp, as K1_TOL
K1_BWD_TOL = {"float32": {"dx": 1e-5, "dw": 1e-4},
              "bfloat16": {"dx": 8e-3, "dw": 8e-3}}
K1_STATE_TOL = 1e-5          # the training forward's saved f32 state (h and
                             # gates) against the plain training forward's
STEP_LOSS_RTOL = 1e-4        # f32 step, kernels vs plain: loss values
# f32 step, kernels vs plain, per parameter: ||grad_kernel - grad_plain||
# over ||grad_plain|| (for every parameter whose plain gradient norm is at
# least 1e-6 of the model's largest: below that it is rounding noise of an
# exactly zero gradient, as the attention's key bias has), and
# ||update_kernel - update_plain|| over ||update_plain|| on the entries
# whose gradient (weight decay included) is above 1e-6 and above twice the
# tensor's largest |grad_kernel - grad_plain|; below either, Adam's first
# step g / (|g| + 1e-8), a sign, follows rounding noise (a BatchNorm
# trunk's weight gradients are sums of ~10^5 cancelling terms, whose f32
# rounding passes 1e-6)
STEP_UPDATE_RTOL = 1e-3
NOISE_FLOOR = 1e-6
VIT_YAML = "configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_2048.yaml"
FLAGSHIP_YAML = "configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml"
TRAIN_STEPS = 3
SPLIT_IDS, SPLIT_IMAGES_PER_ID = 64, 4  # the synthetic test splits
GRU2L_YAML = "configs/cuhkpedes/moco_gru2l_freeze_cliprn50_ls_bs128_2048.yaml"
# eval through the kernels against eval through their plain versions, bf16
# towers: one bf16 ulp in a hidden state moves an embedding by ~1e-3
EVAL_SIM_TOL = 1e-3
# ... and may swap two gallery rows whose similarities are that close, so
# the CMC/mAP grids agree to this many percent points, not exactly
EVAL_GRID_TOL = 1.0
FULLCLIP_YAML = "configs/cuhkpedes/moco_fullclip_vitb16_ls_bs128_2048.yaml"
SIMPLE_CLIP_YAML = "configs/cuhkpedes/baseline_gru_cliprn50_ls_bs128.yaml"
SIMPLE_RN_YAML = "configs/cuhkpedes/baseline_gru_rn50_ls_bs128.yaml"
ACCUM8_YAML = "configs/cuhkpedes/moco_gru_cliprn50_ls_bs1024_2048_accum8.yaml"
ACCUM8_STEPS = 2  # two steps of 1,024 wrap the queue of 2,048
# accum8's peak device memory over the single-pass bs128 flagship step's
ACCUM8_PEAK_RATIO = 1.3
# the gradient-cache step's pass 1 (no gradient: K1's pooled-only kernel)
# against its pass 2 (K1's training forward) on one microbatch, bf16: the
# two K1 forwards agree within K1_TOL (two bf16 ulp of a hidden state), so
# each embedding within two bf16 ulp of its largest entry
REPLAY_RTOL = 8e-3
# K7-K9 against their plain versions: the int8 values equal but for one step
# on at most this share of the elements (the kernel's row sums, exp and
# rsqrt differ from torch's in the last bit, which moves a value that lies
# on a rounding boundary, 127 * 2^-23 of them a step), ...
INT8_STEP_SHARE = 1e-3
INT8_SCALE_RTOL = 1e-6       # ... and the row scales (one f32 ulp is 1.2e-7)
# K7's output: one step of g[m, n] moves out[m, j] by |w2[n, j]| s_w2[j]
# r[m] <= 127 s_w2[j] r[m]; this many steps a row are allowed, plus one
# rounding of the output dtype
K7_FLIPS = 4
# int8 against float embeddings of a tower (the JAX package's bar)
INT8_COSINE_BAR = 0.999
# served scores of the int8 encoders, kernels against plain versions: a
# one-step difference of an int8 activation in 12 layers of bf16 towers
INT8_SLICE_TOL = 5e-3
# the roofline bounds take the card's peaks from
# textreid_torch/utils/profiling.py:DEVICE_PEAKS (the NVIDIA H100 SXM's
# dense data-sheet rates: 3.35 TB/s; 989 TFLOP/s bf16, 67 f32, 1,979 TOP/s
# int8), the table tools/profile_step.py reads too
BOUND_CARD = "NVIDIA H100 80GB HBM3"


def bound(n_bytes, n_ops, dtype_name=None):
    """(bound ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype_name``; ``n_ops`` may instead
    be a {dtype name: operations} dict, whose times at each rate add up
    (``utils/profiling.py:bound_ms`` at BOUND_CARD's peaks)."""
    from textreid_torch.utils.profiling import bound_ms, device_peaks

    return bound_ms(n_bytes, n_ops, device_peaks(BOUND_CARD), dtype_name)


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


def with_empty_rows(args):
    """K1's inputs with rows 1 and B - 2 (where B > 2) of length 0: no valid
    step, so their pooled output is -inf before the zero-participation
    rule."""
    lengths = args[4].clone()
    if len(lengths) > 2:
        lengths[[1, len(lengths) - 2]] = 0
    return (*args[:4], lengths)


def k1_plan(batch, entry="bigru_resident_plan"):
    """The launch plan of K1's bf16 forward (``entry`` =
    "bigru_resident_plan") or backward ("bigru_resident_bwd_plan") for
    ``batch`` rows, from the library and from ``ops/gru.py:resident_plan``
    on the library's capacity: (rows, clusters, capacity), failing if they
    differ."""
    import ctypes

    from textreid_torch.ops import _build, gru

    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(getattr(_build.library(), entry)(
        batch, 512, *map(ctypes.byref, out)), entry)
    rows, clusters, cap32, cap16 = (v.value for v in out)
    capacity = {32: cap32, 16: cap16}
    want = gru.resident_plan(batch, capacity)
    if (rows, clusters) != want[:2]:
        fail(f"{entry} at B={batch}: the library's {(rows, clusters)}, "
             f"resident_plan's {want[:2]}")
    return rows, clusters, capacity


def check_k1():
    """K1's forward against its plain version at the served, evaluated and
    trained batches and a ragged one, f32 (the streamed kernel) and bf16
    (the W-resident kernel), ragged lengths with empty rows."""
    import torch
    from textreid_torch.ops import gru

    worst = {}
    for batch in (1, 37, 128, 256):
        rows, clusters, capacity = k1_plan(batch)
        log(f"K1 bf16 plan B={batch}: {rows} rows a cluster of 16 blocks, "
            f"{clusters} clusters (the card holds {capacity[32]} of 32 rows, "
            f"{capacity[16]} of 16 at once)")
        for dtype in (torch.float32, torch.bfloat16):
            args = with_empty_rows(k1_inputs(batch, dtype, seed=batch))
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
            check_k1_train_state(batch, args, name)
    return worst


def check_k1_train_state(batch, args, name):
    """K1's training forward on the same inputs against its plain version:
    the pooled output within K1_TOL, the saved f32 state (h_{t-1} and the
    gates at every step) within K1_STATE_TOL, the argmax -1 exactly on the
    empty rows; argmax flips (near-ties the two f32 states cross) are
    counted."""
    import torch
    from textreid_torch.ops import gru

    pooled, hp, gates, argmax = gru.bigru_pooled_fwd_train(*args)
    p_pooled, p_hp, p_gates, p_argmax = gru.bigru_pooled_fwd_train_plain(
        *args)
    torch.cuda.synchronize()
    pool_err = (pooled.float() - p_pooled.float()).abs().nan_to_num(
        0.0).max().item()
    same_inf = torch.equal(torch.isinf(pooled), torch.isinf(p_pooled))
    state_err = max((hp - p_hp).abs().max().item(),
                    (gates - p_gates).abs().max().item())
    empty = args[4] == 0
    empty_ok = bool((argmax[empty] == -1).all())
    flips = int((argmax != p_argmax).sum())
    log(f"K1 bigru_pooled_fwd_train B={batch} T=105 H=512 {name}: pooled "
        f"within {pool_err:.3e} (tol {K1_TOL[name]:.0e}), -inf on the same "
        f"entries: {same_inf}; saved state within {state_err:.3e} (tol "
        f"{K1_STATE_TOL:.0e}); argmax -1 on the {int(empty.sum())} empty "
        f"rows: {empty_ok}, differs at {flips} of {argmax.numel()} maxima")
    if not (pool_err <= K1_TOL[name] and same_inf and empty_ok
            and state_err <= K1_STATE_TOL):
        fail(f"K1 training forward B={batch} {name} disagrees with its plain "
             "version")


def k2_inputs(n_g, seed, n_q=256, dim=256, duplicates=False, edge=0):
    """Unit queries and gallery on the card.  ``duplicates``: exact score
    ties (rows n_g/2.. repeat rows 0..63, row n_g-1 repeats row 3, queries
    0-7 are rows 0-7).  ``edge``: rows edge-1 and edge hold one vector, and
    query 0 is it (a tie across a split boundary at ``edge``)."""
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
    if edge:
        gal[edge] = gal[edge - 1]
        q[0] = gal[edge]
    return q.contiguous(), gal.contiguous()


def split_edge(n_q, n_rows, kind):
    """The first row of the second split of K2's / K4's plan at this shape
    (0 if the plan has one split)."""
    import torch
    from textreid_torch.ops import ranking

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ranking.topk_plan(n_q, n_rows, 256, sms, kind)
    return n_rows // plan.splits if plan.splits > 1 else 0


def check_topk_plans():
    """The library's plan of K2 and K4 (``topk_similarity_plan``) against
    ``ops/ranking.py:topk_plan`` at the checked and timed shapes."""
    import ctypes

    import torch
    from textreid_torch.ops import _build, ranking

    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(n_q, n_g, dim) for n_q in (1, 3, 8, 24, 256, 1000)
              for n_g in (40, 990, 3074, 98304)
              for dim in (256, 768) + TOPK_WIDTHS]
    for kind_id, kind in enumerate(ranking.KINDS):
        for n_q, n_rows, dim in shapes:
            out = (ctypes.c_int * 4)()
            _build.check(lib.topk_similarity_plan(kind_id, n_q, n_rows, dim,
                                                  out), "topk_similarity_plan")
            plan = ranking.topk_plan(n_q, n_rows, dim, sms, kind)
            if tuple(out) != plan[:4]:
                fail(f"K2/K4 plan {kind} Q={n_q} G={n_rows} D={dim}: library "
                     f"{tuple(out)}, ops/ranking.py {plan[:4]}")
    for n_q, n_g in TOPK_SHAPES:
        log(f"K2/K4 plan Q={n_q} G={n_g} D=256 (q_tile, splits, stages, "
            f"shared bytes): f32 {ranking.topk_plan(n_q, n_g, 256, sms)[:4]}, "
            f"int8 {ranking.topk_plan(n_q, n_g, 256, sms, 'int8')[:4]}")
    log(f"K2/K4 plans: the library's equal ops/ranking.py's at "
        f"{3 * len(shapes)} shapes ({sms} SMs)")


def check_k2():
    """K2 against its plain version; returns the worst score error of the
    f32 cases (the row of the ``kernels`` line).  The bf16 cases round both
    operands to bf16 before the products (``compute_dtype``)."""
    import torch
    from textreid_torch.ops import ranking

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(256, 3074, k, 0, False, f32) for k in (1, 10, 64)]
    cases += [(256, 98304, k, 0, False, f32) for k in (1, 10, 64)]
    cases += [(256, 1001, 10, 990, False, f32),   # ragged G, masked tail
              (256, 40, 64, 0, False, f32),       # k > G: sentinel slots
              (256, 3074, 10, 0, True, f32),      # duplicated rows: exact ties
              (256, 3074, 10, 0, False, bf16),
              (256, 98304, 10, 0, False, bf16),
              (256, 3074, 64, 0, True, bf16),
              (256, 1001, 10, 990, False, bf16)]
    # one and three queries (the plan's 8-query tile over ~132 splits)
    cases += [(n_q, n_g, k, valid, False, dtype) for n_q in (1, 3)
              for n_g, k, valid in ((3074, 10, 0), (98304, 10, 0),
                                    (98304, 64, 0), (1001, 10, 990))
              for dtype in (f32, bf16)]
    # equal rows on either side of a split boundary of the plan
    cases += [(n_q, 3074, 10, 0, "edge", dtype) for n_q in (1, 3, 256)
              for dtype in (f32, bf16)]
    worst = 0.0
    for n_q, n_g, k, valid, dup, dtype in cases:
        n_valid = valid or n_g
        edge = split_edge(n_q, n_valid, "bf16" if dtype == bf16 else "f32") \
            if dup == "edge" else 0
        q, gal = k2_inputs(n_g, seed=n_g + k + (n_q if n_q != 256 else 0),
                           n_q=n_q, duplicates=dup is True, edge=edge)
        vals, idx = ranking.topk_similarity(q, gal, k, valid, dtype)
        pv, pi = ranking.topk_similarity_plain(q, gal, k, valid, dtype)
        torch.cuda.synchronize()
        err = (vals - pv).abs().max().item()
        scores = q.to(dtype).float() @ gal[:n_valid].to(dtype).float().T
        swapped = (idx != pi)
        bad = 0
        for r, j in swapped.nonzero().tolist():
            i_k, i_p = idx[r, j].item(), pi[r, j].item()
            if i_k < 0 or i_p < 0 or abs(
                    scores[r, i_k].item() - scores[r, i_p].item()) > K2_TOL:
                bad += 1
        ties_ok = True
        if dup is True:  # rows 3 and n_g-1 hold one vector: n_g-1 first
            row3 = idx[3].tolist()
            ties_ok = row3.index(n_g - 1) < row3.index(3)
        elif dup == "edge":  # rows edge-1 and edge: edge first, both top
            ties_ok = idx[0, :2].tolist() == [edge, edge - 1]
        dname = str(dtype).split(".")[1]
        tag = {True: " dup", "edge": f" tie across the split edge {edge}",
               False: ""}[dup]
        log(f"K2 topk_similarity_f32 Q={n_q} D=256 G={n_g} k={k} "
            f"valid={n_valid}{tag} compute {dname}: "
            f"max_abs_err={err:.3e} "
            f"(tol {K2_TOL:.0e}), index mismatches={int(swapped.sum())} "
            f"(non-tie {bad}), tie order ok={ties_ok}")
        if not math.isfinite(err) or err > K2_TOL or bad or not ties_ok:
            fail(f"K2 Q={n_q} G={n_g} k={k} {dname} disagrees with its "
                 "plain version")
        if dtype == f32 and n_q == 256:
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
    ("CLIP text, a batch of 256", 256, 100, 512, 8, True),
    ("longest S", 16, 288, 768, 12, False),
    ("longest S, causal", 16, 288, 768, 12, True),
    ("ViT-L/14 length, head_dim 32", 8, 257, 256, 8, False),
    ("one token", 4, 1, 128, 2, False),
    ("one token, causal, head_dim 32", 4, 1, 64, 2, True),
    ("ragged S, head_dim 32", 8, 45, 256, 8, True),
    ("ragged S, head_dim 32, full", 8, 45, 256, 8, False),
    ("one sample", 1, 193, 768, 12, False),
]
# the shapes time_attention times: (key, batch, seq, width, heads, causal)
ATTN_TIMED = [("vit",) + ATTN_CASES[0][1:], ("text",) + ATTN_CASES[2][1:]]


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


def hidden_states(hp, gates):
    """Every ``h_t`` [2, B, T, H] from a training forward's saved state:
    ``hp`` holds ``h_{t-1}``, and the last step is rebuilt from its gates
    as the plain scan computes it."""
    import torch

    _, z, n, _ = gates[:, :, -1].unbind(2)
    last = (1.0 - z) * n + z * hp[:, :, -1]
    return torch.cat([hp[:, :, 1:], last[:, :, None]], dim=2)


def exact_ties(hp, gates, lengths):
    """(direction, row, unit) maxima over ``t < len`` reached at more than
    one step, per direction and row: [2, B] counts."""
    import torch

    h = hidden_states(hp, gates)
    seq = h.shape[2]
    valid = (torch.arange(seq, device=h.device)[None, :]
             < lengths[:, None])[None, :, :, None]
    h = torch.where(valid, h, float("-inf"))
    top = h.max(dim=2, keepdim=True).values
    hits = ((h == top) & valid).sum(dim=2)  # [2, B, H]
    return (hits > 1).sum(dim=2)


def check_k1_grad():
    """K1's training forward and backward kernels at the train step's shape
    (B=128, T=105, H=512, ragged lengths), f32 and bf16.  The training
    forward's pooled output equals the pooled-only kernel's and its saved
    state is within K1_STATE_TOL of the plain training forward's; the
    backward kernel on that state against ``bigru_pooled_bwd_plain``
    (K1_BWD_TOL); then the Function (kernel forward, kernel backward)
    against autograd through ``bigru_pooled_scan_plain``, f32 at
    K1_GRAD_TOL and bf16 at K1_BWD_TOL, on the (direction, row) pairs where
    the two forwards chose the same step for every unit and hold no exact
    tie (where one forward's f32 state crossed the other's at a near-tie,
    the pool gradient lands on another step: both are gradients of the max;
    autograd splits an exact tie).  Returns the worst absolute error of the
    backward kernel against its plain version, per dtype."""
    import torch
    from textreid_torch.ops import _build, gru

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        args = k1_inputs(128, dtype, seed=9)
        lengths = args[4]
        gen = torch.Generator(device="cuda").manual_seed(10)
        g = torch.randn(128, 1024, device="cuda", generator=gen).to(dtype)
        pooled, hp, gates, argmax = gru.bigru_pooled_fwd_train(*args)
        _, p_hp, p_gates, p_argmax = gru.bigru_pooled_fwd_train_plain(*args)
        state_err = max((hp - p_hp).abs().max().item(),
                        (gates - p_gates).abs().max().item())
        only = gru._bigru_pooled_cuda(*args)
        same_pool = torch.equal(pooled, only)
        pool_err = (pooled.float() - only.float()).abs().max().item()
        flips = (argmax != p_argmax).view(128, 2, -1).sum(2).T  # [2, B]
        ties = exact_ties(p_hp, p_gates, lengths)
        log(f"K1 bigru_pooled_fwd_train B=128 T=105 H=512 {name}: pooled "
            f"output equal to the pooled-only kernel's: {same_pool} (within "
            f"{pool_err:.3e}, tol {K1_TOL[name]:.0e}); saved "
            f"state within {state_err:.3e} of the plain training forward's "
            f"(tol {K1_STATE_TOL:.0e}); argmax differs at {int(flips.sum())} "
            f"of {128 * 1024} (row, unit) maxima (near-ties); exact ties in "
            f"the plain states: {int(ties.sum())}")
        if not pool_err <= K1_TOL[name] or not state_err <= K1_STATE_TOL:
            fail(f"K1 training forward {name} disagrees with the pooled-only "
                 "kernel or with its plain version")

        got = gru.bigru_pooled_bwd(g, args[2], args[3], lengths, hp, gates,
                                   argmax)
        want = gru.bigru_pooled_bwd_plain(g, args[2], args[3], lengths, hp,
                                          gates, argmax)
        torch.cuda.synchronize()
        entry = gru.bwd_kernel(dtype)
        if entry == "bigru_resident_bwd":
            rows, clusters, capacity = k1_plan(128, "bigru_resident_bwd_plan")
            log(f"K1 backward bf16 plan B=128: {rows} rows a cluster of 16 "
                f"blocks, {clusters} clusters (the card holds "
                f"{capacity[32]} of 32 rows, {capacity[16]} of 16 at once)")
            # the Python mirror of the block's shared memory against the
            # kernel's own arithmetic, at every H the backward admits
            lib = _build.library()
            for h in range(32, gru.MAX_TRAIN_HIDDEN + 1, 32):
                for r in gru.RESIDENT_ROWS:
                    smem = lib.bigru_resident_bwd_smem(h, r)
                    if (smem != gru.resident_bwd_smem(h, r)
                            or smem > gru.MAX_SHARED_BYTES):
                        fail(f"K1 backward shared memory at H={h} R={r}: "
                             f"the kernel's {smem} B, ops/gru.py's "
                             f"{gru.resident_bwd_smem(h, r)}, the card's "
                             f"{gru.MAX_SHARED_BYTES}")
        errs = []
        for gname, key, a, b in zip(("xf", "xb", "w_f", "w_b"),
                                    ("dx", "dx", "dw", "dw"), got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"K1 backward d/d{gname} {name}: {a.shape}/{a.dtype} vs "
                     f"{b.shape}/{b.dtype}")
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            errs.append(f"d{gname} {err:.3e} ({err / scale:.2e} of "
                        f"{scale:.3e})")
            worst[name] = max(worst.get(name, 0.0), err)
            if not math.isfinite(err) or scale == 0 or (
                    err > K1_BWD_TOL[name][key] * scale):
                fail(f"K1 backward {name}: d/d{gname} off by {err:.3e} of "
                     f"{scale:.3e}")
        log(f"K1 bigru_pooled_bwd ({entry}) B=128 T=105 H=512 {name} "
            f"against bigru_pooled_bwd_plain on the same state: "
            f"{', '.join(errs)} "
            f"(tol dx {K1_BWD_TOL[name]['dx']:.0e}, dW "
            f"{K1_BWD_TOL[name]['dw']:.0e} of the largest)")

        leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        out = gru.bigru_pooled_scan(*leaves, lengths, pool_mode="batch")
        grads = torch.autograd.grad(out, leaves, g)
        ref_leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        ref = gru.zero_participation(
            gru.bigru_pooled_scan_plain(*ref_leaves, lengths), lengths, 105,
            "batch")
        ref_grads = torch.autograd.grad(ref, ref_leaves, g)
        clean = (flips == 0) & (ties == 0)  # [2, B]
        if any(t.grad_fn is not None for t in grads):
            fail("K1's gradient carries a graph")
        pairs = [(grads[d][clean[d]], ref_grads[d][clean[d]])
                 for d in (0, 1)]  # dxf, dxb on the clean rows
        w_dirs = [d for d in (0, 1) if bool(clean[d].all())]
        pairs += [(grads[2 + d], ref_grads[2 + d]) for d in w_dirs]
        err = 0.0
        for a, b in pairs:
            e = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            err = max(err, e / (max(1.0, top) if dtype == torch.float32
                                else top))
        tol = K1_GRAD_TOL if dtype == torch.float32 else \
            K1_BWD_TOL[name]["dx"]
        log(f"K1 autograd B=128 T=105 H=512 {name}: the Function's "
            f"gradients within {err:.3e} of autograd through the plain "
            f"version (tol {tol:.0e}) on {int(clean.sum())} of 256 "
            f"(direction, row) pairs; dW of {len(w_dirs)} of 2 directions")
        if not math.isfinite(err) or err > tol or int(clean.sum()) < 128:
            fail(f"K1 autograd {name}: gradients off by {err:.3e}")
    return worst


def k3_inputs(batch, dtype, seed, seq=105, hidden=512):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, seq, 3 * hidden, device="cuda", generator=g)
         * 0.6).to(dtype)
    w = torch.rand(hidden, 3 * hidden, device="cuda", generator=g) * 2 - 1
    h0 = torch.randn(batch, hidden, device="cuda", generator=g) * 0.5
    return x, (w / math.sqrt(hidden)).to(dtype), h0.to(dtype)


def k3_plan(batch):
    """K3's bf16 launch plan for ``batch`` rows, from the library and from
    ``ops/gru.py:resident_plan`` with one direction: (rows, clusters,
    capacity), failing if they differ."""
    import ctypes

    from textreid_torch.ops import _build, gru

    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(_build.library().gru_scan_resident_plan(
        batch, 512, *map(ctypes.byref, out)), "gru_scan_resident_plan")
    rows, clusters, cap32, cap16 = (v.value for v in out)
    capacity = {32: cap32, 16: cap16}
    want = gru.resident_plan(batch, capacity, directions=1)
    if (rows, clusters) != want[:2]:
        fail(f"K3 bf16 plan at B={batch}: the library's {(rows, clusters)}, "
             f"resident_plan's {want[:2]}")
    return rows, clusters, capacity


def check_k3():
    """K3 against its plain version: bf16 (the W-resident kernel) at B=1,
    37, 128 and 256 in both scan orders, f32 (the streamed kernel) at B=256
    and a ragged B, all with a non-zero h0; the bf16 plan against the
    library's; then the Function's gradient against autograd through the
    plain version."""
    import torch
    from textreid_torch.ops import gru

    worst = {}
    cases = [(batch, reverse, torch.bfloat16) for batch in (1, 37, 128, 256)
             for reverse in (False, True)]
    cases += [(256, False, torch.float32), (37, True, torch.float32)]
    for batch, reverse, dtype in cases:
        name = str(dtype).split(".")[1]
        entry = gru.scan_kernel(dtype, 512)
        if dtype == torch.bfloat16 and not reverse:
            rows, clusters, capacity = k3_plan(batch)
            log(f"K3 bf16 plan B={batch}: {rows} rows a cluster of 16 "
                f"blocks, {clusters} clusters (the card holds "
                f"{capacity[32]} of 32 rows, {capacity[16]} of 16 at once)")
        args = k3_inputs(batch, dtype, seed=batch)
        got = gru.gru_scan(*args, reverse=reverse)
        want = gru.gru_scan_plain(*args, reverse=reverse)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"K3 B={batch} {name}: {got.shape}/{got.dtype} vs "
                 f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        log(f"K3 {entry} B={batch} T=105 H=512 reverse={reverse} {name}: "
            f"max_abs_err={err:.3e} (tol {K1_TOL[name]:.0e})")
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


def k4_inputs(n_g, seed, n_q=256, dim=256, duplicates=False, edge=0):
    """Unit queries and a quantized unit gallery (``quantize_rows``)."""
    from textreid_torch.ops.quant import quantize_rows

    q, gal = k2_inputs(n_g, seed, n_q, dim, duplicates, edge)
    quant = quantize_rows(gal)
    return q, quant.values.contiguous(), quant.scales.contiguous()


def check_k4():
    """K4 against its plain version: scores within K4_RTOL relative (plus
    K4_ATOL for cosines near zero), indices equal except within sets of
    equal scores."""
    import torch
    from textreid_torch.ops import ranking
    from textreid_torch.ops.quant import QuantizedGallery, quantized_scores

    cases = [(256, 3074, k, 0, False) for k in (10, 64)]
    cases += [(256, 98304, k, 0, False) for k in (10, 64)]
    cases += [(256, 1001, 10, 990, False),   # ragged G, masked tail
              (256, 40, 64, 0, False),       # k > G: sentinel slots
              (256, 3074, 10, 0, True)]      # duplicated rows: exact ties
    # one and three queries (the plan's 8-query tile over ~132 splits)
    cases += [(n_q, n_g, k, valid, False) for n_q in (1, 3)
              for n_g, k, valid in ((3074, 10, 0), (98304, 10, 0),
                                    (98304, 64, 0), (1001, 10, 990))]
    # equal rows on either side of a split boundary of the plan
    cases += [(n_q, 3074, 10, 0, "edge") for n_q in (1, 3, 256)]
    worst = 0.0
    for n_q, n_g, k, valid, dup in cases:
        n_valid = valid or n_g
        edge = split_edge(n_q, n_valid, "int8") if dup == "edge" else 0
        q, values, scales = k4_inputs(
            n_g, seed=n_g + k + (n_q if n_q != 256 else 0), n_q=n_q,
            duplicates=dup is True, edge=edge)
        vals, idx = ranking.topk_similarity_quantized(q, values, scales, k,
                                                      valid)
        pv, pi = ranking.topk_similarity_quantized_plain(q, values, scales, k,
                                                         valid)
        torch.cuda.synchronize()
        real = pi >= 0
        if not torch.equal(real, idx >= 0):
            fail(f"K4 Q={n_q} G={n_g} k={k}: sentinel slots differ")
        # |kernel - plain| over its allowance (1.0 = at the limit)
        err = ((vals - pv).abs() / (K4_RTOL * pv.abs() + K4_ATOL))[
            real].max().item()
        if not torch.equal(vals[~real], pv[~real]):
            fail(f"K4 Q={n_q} G={n_g} k={k}: sentinel scores differ")
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
        if dup is True:  # rows 3 and n_g-1 hold one vector: n_g-1 first
            row3 = idx[3].tolist()
            ties_ok = row3.index(n_g - 1) < row3.index(3)
        elif dup == "edge":  # rows edge-1 and edge: edge first, both top
            ties_ok = idx[0, :2].tolist() == [edge, edge - 1]
        tag = {True: " dup", "edge": f" tie across the split edge {edge}",
               False: ""}[dup]
        log(f"K4 topk_similarity_int8 Q={n_q} D=256 G={n_g} k={k} "
            f"valid={n_valid}{tag}: worst error "
            f"{err:.3f} of its allowance (rtol {K4_RTOL:.0e} + atol "
            f"{K4_ATOL:.0e}), index mismatches={int(swapped.sum())} "
            f"(non-tie {bad}), tie order ok={ties_ok}")
        if not math.isfinite(err) or err > 1.0 or bad or not ties_ok:
            fail(f"K4 Q={n_q} G={n_g} k={k} disagrees with its plain version")
        if n_q == 256:
            worst = max(worst, (vals - pv).abs()[real].max().item())
    return worst


# K2 and K4 at embedding widths other than the flagship's 256: one off the
# int8 kernel's multiple of 16 (the wrappers pad D with zero columns) and
# one past the 768 columns a block stages at once (the sliced kernels)
TOPK_WIDTHS = (100, 1024)


def check_topk_widths():
    """K2 (f32 and bf16 compute) and K4 at TOPK_WIDTHS against their plain
    versions, at one, three and 256 queries over 3,074 rows and 256 over a
    ragged 1,001 with 990 valid, k = 10 and 64, with duplicated rows at
    256 queries:
    K2_TOL and K4's allowance as at D = 256 (unit vectors: f32 sums of up
    to 1,024 products in another order stay near sqrt(1024) x 2^-24), the
    same top-k outside exact ties, the larger row of a tie first.  Returns
    {(kernel, D): worst error} (K4's over its allowance)."""
    import torch
    from textreid_torch.ops import ranking
    from textreid_torch.ops.quant import quantize_rows

    out = {}
    for dim in TOPK_WIDTHS:
        for n_q, n_g, k, valid in ((1, 3074, 10, 0), (3, 3074, 64, 0),
                                   (256, 3074, 10, 0),
                                   (256, 1001, 64, 990)):
            q, gal = k2_inputs(n_g, seed=dim + n_q + k, n_q=n_q, dim=dim,
                               duplicates=n_q >= 8)
            n_valid = valid or n_g
            quant = quantize_rows(gal)
            runs = [("K2 f32", torch.float32), ("K2 bf16", torch.bfloat16),
                    ("K4", None)]
            for name, dtype in runs:
                if dtype is None:
                    got = ranking.topk_similarity_quantized(
                        q, quant.values, quant.scales, k, valid)
                    want = ranking.topk_similarity_quantized_plain(
                        q, quant.values, quant.scales, k, valid)
                    allowance = K4_RTOL * want[0].abs() + K4_ATOL
                else:
                    got = ranking.topk_similarity(q, gal, k, valid, dtype)
                    want = ranking.topk_similarity_plain(q, gal, k, valid,
                                                         dtype)
                    allowance = torch.full_like(want[0], K2_TOL)
                torch.cuda.synchronize()
                real = want[1] >= 0
                err = ((got[0] - want[0]).abs() / allowance)[real].max()
                err = err.item()
                swapped = got[1] != want[1]
                # an index may differ only where the two scores are within
                # the allowance (a tie, or sums a last bit apart)
                near = ((got[0] - want[0]).abs() <= allowance)[swapped]
                row3 = got[1][3].tolist() if n_q > 3 else []
                ties_ok = (n_g - 1 not in row3 or 3 not in row3
                           or row3.index(n_g - 1) < row3.index(3))
                log(f"{name} Q={n_q} D={dim} G={n_g} k={k} valid={n_valid}"
                    f": worst error {err:.3f} of its allowance, index "
                    f"mismatches={int(swapped.sum())}, tie order ok="
                    f"{ties_ok}")
                if not math.isfinite(err) or err > 1.0 or not bool(
                        near.all()) or not ties_ok:
                    fail(f"{name} at D={dim} Q={n_q} G={n_g} k={k} "
                         "disagrees with its plain version")
                key = (name.split()[0], dim)
                out[key] = max(out.get(key, 0.0), err)
    return out


# -- K7-K9: the int8 encoders' kernels ------------------------------------------

# (name, rows, K, N): the ViT-B/16 gallery batch (128 x 193 tokens), a CLIP
# text batch (256 x 100 tokens), and a ragged row count
INT8_SHAPES = [("ViT-B/16", 24704, 768, 3072), ("CLIP text", 25600, 512, 2048),
               ("ragged", 37, 512, 2048)]


def int8_site(rows, k, n, seed, m_out=0):
    """One quantized site on the card: int8 rows and weights (held as the
    transpose of a contiguous [N, K], as the towers hold them), decode
    scales, bias, row scales and the consumer's scales."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    def uniform(*shape):
        return torch.rand(*shape, device="cuda", generator=g)

    site = dict(
        xq=ints(rows, k), w=ints(n, k).t(), s_w=(uniform(n) + 0.1) * 1e-3,
        b=torch.randn(n, device="cuda", generator=g) * 0.05,
        r_row=(uniform(rows, 1) + 0.05) / 127.0,
        s_next=(uniform(n) + 0.05) / 127.0)
    if m_out:
        site.update(w2=ints(m_out, n).t(), s_w2=(uniform(m_out) + 0.1) * 1e-3,
                    b2=torch.randn(m_out, device="cuda", generator=g) * 0.05)
    return site


def int8_agreement(what, got, want):
    """(q, r) of a kernel against its plain version; returns the largest
    int8 step between them (0 or 1)."""
    import torch

    (q, r), (pq, pr) = got, want
    torch.cuda.synchronize()
    if q.shape != pq.shape or q.dtype != torch.int8 or r.shape != pr.shape:
        fail(f"{what}: {q.shape}/{q.dtype}, {r.shape} vs {pq.shape}, "
             f"{pr.shape}")
    step = (q.int() - pq.int()).abs()
    share = (step > 0).float().mean().item()
    scale_err = ((r - pr).abs() / pr.abs()).max().item()
    log(f"{what}: int8 max step {int(step.max())}, share one step apart "
        f"{share:.2e} (tol {INT8_STEP_SHARE:.0e}), row scales rel err "
        f"{scale_err:.2e} (rtol {INT8_SCALE_RTOL:.0e})")
    if step.max().item() > 1 or share > INT8_STEP_SHARE or not (
            scale_err <= INT8_SCALE_RTOL):
        fail(f"{what} disagrees with its plain version")
    return float(step.max())


def check_k9():
    """K9 against its plain version at the towers' widths (ln and none at
    768 and 512, gelu at 3072 and 2048), f32 and bf16, and 37 rows."""
    import torch
    from textreid_torch.ops import requant

    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(9)
    for name, rows, width, wide in INT8_SHAPES:
        for op, c in (("ln", width), ("none", width), ("gelu", wide)):
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn(rows, c, device="cuda", generator=g)
                     * 1.5 + 0.2).to(dtype)
                s = (torch.rand(c, device="cuda", generator=g) + 0.05) / 127
                dname = str(dtype).split(".")[1]
                worst = max(worst, int8_agreement(
                    f"K9 fused_requant {name} [{rows}, {c}] op={op} {dname}",
                    requant.fused_requant(x, s, op),
                    requant.requant_plain(x, s, op)))
    return worst


# K7 and K8 also at 100 rows (one query of the CLIP text tower) and both at
# the ViT's widths at 37 and 100 rows
INT8_ROW_SHAPES = INT8_SHAPES + [("one query", 100, 512, 2048),
                                 ("ragged ViT", 37, 768, 3072),
                                 ("ragged ViT", 100, 768, 3072)]


def k8_plan(k, n):
    """K8's plan from the library (columns a block, blocks a cluster,
    stages, rows a tile, shared bytes, clusters the card holds at once),
    held against ``ops/int8_mm.py:matmul_plan``; returns that plan and the
    clusters."""
    import ctypes

    from textreid_torch.ops import _build, int8_mm

    plan = int8_mm.matmul_plan(k, n)
    out = [ctypes.c_int(0) for _ in range(6)]
    _build.check(_build.library().int8_matmul_requant_plan(
        k, n, *map(ctypes.byref, out)), "int8_matmul_requant_plan")
    cols, cluster, stages, tile, smem, clusters = (v.value for v in out)
    lib_plan = (("cluster", cluster, cols, tile, stages, smem) if cols
                else ("rows16",))
    if tuple(plan)[:len(lib_plan)] != lib_plan:
        fail(f"K8 at K={k} N={n}: matmul_plan {tuple(plan)}, the library's "
             f"{lib_plan}")
    return plan, clusters


def check_k8():
    """K8 against its plain version: c_fc of both towers, 37 and 100 rows,
    with and without the GELU; where ``matmul_plan`` gives the cluster
    kernel, against the 16-row kernel too, which must give the same q and r
    bit for bit (the same integer sums and f32 steps); the library's plan
    against ``matmul_plan``; the epilogue's reciprocal against __frcp_rn on
    every float it takes."""
    import torch
    from textreid_torch.ops import _build, int8_mm
    from textreid_torch.tools.int8_variants import matmul_rows16

    # the epilogue's branch-free reciprocal is __frcp_rn on all of [1, 2^126]
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    _build.check(_build.library().int8_mm_rcp_mismatches(
        0x3F800000, 0x7E800001, bad.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "int8_mm_rcp_mismatches")
    log(f"K8's reciprocal against __frcp_rn on every float of [1, 2^126]: "
        f"{int(bad.item())} differ")
    if bad.item():
        fail("K8's reciprocal differs from __frcp_rn")
    worst = 0.0
    for name, rows, k, n in INT8_ROW_SHAPES:
        plan, clusters = k8_plan(k, n)
        site = int8_site(rows, k, n, seed=rows)
        args = [site[key] for key in ("xq", "w", "s_w", "b", "r_row",
                                      "s_next")]
        for op in ("gelu", "none"):
            got = int8_mm.fused_int8_matmul_requant(*args, op=op)
            what = (f"K8 int8_matmul_requant {name} [{rows}, {k}] x [{k}, "
                    f"{n}] op={op}")
            if plan.kernel == "cluster":
                old = matmul_rows16(*args, op=op)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], old[0])
                        and torch.equal(got[1], old[1])):
                    steps = (got[0].int() - old[0].int()).abs()
                    fail(f"{what}: the cluster kernel and the 16-row kernel "
                         f"differ: {int((steps > 0).sum())} int8 values, "
                         f"row scales by "
                         f"{(got[1] - old[1]).abs().max().item():.3e}")
                what += (f" (cluster kernel: {plan.cluster} blocks of "
                         f"{plan.cols} columns, {plan.stages} stages, "
                         f"{plan.smem} B, {clusters} clusters at once; equal "
                         f"to the 16-row kernel)")
            worst = max(worst, int8_agreement(
                what, got, int8_mm.int8_matmul_requant_plain(*args, op=op)))
    return worst


def check_k7():
    """K7 against its plain version: the FFN of both towers at their
    batches, 37 and 100 rows, f32 and bf16 output; and against the 16-row
    kernel it replaced, which must give the same output bit for bit (the
    same int8 middle and the same integer sums); its cluster tile from the
    library against ``ops/int8_mm.py:ffn_plan``.  Returns the worst
    absolute error."""
    import ctypes

    import torch
    from textreid_torch.ops import _build, int8_mm
    from textreid_torch.tools.int8_variants import ffn_rows16

    worst = 0.0
    for name, rows, k, n in INT8_ROW_SHAPES:
        site = int8_site(rows, k, n, seed=rows + 1, m_out=k)
        args = [site[key] for key in ("xq", "w", "s_w", "b", "r_row",
                                      "s_next", "w2", "s_w2", "b2")]
        _, r_mid = int8_mm.int8_matmul_requant_plain(*args[:6], op="gelu")
        blocks, tile = int8_mm.ffn_plan(k, n, k)
        lib_plan = [ctypes.c_int(0), ctypes.c_int(0)]
        _build.library().int8_ffn_plan(k, n, k, *map(ctypes.byref, lib_plan))
        if (blocks, tile) != tuple(v.value for v in lib_plan):
            fail(f"K7 at K={k} N={n}: ffn_plan's {(blocks, tile)}, the "
                 f"library's {tuple(v.value for v in lib_plan)}")
        for dtype in (torch.bfloat16, torch.float32):
            got = int8_mm.fused_int8_ffn(*args, out_dtype=dtype)
            want = int8_mm.int8_ffn_plain(*args, out_dtype=dtype)
            old = ffn_rows16(*args, out_dtype=dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, old):
                fail(f"K7 {name} [{rows}, {k}]: the cluster tile and the "
                     f"16-row kernel differ by "
                     f"{(got.float() - old.float()).abs().max().item():.3e}")
            dname = str(dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K7 {name} {dname}: {got.shape}/{got.dtype} vs "
                     f"{want.shape}/{want.dtype}")
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
            allowed = (K7_FLIPS * 127.0 * site["s_w2"][None, :] * r_mid
                       + ulp * want.float().abs())
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            over = (diff / allowed.clamp_min(1e-30)).max().item()
            moved = (diff > 0).float().mean().item()
            log(f"K7 int8_ffn {name} [{rows}, {k}] -> {n} -> {k} {dname} "
                f"(a cluster of {blocks} blocks, {tile}-row tiles; equal to "
                f"the 16-row kernel): "
                f"max_abs_err={err:.3e}, {over:.3f} of the allowance of "
                f"{K7_FLIPS} one-step flips of the middle a row, share of "
                f"outputs that differ {moved:.2e}")
            if not math.isfinite(err) or not over <= 1.0:
                fail(f"K7 {name} {dname} disagrees with its plain version")
            worst = max(worst, err)
    return worst


def time_int8_kernels():
    """K7, K8 and K9 at both towers' shapes (bf16 where a float goes in or
    out), kernel and plain version interleaved; K8's cluster kernel in
    turns with the 16-row kernel; K9 at the LayerNorm sites also on the
    device alone (launches queued behind a device sleep), warm (the input
    read again at once) and with L2 flushed before each launch."""
    import torch
    from textreid_torch.ops import int8_mm, requant
    from textreid_torch.tools.int8_variants import (
        cold_ms, ffn_rows16, matmul_rows16, queued_ms)

    out = {}
    g = torch.Generator(device="cuda").manual_seed(4)
    scratch = torch.empty(16 * 2**20, device="cuda")  # 64 MB
    for name, rows, k, n in INT8_SHAPES[:2]:
        for op, c in (("ln", k), ("none", k), ("gelu", n)):
            x = torch.randn(rows, c, device="cuda", generator=g).to(
                torch.bfloat16)
            s = (torch.rand(c, device="cuda", generator=g) + 0.05) / 127
            out[("K9", name, op)] = interleaved_ms(
                lambda: requant.fused_requant(x, s, op),
                lambda: requant.requant_plain(x, s, op), 20, 5)
            log("time K9 %s [%d, %d] op=%s bf16: kernel %.4f ms, plain "
                "%.3f ms" % (name, rows, c, op, *out[("K9", name, op)]))
            if op == "ln":
                fn = lambda: requant.fused_requant(x, s, op)  # noqa: E731
                out[("K9 queued", name)] = (queued_ms(fn, 20),
                                            cold_ms(fn, 20, scratch))
                log("time K9 %s [%d, %d] ln bf16 on the device (launches "
                    "queued behind a device sleep): warm %.4f ms, L2 "
                    "flushed %.4f ms" % (name, rows, c,
                                         *out[("K9 queued", name)]))
        site = int8_site(rows, k, n, seed=3, m_out=k)
        args = [site[key] for key in ("xq", "w", "s_w", "b", "r_row",
                                      "s_next", "w2", "s_w2", "b2")]
        out[("K8", name)] = interleaved_ms(
            lambda: int8_mm.fused_int8_matmul_requant(*args[:6], op="gelu"),
            lambda: int8_mm.int8_matmul_requant_plain(*args[:6], op="gelu"),
            5, 5)
        # the cluster kernel against the 16-row kernel, in turns
        out[("K8 vs rows16", name)] = interleaved_ms(
            lambda: int8_mm.fused_int8_matmul_requant(*args[:6], op="gelu"),
            lambda: matmul_rows16(*args[:6], op="gelu"), 10, 10)
        out[("K7", name)] = interleaved_ms(
            lambda: int8_mm.fused_int8_ffn(*args, out_dtype=torch.bfloat16),
            lambda: int8_mm.int8_ffn_plain(*args, out_dtype=torch.bfloat16),
            5, 5)
        # the cluster tile against the 16-row kernel it replaced, in turns
        out[("K7 vs rows16", name)] = interleaved_ms(
            lambda: int8_mm.fused_int8_ffn(*args, out_dtype=torch.bfloat16),
            lambda: ffn_rows16(*args, out_dtype=torch.bfloat16), 10, 10)
        # the library's product alone, for scale: not the same function
        lib_ms = cuda_ms(lambda: int8_mm.int_matmul(args[0], args[1]), 10)
        out[("int_mm", name)] = lib_ms
        for kname in ("K8", "K7"):
            log("time %s %s rows=%d K=%d N=%d: kernel %.3f ms, plain %.3f ms"
                % (kname, name, rows, k, n, *out[(kname, name)]))
        log("time K8 %s rows=%d gelu: the cluster kernel %.4f ms, the "
            "16-row kernel %.4f ms (in turns)" % (
                name, rows, *out[("K8 vs rows16", name)]))
        log("time K7 %s rows=%d bf16: the cluster tile %.3f ms, the 16-row "
            "kernel it replaced %.3f ms (in turns)" % (
                name, rows, *out[("K7 vs rows16", name)]))
        log(f"time torch._int_mm alone [{rows}, {k}] x [{k}, {n}] (the "
            f"product without the epilogue): {lib_ms:.4f} ms")
    return out


# -- launch counters -----------------------------------------------------------

def wrappers():
    """Kernel entry point -> the wrapper that counts its launches."""
    from textreid_torch.ops import (attention, gru, int8_conv, int8_mm,
                                    ranking, requant)

    return {"fused_requant": requant.fused_requant,
            "int8_matmul_requant": int8_mm.fused_int8_matmul_requant,
            "int8_ffn": int8_mm.fused_int8_ffn,
            "bigru_pooled_fwd": gru.bigru_pooled_scan,
            "bigru_pooled_bwd": gru.bigru_pooled_bwd,
            "gru_scan_fwd": gru.gru_scan,
            "topk_similarity_f32": ranking.topk_similarity,
            "topk_similarity_int8": ranking.topk_similarity_quantized,
            "fused_attention_fwd": attention.fused_attention,
            "fused_attention_bwd": attention.fused_attention_bwd,
            "int8_conv_epilogue": int8_conv.int8_conv_epilogue,
            "int8_avg_pool": int8_conv.int8_avg_pool}


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
TRAIN_KERNELS = ("bigru_pooled_fwd", "bigru_pooled_bwd", "gru_scan_fwd",
                 "fused_attention_fwd", "fused_attention_bwd")


def step_launches(k1=0, k1_bwd=0, k3=0, k5=0, k6=0):
    return dict(zip(TRAIN_KERNELS, (k1, k1_bwd, k3, k5, k6)))


# Launches of one step of each shipped training yaml, from the code: K1's
# forward once a bi-GRU tower forward (the query tower's under autograd is
# the training forward, with one backward; the key tower's and a frozen
# tower's, whose inputs need no gradient, the pooled-only kernel); K3 once a
# direction of each lower GRU layer; K5 once an attention block a tower
# forward, K6 once one a backward.
# * ViT-B/16 + bi-GRU: K1 2 / 1, K5 24 (12 blocks, query and key), K6 12;
# * the flagship (CLIP RN50 + bi-GRU): K1 2 / 1 (its convolutions and
#   BatchNorms are cuDNN's and PyTorch's);
# * the 2-layer frozen model: the text tower frozen (MODEL.FREEZE), so K1
#   runs pooled-only in both towers, 2 / 0, and K3 2 a tower, 4;
# * the simple heads: one tower forward, no key model: K1 1 / 1;
# * full-CLIP (ViT-B/16 + CLIP text transformer, 12 blocks each): K5 48
#   (24 a model), K6 24, causal in the text tower;
# * accum8 (bs1024 in 8 microbatches of 128): the key forward, pass 1 (no
#   gradient: pooled-only) and pass 2 (training forward and backward) of
#   each microbatch: K1 24 / 8.
TRAIN_MODELS = {  # name: (yaml, launches of one step)
    "ViT-B/16 + bi-GRU": (VIT_YAML, step_launches(2, 1, k5=24, k6=12)),
    "CLIP RN50 + bi-GRU (flagship)": (FLAGSHIP_YAML, step_launches(2, 1)),
    "2-layer frozen": (GRU2L_YAML, step_launches(2, 0, 4)),
    "simple head, CLIP RN50": (SIMPLE_CLIP_YAML, step_launches(1, 1)),
    "simple head, torchvision RN50": (SIMPLE_RN_YAML, step_launches(1, 1)),
    "full-CLIP": (FULLCLIP_YAML, step_launches(k5=48, k6=24)),
    "accum8": (ACCUM8_YAML, step_launches(24, 8)),
}
# the f32 step against its plain versions (phase 9) and the timed bf16
# step (phase 10)
COMPARED_MODELS = ("ViT-B/16 + bi-GRU", "CLIP RN50 + bi-GRU (flagship)",
                   "full-CLIP")
TIMED_MODELS = ("ViT-B/16 + bi-GRU", "CLIP RN50 + bi-GRU (flagship)")


# -- phase 3: the slice through its entry points ---------------------------

@contextmanager
def plain_kernels():
    """Route the encoder's scans and the index's ranking (float and int8)
    through their plain PyTorch versions, on the same card."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.serving as serving
    from textreid_torch.ops import gru, ranking

    def plain_scan(xf, xb, w_f, w_b, lengths, pool_mode, batch_max=None):
        pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode,
                                      batch_max)

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


def drive_slice(quantized=False, workspace=None, int8_encode=False):
    """build_index -> serve -> HTTP at full width: the flagship from a float
    gallery, or the 2-layer-GRU model from an int8 gallery
    (``--quantize``); with ``int8_encode``, the gallery encoded by
    ``build_index --int8-encode``.  Returns the running (service, server,
    thread), the HTTP results, the launch counts of the run and the index
    build_index built."""
    from textreid_torch.tools import build_index, serve

    root, cfg, cfg_path, ckpt = workspace or make_workspace(
        os.path.join(WORK, "serve"), quantized)
    height, width = cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH
    index_path = os.path.join(root, "gallery.idx")
    common = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
              ckpt, "--device", "cuda"] + (["--quantize"] if quantized else [])

    zero_counts()
    t0 = time.time()
    built = build_index.main(common + ["--output", index_path] + (
        ["--int8-encode"] if int8_encode else []))
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
    names = INT8_SERVE_KERNELS if quantized else SERVE_KERNELS
    if int8_encode:  # the flagship's one-layer bi-GRU: no K3
        names = tuple(n for n in names if n != "gru_scan_fwd") + TRUNK_KERNELS
    counts = read_counts(names)
    log(f"{'int8 ' if quantized else ''}slice"
        f"{' (gallery int8-encoded)' if int8_encode else ''}: build_index + "
        f"serve boot + {len(text)} /search + {len(images)} /search_image in "
        f"{time.time() - t0:.1f} s; launches {counts}")
    return service, server, thread, base, text, images, counts, built


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
    # a /search encodes once (and serve's warmup once): K1 once, K3 twice a
    # lower layer
    layers = index.model.textual_model.num_layers
    want = {"bigru_pooled_fwd": len(text) + 1,
            "gru_scan_fwd": 2 * (layers - 1) * (len(text) + 1)}
    got = {name: counts.get(name, 0) for name in want}
    if got != want:
        fail(f"{len(text)} /search requests launched {got}, expected {want}")

    # a 2-layer text tower in bf16 feeds layer 0's rounded states on: where
    # kernel and plain version round one of them apart, the query moves;
    # and K4 rounds the queries to bf16, so where the kernel's query and the
    # plain one differ in a last bit, one entry's bf16 rounding can flip (a
    # bf16 ulp of that entry's product)
    tol = DEEP_SLICE_TOL if (index.model.textual_model.num_layers > 1
                             or index.quantize) else SLICE_TOL
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
    ids, lens = text[0][:2]
    check_one_query(index, ids[:1], lens[:1], tol)
    if index.quantize:
        check_int8_error(index, text)


def check_one_query(index, ids, lens, tol):
    """One query through ``index.search``: the text tower's kernels launched
    on one row (K1 once, K3 twice a lower layer), the ranking kernel (K2, or
    K4 from an int8 gallery) once on one query, and the result the plain
    path's on the same card."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.serving as serving

    rows = []

    def spy(fn):
        def counted(*args, **kwargs):
            rows.append(args[0].shape[0])
            return fn(*args, **kwargs)
        return counted

    layers = index.model.textual_model.num_layers
    rank = ("topk_similarity_int8" if index.quantize
            else "topk_similarity_f32")
    zero_counts()
    with mock.patch.object(gru_model, "bigru_pooled_scan",
                           spy(gru_model.bigru_pooled_scan)), \
            mock.patch.object(gru_model, "gru_scan",
                              spy(gru_model.gru_scan)), \
            mock.patch.object(serving, "topk_similarity",
                              spy(serving.topk_similarity)), \
            mock.patch.object(serving, "topk_similarity_quantized",
                              spy(serving.topk_similarity_quantized)):
        scores, meta = index.search(ids, lens, k=10)
    counts = read_counts(("gru_scan_fwd", "bigru_pooled_fwd", rank))
    want = {"gru_scan_fwd": 2 * (layers - 1), "bigru_pooled_fwd": 1,
            rank: 1}
    if counts != want or set(rows) != {1}:
        fail(f"one query: launches {counts} on {rows} rows, expected {want} "
             f"on 1 row each")
    with plain_kernels():
        plain_scores, plain_meta = index.search(ids, lens, k=10)
        emb = index.encode_queries(ids, lens)
    err, _ = agree_with_plain({"scores": scores.tolist(),
                               "meta": meta.tolist()}, plain_scores,
                              plain_meta, emb, index, "one query", tol)
    log(f"one query: {counts} launched on 1 row each; scores within "
        f"{err:.3e} of the plain path (tol {tol:.0e})")


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


# -- int8-encoder serving of the full-CLIP model --------------------------------

INT8_SERVE_ENCODERS = ("fused_requant", "int8_matmul_requant", "int8_ffn",
                       "fused_attention_fwd", "topk_similarity_int8",
                       "topk_similarity_f32")
VIT_FORWARD = {"fused_requant": 36, "int8_matmul_requant": 12, "int8_ffn": 0,
               "fused_attention_fwd": 12}
TEXT_FORWARD = {"fused_requant": 36, "int8_matmul_requant": 0, "int8_ffn": 12,
                "fused_attention_fwd": 12}


@contextmanager
def plain_int8_kernels():
    """Route the int8 towers' K9, K8, K7 and K5, the float ViT's K5 and the
    index's ranking through their plain PyTorch versions, on the same
    card."""
    import textreid_torch.models.int8_vit as int8_vit
    import textreid_torch.models.vit as vit_model
    from textreid_torch.ops import attention, int8_mm, requant

    def plain_attention(qkv, heads, causal=False, scale=None):
        return attention.fused_attention_plain(qkv, heads, causal, scale)

    with mock.patch.object(int8_vit, "fused_requant", requant.requant_plain), \
            mock.patch.object(int8_vit, "fused_int8_matmul_requant",
                              int8_mm.int8_matmul_requant_plain), \
            mock.patch.object(int8_vit, "fused_int8_ffn",
                              int8_mm.int8_ffn_plain), \
            mock.patch.object(int8_vit, "fused_attention", plain_attention), \
            mock.patch.object(vit_model, "attention", plain_attention), \
            plain_kernels():
        yield


def make_fullclip_workspace(root):
    """The full-CLIP YAML at full width (ViT-B/16 at 384x128 + the CLIP text
    transformer, 12 layers each, T=100), a synthetic test split and a seeded
    checkpoint under ``root``."""
    from textreid_torch.config import get_default_cfg
    from textreid_torch.data import make_synthetic_dataset
    from textreid_torch.models import build_model
    from textreid_torch.utils.weight_convert import save_reference_checkpoint

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, FULLCLIP_YAML))
    cfg.DATASETS.TEST = ("cuhkpedes_test",)
    cfg.DATALOADER.NUM_WORKERS = 4
    folder = os.path.join(root, "configs", "cuhkpedes")
    os.makedirs(folder, exist_ok=True)
    cfg_path = os.path.join(folder, os.path.basename(FULLCLIP_YAML))
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    make_synthetic_dataset(
        os.path.join(root, "datasets", "cuhkpedes"),
        num_identities=SPLIT_IDS, images_per_id=SPLIT_IMAGES_PER_ID,
        image_size=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH),
        vocab_size=cfg.MODEL.TRANSFORMER.VOCAB_SIZE, max_tokens=60,
        split="test")
    ckpt = os.path.join(root, "model.pth")
    save_reference_checkpoint(build_model(cfg, "cpu"), ckpt)  # seeded, f32
    return root, cfg, cfg_path, ckpt


def forward_counts(fn, want, what):
    """Launches of one forward, which must be exactly ``want``."""
    import torch

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts(want)
    log(f"{what}: launches of one forward {got}")
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    return out


def min_cosine(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=1).min().item()


def drive_int8_encoders():
    """``build_index --int8-encode --quantize --text-calib-out`` then ``serve
    --int8-text-calib`` on the full-CLIP model at full width, ``/search`` and
    ``/search_image`` over HTTP.  Gates: the launches of one forward of each
    int8 tower, the served results against the plain versions on the card,
    the int8 towers' embeddings against the float towers'."""
    import torch
    from textreid_torch.tools import build_index, serve

    root, cfg, cfg_path, ckpt = make_fullclip_workspace(
        os.path.join(WORK, "fullclip"))
    height, width = cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    index_path = os.path.join(root, "gallery.idx")
    calib_path = os.path.join(root, "calib.npz")
    common = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
              ckpt, "--device", "cuda", "--quantize"]

    zero_counts()
    t0 = time.time()
    built = build_index.main(common + [
        "--output", index_path, "--int8-encode", "--text-calib-out",
        calib_path])
    build_counts = read_counts(INT8_SERVE_ENCODERS)
    service, server = serve.build_server(common + [
        "--index-file", index_path, "--int8-text-calib", calib_path,
        "--port", "0", "--k-buckets", "5,10,100", "--reload-dir", root])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]

    rng = np.random.RandomState(17)
    text = []
    for n, k in [(1, 5), (3, 10), (16, 5), (2, 10), (4, 100)]:
        lens = rng.randint(1, seq + 1, n).astype(np.int32)
        ids = np.zeros((n, seq), np.int32)
        for i, ln in enumerate(lens):
            ids[i, :ln] = rng.randint(1, cfg.MODEL.TRANSFORMER.VOCAB_SIZE, ln)
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
    counts = read_counts(INT8_SERVE_ENCODERS)
    log(f"int8-encoder slice: build_index --int8-encode + serve "
        f"--int8-text-calib boot + {len(text)} /search + {len(images)} "
        f"/search_image in {time.time() - t0:.1f} s; launches of build_index "
        f"{build_counts}; of the whole run {counts}")

    index = service.index
    meta_ids = set(index.gallery_meta.tolist())
    for ids, lens, k, reply in text:
        check_reply(reply, len(ids), k, meta_ids, f"/search n={len(ids)} k={k}")
    for pixels, k, reply in images:
        check_reply(reply, len(pixels), k, meta_ids,
                    f"/search_image n={len(pixels)}")
    if build_counts["int8_matmul_requant"] < 12 or build_counts["int8_ffn"]:
        fail(f"build_index --int8-encode launched {build_counts}")
    for name in ("fused_requant", "int8_matmul_requant", "int8_ffn",
                 "fused_attention_fwd", "topk_similarity_int8"):
        if counts[name] < 1:
            fail(f"the int8-encoder path never launched {name}")
    if counts["topk_similarity_f32"]:
        fail("the int8 gallery launched the f32 top-k")

    # one forward of each int8 tower
    pixels = torch.from_numpy(rng.randint(
        0, 255, (128, height, width, 3), dtype=np.uint8)).cuda()
    ids = torch.from_numpy(text[2][0]).cuda().repeat(16, 1)  # [256, T]
    lens = torch.from_numpy(text[2][1]).cuda().repeat(16)
    with torch.inference_mode():
        v8 = forward_counts(lambda: built._embed_images(pixels), VIT_FORWARD,
                            "int8 ViT tower, B=128")
        t8 = forward_counts(lambda: index._embed_texts(ids, lens),
                            TEXT_FORWARD, "int8 text tower, B=256 T=100")
        model = index.model
        from textreid_torch.models.losses import l2_normalize

        vf = l2_normalize(model.embed_image(
            model.encode_image(pixels)).float(), dim=1)
        tf = l2_normalize(model.embed_text(
            model.encode_text(ids, lens)).float(), dim=1)
    cos_v, cos_t = min_cosine(v8, vf), min_cosine(t8, tf)
    log(f"int8 against float embeddings, seeded weights, 12 layers, bf16: "
        f"minimum cosine ViT {cos_v:.5f} (128 images), text {cos_t:.5f} (256 "
        f"queries); bar {INT8_COSINE_BAR}")
    if not (cos_v >= INT8_COSINE_BAR and cos_t >= INT8_COSINE_BAR):
        fail("an int8 tower's embeddings miss the cosine bar")

    # the served results through the plain versions
    worst, swaps = 0.0, 0
    with plain_int8_kernels():
        zero_counts()
        for ids_np, lens_np, k, reply in text:
            s, m = index.search(ids_np, lens_np, k=k)
            emb = index.encode_queries(ids_np, lens_np)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search",
                                    INT8_SLICE_TOL)
            worst, swaps = max(worst, e), swaps + w
        for px, k, reply in images:
            s, m = index.search_by_image(px, k=k)
            emb = index.encode_image_queries(px)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search_image",
                                    INT8_SLICE_TOL)
            worst, swaps = max(worst, e), swaps + w
        with torch.inference_mode():
            v_plain = built._embed_images(pixels[:32])
        if any(read_counts().values()):
            fail(f"the plain int8 run launched a kernel: {read_counts()}")
    gal_err = (v_plain - v8[:32]).abs().max().item()
    log(f"int8-encoder slice vs plain versions on the card: max score diff "
        f"{worst:.3e} (tol {INT8_SLICE_TOL:.0e}), meta swaps within ties "
        f"{swaps}; int8 ViT embeddings of 32 images within {gal_err:.3e}")
    if not gal_err <= INT8_SLICE_TOL:
        fail("the int8 ViT tower disagrees with its plain versions")
    return service, server, thread, base, built, counts, (cos_v, cos_t)


def time_int8_encoders(service, base, built):
    """Gallery encode img/s (int8 tower against the bf16 float tower), each
    tower's forward with ``fused_ffn`` on and off beside the float tower,
    and /search p50 with the int8 text tower against the float one."""
    import torch
    from textreid_torch.models.model import preprocess_pixels
    from textreid_torch.serving import RetrievalIndex
    from textreid_torch.tools.int8_ffn_ab import encode_cases

    out = {}
    index = service.index
    model = index.model
    height, width = service.image_shape
    rng = np.random.RandomState(19)
    rows, batch = 1024, 128
    pixels = rng.randint(0, 255, (rows, height, width, 3), dtype=np.uint8)
    batches = [pixels[i:i + batch] for i in range(0, rows, batch)]
    for kind in ("float", "int8", "int8", "float"):
        idx = RetrievalIndex(model, int8_encode=(kind == "int8"))
        idx.build_gallery(batches[:4])  # calibrates; warms the shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.build_gallery(batches)
        torch.cuda.synchronize()
        out.setdefault(("encode", kind), []).append(
            rows / (time.perf_counter() - t0))
    for kind in ("float", "int8"):
        out[("encode", kind)] = float(np.mean(out[("encode", kind)]))
    log(f"time gallery encode, ViT-B/16 384x128, {rows} images at batch "
        f"{batch} (host copies included, two runs each, interleaved): bf16 "
        f"float tower {out[('encode', 'float')]:.1f} img/s, int8 tower "
        f"{out[('encode', 'int8')]:.1f} img/s")

    dev = torch.from_numpy(batches[0]).cuda()
    x = preprocess_pixels(dev, None, model.pixel_mean, model.pixel_std)
    visual, v_tower = model.visual_model, built._int8_image_tower
    t_tower = index._int8_text_tower
    seq = service.max_text_length
    lens_np = rng.randint(5, seq + 1, 256).astype(np.int64)
    ids_np = np.zeros((256, seq), np.int64)
    for i, n in enumerate(lens_np):
        ids_np[i, :n] = rng.randint(1, 49408, n)
    ids, lens = torch.from_numpy(ids_np).cuda(), torch.from_numpy(lens_np).cuda()
    # the cases of tools/int8_ffn_ab.py, which times them alone
    cases = encode_cases(model, v_tower, t_tower, x, ids, lens)
    with torch.inference_mode():
        for _ in range(2):  # two rounds, so each case is timed twice apart
            for key, fn in cases.items():
                out.setdefault(key, []).append(cuda_ms(fn, 5))
    for key in cases:
        out[key] = float(np.mean(out[key]))
    log(f"time ViT-B/16 tower forward, B=128, 384x128, bf16: float "
        f"{out[('vit', 'float')]:.2f} ms; int8 with fused_ffn off (K8, the "
        f"default) {out[('vit', 'off')]:.2f} ms, on (K7) "
        f"{out[('vit', 'on')]:.2f} ms")
    log(f"time CLIP text tower forward, B=256, T={seq}, bf16: float "
        f"{out[('text', 'float')]:.2f} ms; int8 with fused_ffn on (K7, the "
        f"default) {out[('text', 'on')]:.2f} ms, off (K8) "
        f"{out[('text', 'off')]:.2f} ms")

    file = "gallery_int8enc_3074.idx"
    write_unit_index(os.path.join(service.reload_dir, file), 3074)
    out[("p50", "int8")] = search_latency(service, base, file, 3074)
    encoder, index._int8_text_encoder = index._int8_text_encoder, None
    try:  # the same server with the float text tower swapped back in
        out[("p50", "float")] = search_latency(service, base, file, 3074)
    finally:
        index._int8_text_encoder = encoder
    log(f"time /search p50 (1 query, k=10, 3074 rows, int8 gallery, full-CLIP "
        f"model): int8 text tower {out[('p50', 'int8')]:.3f} ms, float text "
        f"tower {out[('p50', 'float')]:.3f} ms")
    return out, (visual, v_tower, x)


def to_device(obj, device):
    """``obj`` (a module, a tensor, an ``Int8Tower``, or a tuple or dict of
    them) on ``device``; a tensor keeps its strides."""
    import dataclasses

    import torch

    if isinstance(obj, (torch.nn.Module, torch.Tensor)):
        return obj.to(device)
    if isinstance(obj, dict):
        return {key: to_device(v, device) for key, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def profile_int8_vit(visual, tower, x, forward_ms):
    """Device time of one int8 ViT-B/16 forward (B=128, ``fused_ffn`` off)
    by kernel family.  Run last, after every host-paced timing: taken
    before the full-CLIP model's ``/search`` timings, a ``torch.profiler``
    session slowed them by several ms a query, with either text tower."""
    import torch
    from textreid_torch.models.int8_vit import int8_vit_apply

    with torch.inference_mode():
        out = device_profile(
            lambda: int8_vit_apply(visual, tower, x, fused_ffn=False), 3,
            INT8_VIT_FAMILIES,
            "the int8 ViT-B/16 tower forward, B=128, fused_ffn off")
    if out:
        log(f"the int8 ViT-B/16 forward keeps the device busy "
            f"{out['total']:.2f} ms of the {forward_ms:.2f} ms timed")
    return out


# -- the flagship's gallery in int8: the int8-dataflow trunk and E1/E2 -------

TRUNK_KERNELS = ("int8_conv_epilogue", "int8_avg_pool")
TRUNK_BATCH = 128
# E1 against its plain version, at the flagship's shapes at batch 128
# (384x128, res5 stride 1): (name, rows, N, input, residual, relu, out)
E1_CASES = [
    ("layer1 conv3 + identity", 393216, 256, "int32", "asym", True, "asym"),
    ("stem conv1", 1572864, 32, "int32", None, True, "sym"),
    ("layer2 downsample", 98304, 512, "int32", None, False, "sym"),
    ("layer4 last conv3", 24576, 2048, "int32", "asym", True, "bfloat16"),
    ("pixel quantize", TRUNK_BATCH * 384 * 128, 3, "float32", None, False,
     "sym"),
    ("ragged", 37, 256, "int32", "sym", True, "asym"),
]
# E2: the stem's pool, a strided block's conv3 input and identity, a ragged
E2_CASES = [("stem", (TRUNK_BATCH, 192, 64, 64)),
            ("layer2 conv3 input", (TRUNK_BATCH, 96, 32, 128)),
            ("layer2 identity", (TRUNK_BATCH, 96, 32, 256)),
            ("ragged", (3, 7, 5, 8))]
# the gallery's int8 embeddings against the float tower's (the JAX
# package's bar); the interceptor's, as the JAX package's tests hold it
INTERCEPT_COSINE_BAR = 0.99
SIMPLE_RN_BN_FORWARDS = 20  # train-mode forwards that settle BatchNorm


def e1_inputs(rows, n, kind, res_mode, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "int32":
        x = torch.randint(-60000, 60000, (rows, n), generator=g,
                          device="cuda", dtype=torch.int32)
        s_w = torch.empty(n, device="cuda").uniform_(1e-4, 3e-3, generator=g)
        b = torch.randn(n, device="cuda", generator=g)
    else:
        x = torch.randn(rows, n, device="cuda", generator=g) * 3
        s_w = b = None
    res = s_res = None
    if res_mode:
        res = torch.randint(-128, 127, (rows, n), generator=g, device="cuda",
                            dtype=torch.int8)
        s_res = torch.empty(n, device="cuda").uniform_(0.01, 0.05,
                                                       generator=g)
    inv = 1.0 / torch.empty(n, device="cuda").uniform_(0.02, 0.2, generator=g)
    return x, inv, s_w, b, res, s_res


def check_int8_conv():
    """E1 and E2 against their plain versions, bit for bit, at the
    flagship's shapes (E1_CASES, E2_CASES), f32 and bf16 epilogues.
    Returns the largest difference (0.0 when equal)."""
    import torch
    from textreid_torch.ops import int8_conv

    t0 = time.time()
    worst = 0.0
    for name, rows, n, kind, res_mode, relu, out in E1_CASES:
        args = e1_inputs(rows, n, kind, res_mode, seed=rows % 97)
        for ep in (torch.float32, torch.bfloat16):
            got = int8_conv.int8_conv_epilogue(*args, res_mode=res_mode,
                                               relu=relu, out=out, ep=ep)
            want = int8_conv.conv_epilogue_plain(*args, res_mode=res_mode,
                                                 relu=relu, out=out, ep=ep)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            if got.dtype != want.dtype or not torch.equal(got, want):
                fail(f"E1 {name} ({ep}): differs from its plain version by "
                     f"{err}")
        del args, got, want
    for name, shape in E2_CASES:
        g = torch.Generator(device="cuda").manual_seed(len(name))
        xq = torch.randint(-128, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        got = int8_conv.int8_avg_pool(xq)
        want = int8_conv.avg_pool_int8(xq)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"E2 {name}: differs from its plain version")
    torch.cuda.empty_cache()
    log(f"E1 (int8_conv_epilogue) at {len(E1_CASES)} shapes x f32/bf16 and "
        f"E2 (int8_avg_pool) at {len(E2_CASES)}: equal to their plain "
        f"versions bit for bit ({time.time() - t0:.1f} s)")
    return worst


def time_int8_conv():
    """E1 at layer 1's conv3 with its identity and E2 at the stem's pool
    (batch 128), in turns with their plain versions; beside them
    ``torch._int_mm``'s product alone at that conv3 (``[393216, 64] @ [64,
    256]``, a yardstick, not the same function)."""
    import torch
    from textreid_torch.ops import int8_conv

    name, rows, n, kind, res_mode, relu, out = E1_CASES[0]
    args = e1_inputs(rows, n, kind, res_mode, seed=1)
    kw = dict(res_mode=res_mode, relu=relu, out=out, ep=torch.float32)
    e1 = interleaved_ms(lambda: int8_conv.int8_conv_epilogue(*args, **kw),
                        lambda: int8_conv.conv_epilogue_plain(*args, **kw),
                        20, 5)
    xq = torch.randint(-128, 128, (rows, 64), device="cuda",
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (n, 64), device="cuda",
                      dtype=torch.int8).t()
    int_mm = cuda_ms(lambda: torch._int_mm(xq, w), 20)
    del args, xq, w
    pool_in = torch.randint(-128, 128, E2_CASES[0][1], device="cuda",
                            dtype=torch.int8)
    e2 = interleaved_ms(lambda: int8_conv.int8_avg_pool(pool_in),
                        lambda: int8_conv.avg_pool_int8(pool_in), 20, 5)
    del pool_in
    torch.cuda.empty_cache()
    log(f"time E1 {name} [{rows}, {n}] f32 epilogue: {e1[0]:.4f} ms (plain "
        f"{e1[1]:.3f}); torch._int_mm's product alone at that conv "
        f"{int_mm:.4f} ms; E2 stem pool {E2_CASES[0][1]}: {e2[0]:.4f} ms "
        f"(plain {e2[1]:.3f})")
    return {"E1": e1, "E2": e2, "int_mm": int_mm}


def trunk_launches(visual):
    """E1 and E2 launches of one int8 trunk forward, from the design: one
    E1 a convolution plus the pixel quantize; one E2 after the stem and two
    a strided block (its conv3 input and its identity)."""
    from textreid_torch.models.int8_tower import STEM_UNITS, trunk_specs

    specs = trunk_specs(visual)
    e1 = len(STEM_UNITS) + 1 + sum(3 + s.has_downsample for s in specs)
    e2 = 1 + sum(2 for s in specs if s.stride > 1)
    return {"int8_conv_epilogue": e1, "int8_avg_pool": e2}


@contextmanager
def plain_trunk_kernels():
    """The int8 trunk's E1 and E2 through their plain versions (the
    products are torch._int_mm either way)."""
    import textreid_torch.models.int8_tower as int8_tower
    from textreid_torch.ops import int8_conv

    with mock.patch.object(int8_tower, "int8_conv_epilogue",
                           int8_conv.conv_epilogue_plain), \
            mock.patch.object(int8_tower, "int8_avg_pool",
                              int8_conv.avg_pool_int8):
        yield


def settle_batchnorm(model, pixels, forwards, batch=64):
    """Move the visual tower's BatchNorm running statistics off their init
    values by train-mode forwards (no gradient) over ``pixels``, as a
    trained checkpoint's would be: with init statistics (mean 0, var 1) a
    seeded trunk's eval forward mis-scales every BatchNorm."""
    import torch

    model.visual_model.train()
    with torch.no_grad():
        for i in range(forwards):
            start = (i * batch) % max(1, len(pixels) - batch + 1)
            model.encode_image(torch.from_numpy(
                pixels[start:start + batch]).cuda())
    model.visual_model.eval()


def seeded_settled_checkpoint(cfg, root, forwards):
    """A seeded full-width checkpoint whose BatchNorm statistics were
    settled on the synthetic test split under ``root``."""
    import glob

    import torch
    from PIL import Image
    from textreid_torch.data import make_synthetic_dataset
    from textreid_torch.models import build_model
    from textreid_torch.utils.weight_convert import save_reference_checkpoint

    data = make_synthetic_dataset(
        os.path.join(root, "datasets", "cuhkpedes"),
        num_identities=SPLIT_IDS, images_per_id=SPLIT_IMAGES_PER_ID,
        image_size=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH),
        vocab_size=cfg.MODEL.GRU.VOCABULARY_SIZE, max_tokens=60,
        split="test")
    pixels = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in
                       sorted(glob.glob(os.path.join(data, "imgs", "*")))])
    model = build_model(cfg, "cuda")
    settle_batchnorm(model, pixels, forwards)
    ckpt = os.path.join(root, "model.pth")
    save_reference_checkpoint(model.cpu(), ckpt)
    del model
    torch.cuda.empty_cache()
    return ckpt, pixels


def drive_int8_flagship():
    """The flagship at full width served from an int8-encoded gallery:
    ``build_index --int8-encode`` (the int8-dataflow trunk, calibrated on
    the first four gallery batches), again with ``--quantize``, ``serve``
    of each, ``/search`` and ``/search_image``.  Gates: E1 and E2 launched
    as the design gives a trunk forward; K1 once and K2 (K4 from the
    quantized index) once a /search; the replies equal to the plain path;
    the int8 gallery's min cosine to the float tower's >= 0.999; the int8
    embeddings equal to the same trunk through E1's and E2's plain
    versions."""
    import torch
    from textreid_torch.tools import build_index

    root = os.path.join(WORK, "int8_flagship")
    cfg, cfg_path = write_config(os.path.join(root, "configs", "cuhkpedes"))
    t0 = time.time()
    ckpt, pixels = seeded_settled_checkpoint(cfg, root, 20)
    workspace = (root, cfg, cfg_path, ckpt)
    common = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
              ckpt, "--device", "cuda"]
    float_index = build_index.main(common + ["--output", os.path.join(
        root, "float.idx")])
    log(f"int8 flagship: workspace, BatchNorm settled by 20 train-mode "
        f"forwards, float gallery in {time.time() - t0:.1f} s")
    results = {}
    for quantized in (False, True):
        (service, server, thread, base, text, images, counts,
         built) = drive_slice(quantized=quantized, workspace=workspace,
                              int8_encode=True)
        try:
            check_slice(service, text, images, counts)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        results[quantized] = counts
        want = trunk_launches(built.model.visual_model)
        batches = -(-len(built.gallery_meta) // cfg.TEST.IMS_PER_BATCH)
        for name, n in want.items():
            if counts[name] != n * batches:
                fail(f"build_index --int8-encode launched {name} "
                     f"{counts[name]} times, expected {n} x {batches} "
                     f"batches")
    cos = (built.gallery * float_index.gallery).sum(dim=1)
    if not torch.equal(torch.as_tensor(built.gallery_meta),
                       torch.as_tensor(float_index.gallery_meta)):
        fail("the int8 and the float gallery hold other rows")
    cos_min = cos.min().item()
    log(f"int8 flagship gallery ({len(cos)} rows) against the float "
        f"tower's: minimum cosine {cos_min:.5f}, mean {cos.mean().item():.5f}"
        f" (bar {INT8_COSINE_BAR})")
    if not cos_min >= INT8_COSINE_BAR:
        fail("the int8 flagship gallery misses the cosine bar")

    # one trunk forward at batch 128: launches, then the plain versions
    encode = built._int8_image_encoder
    x = torch.from_numpy(np.concatenate([pixels] * 2)[:TRUNK_BATCH]).cuda()
    with torch.inference_mode():
        got = forward_counts(lambda: encode(x), want,
                             f"int8 flagship trunk, B={TRUNK_BATCH}")
        with plain_trunk_kernels():
            zero_counts()
            plain = encode(x)
            if any(read_counts(TRUNK_KERNELS).values()):
                fail("the plain trunk launched E1 or E2")
    err = (got - plain).abs().max().item()
    log(f"int8 flagship embeddings, kernels against plain versions on the "
        f"card: max difference {err:.3e} (tol {SLICE_TOL:.0e})")
    if not err <= SLICE_TOL:
        fail("the int8 trunk disagrees with its plain versions")
    launches = {name: sum(c.get(name, 0) for c in results.values())
                for name in set(results[False]) | set(results[True])}
    return built, launches, cos_min


def drive_intercept():
    """The interceptor at full width: ``build_index --int8-encode`` on the
    simple head's torchvision ResNet-50 (which the JAX package's routing
    sends to the interceptor), served; its gallery against the float
    tower's at cosine >= INTERCEPT_COSINE_BAR."""
    import torch
    from textreid_torch.config import get_default_cfg
    from textreid_torch.tools import build_index, serve

    root = os.path.join(WORK, "intercept")
    folder = os.path.join(root, "configs", "cuhkpedes")
    os.makedirs(folder, exist_ok=True)
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, SIMPLE_RN_YAML))
    cfg.TEST.IMS_PER_BATCH = 64
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg_path = os.path.join(folder, os.path.basename(SIMPLE_RN_YAML))
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    t0 = time.time()
    ckpt, _ = seeded_settled_checkpoint(cfg, root, SIMPLE_RN_BN_FORWARDS)
    common = ["--root", root, "--config-file", cfg_path, "--checkpoint-file",
              ckpt, "--device", "cuda"]
    float_index = build_index.main(common + ["--output", os.path.join(
        root, "float.idx")])
    index_path = os.path.join(root, "gallery.idx")
    built = build_index.main(common + ["--output", index_path,
                                       "--int8-encode"])
    if built._int8_image_tower is not None or \
            built._int8_image_encoder is None:
        fail("build_index --int8-encode did not take the interceptor for "
             "the torchvision ResNet-50")
    cos = (built.gallery * float_index.gallery).sum(dim=1).min().item()
    service, server = serve.build_server(common + [
        "--index-file", index_path, "--port", "0", "--reload-dir", root])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        rng = np.random.RandomState(23)
        seq = cfg.INPUT.MAX_TEXT_LENGTH
        meta_ids = set(service.index.gallery_meta.tolist())
        for n in (1, 4):
            ids = rng.randint(1, cfg.MODEL.GRU.VOCABULARY_SIZE,
                              (n, seq)).astype(np.int32)
            reply = post(base + "/search", {
                "token_ids": ids.tolist(), "lengths": [seq] * n, "k": 10})
            check_reply(reply, n, 10, meta_ids, f"interceptor /search n={n}")
        px = rng.randint(0, 255, (1, cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH, 3),
                         dtype=np.uint8)
        reply = post(base + "/search_image", {
            "images_b64": [base64.b64encode(px[0].tobytes()).decode()],
            "k": 10})
        check_reply(reply, 1, 10, meta_ids, "interceptor /search_image")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"interceptor (torchvision ResNet-50, 384x128): build_index "
        f"--int8-encode + serve + 3 requests in {time.time() - t0:.1f} s; "
        f"gallery minimum cosine to the float tower {cos:.5f} (bar "
        f"{INTERCEPT_COSINE_BAR})")
    if not cos >= INTERCEPT_COSINE_BAR:
        fail("the interceptor's gallery misses its cosine bar")
    model = built.model
    del built, float_index, service
    torch.cuda.empty_cache()
    return cos, model


def time_int8_flagship(model, rows=3074, batch=TRUNK_BATCH):
    """Gallery encode img/s of the flagship (bf16) over ``rows`` images at
    batch 128: the float tower, the int8-dataflow trunk and the
    interceptor, in turns (float, int8, interceptor, interceptor, int8,
    float), each after a calibrating / warming build of 4 batches."""
    import torch
    from textreid_torch.serving import RetrievalIndex

    rng = np.random.RandomState(29)
    h, w = model.visual_model.attnpool.spacial_dim
    pixels = rng.randint(0, 255, (rows, 16 * h, 16 * w, 3), dtype=np.uint8)
    batches = [pixels[i:i + batch] for i in range(0, rows, batch)]
    batches[-1] = np.concatenate([batches[-1], batches[-1][-1:].repeat(
        batch - len(batches[-1]), axis=0)])
    modes = {"float": False, "int8 dataflow": True,
             "interceptor": "intercept"}
    out = {}
    for kind in ("float", "int8 dataflow", "interceptor", "interceptor",
                 "int8 dataflow", "float"):
        idx = RetrievalIndex(model, int8_encode=modes[kind])
        idx.build_gallery(batches[:4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.build_gallery(batches, valid_rows=rows)
        torch.cuda.synchronize()
        out.setdefault(kind, []).append(rows / (time.perf_counter() - t0))
        if kind == "int8 dataflow":
            tower = idx._int8_image_tower
        del idx
    log(f"time gallery encode, the flagship (CLIP RN50 384x128, bf16), "
        f"{rows} images at batch {batch} (host copies included; two runs "
        f"each, in turns): " + ", ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f} img/s" for k, v in out.items()))
    return out, tower


# the int8 trunk's kernel families: E1 and E2 before the library's products
# and copies
TRUNK_FAMILIES = (("E1", ("epilogue_kernel",)),
                  ("E2", ("avg_pool_kernel",)),
                  ("int8 products", ("gemm", "cutlass", "cublas", "xmma",
                                     "nvjet", "wgmma", "imma", "igemm")),
                  ("im2col copies", ("copy", "pad", "elementwise",
                                     "unrolled")))


def profile_int8_trunk(model, tower, batch=TRUNK_BATCH):
    """Device time of one int8 flagship trunk forward (B=128) by kernel
    family, and of the whole encoder (trunk, attention pool, head): the
    attention pool and head are the difference.  Run last, after every
    host-paced timing."""
    import torch
    from textreid_torch.models.int8_tower import int8_trunk_apply
    from textreid_torch.models.losses import l2_normalize
    from textreid_torch.models.model import preprocess_pixels

    visual = model.visual_model
    h, w = visual.attnpool.spacial_dim
    x = preprocess_pixels(torch.randint(0, 255, (batch, 16 * h, 16 * w, 3),
                                        device="cuda", dtype=torch.uint8),
                          None, model.pixel_mean, model.pixel_std)

    def trunk():
        return int8_trunk_apply(visual, tower, x, out_dtype=model.dtype)

    def encoder():
        feat = visual.attnpool(trunk().permute(0, 3, 1, 2))
        return l2_normalize(model.embed_image(feat).float(), dim=1)

    with torch.inference_mode():
        trunk_ms = cuda_ms(trunk, 5)
        out = device_profile(trunk, 3, TRUNK_FAMILIES,
                             f"the int8 flagship trunk forward, B={batch}")
        whole = device_profile(encoder, 3, (), "the int8 flagship encoder "
                               "(trunk, attention pool, head)")
    if out and whole:
        out["attention pool and head"] = whole["total"] - out["total"]
        log(f"the int8 flagship trunk keeps the device busy "
            f"{out['total']:.2f} ms of the {trunk_ms:.2f} ms timed; the "
            f"attention pool and head add {out['attention pool and head']:.2f}"
            f" ms")
    return out, trunk_ms


def int8_conv_bounds():
    """Roofline bound (ms, what binds) of E1 and E2 at their timed shapes:
    E1 at layer 1's conv3 with its identity, f32 epilogue (the s32
    accumulator and the int8 residual read, the int8 result written, four
    per-channel vectors; about 10 f32 operations an element); E2 at the
    stem's pool (the int8 input read, a quarter written; 4 integer
    operations an output element, counted at the f32 rate)."""
    _, rows, n = E1_CASES[0][:3]
    b, h, w, c = E2_CASES[0][1]
    return {
        "int8_conv_epilogue": bound(rows * n * (4 + 1 + 1) + 4 * 4 * n,
                                    10 * rows * n, "float32"),
        "int8_avg_pool": bound(b * h * w * c * 5 // 4, b * h * w * c,
                               "float32"),
    }


# -- phase 4: timings -------------------------------------------------------

def time_kernels():
    import torch
    from textreid_torch.ops import gru, ranking
    from textreid_torch.tools.gru_variants import (streamed_backward,
                                                  streamed_forward,
                                                  streamed_scan)

    out = {}
    # K1's bf16 forward: the W-resident kernel against the streamed one it
    # replaced, interleaved (streamed, resident, resident, streamed)
    for batch in (256, 128):  # the timed row's batch; the train step's
        args = k1_inputs(batch, torch.bfloat16, seed=1)
        with torch.no_grad():
            new_ms, old_ms = interleaved_ms(
                lambda: gru.bigru_pooled_scan(*args, pool_mode="always"),
                lambda: streamed_forward(*args), 10, 10)
            old_err = (gru.zero_participation(streamed_forward(*args),
                                              args[4], 105, "always").float()
                       - gru.zero_participation(
                           gru.bigru_pooled_scan_plain(*args), args[4], 105,
                           "always").float()).abs().max().item()
        out[("K1 streamed", batch)] = old_ms
        log(f"time K1 B={batch} T=105 H=512 bfloat16: W-resident kernel "
            f"{new_ms:.3f} ms, the streamed kernel it replaced {old_ms:.3f} "
            f"ms (its max_abs_err {old_err:.3e})")
    for batch in (256, 128, 64):  # the timed row's batch; the train
        # step's; encode_queries' chunk
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
    # K3's bf16 scan: the W-resident kernel against the streamed one it
    # replaced, in turns
    for batch in (256, 128, 1):  # the timed row's batch; the eval batch;
        # one query
        args = k3_inputs(batch, torch.bfloat16, seed=1)
        new_ms, old_ms = interleaved_ms(lambda: gru.gru_scan(*args),
                                        lambda: streamed_scan(*args), 10, 10)
        out[("K3 vs streamed", batch)] = (new_ms, old_ms)
        log(f"time K3 B={batch} T=105 H=512 bfloat16: W-resident kernel "
            f"{new_ms:.3f} ms, the streamed kernel it replaced {old_ms:.3f} "
            f"ms")
    for batch in (256, 128, 1):  # the timed row's batch; the eval batch;
        # one query
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
    # cluster's worth of rows (B=8), where nothing but the chain waits; from
    # T=55, where even a 2 us step keeps a call longer than the host takes
    # to issue it (from T=5 the host would set the short call's time)
    for kname in ("K1", "K1 streamed", "K1 bwd", "K1 bwd streamed", "K3",
                  "K3 streamed"):
        ms_t = {}
        for seq in (55, 105):
            if kname == "K1":
                args = k1_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: gru.bigru_pooled_scan(
                    *args, pool_mode="always"), 20)
            elif kname == "K1 streamed":
                args = k1_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: streamed_forward(*args), 20)
            elif kname.startswith("K1 bwd"):  # row 0 has the full length;
                # the kernel alone (the dW product grows with T too)
                args = k1_inputs(8, torch.bfloat16, seed=1, seq=seq)
                saved = gru.bigru_pooled_fwd_train(*args)[1:]
                g = torch.ones(8, 1024, device="cuda", dtype=torch.bfloat16)
                bwd = (streamed_backward if kname.endswith("streamed")
                       else gru.launch_bigru_pooled_bwd)
                ms_t[seq] = cuda_ms(lambda: bwd(
                    g, args[2], args[3], args[4], *saved), 20)
            elif kname == "K3":
                args = k3_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: gru.gru_scan(*args), 20)
            else:
                args = k3_inputs(8, torch.bfloat16, seed=1, seq=seq)
                ms_t[seq] = cuda_ms(lambda: streamed_scan(*args), 20)
        step_us = (ms_t[105] - ms_t[55]) / 50 * 1e3
        out[(kname, "step_us")] = step_us
        log(f"time {kname} one dependent step (B=8, bf16, slope of T=55 -> "
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


# (Q, G) at which K2 and K4 are timed, D = 256, k = 10: a lone /search and a
# micro-batch of 256 queries, over 3,074 and 98,304 rows
TOPK_SHAPES = ((1, 3074), (1, 98304), (256, 3074), (256, 98304))


def topk_bound(kind, n_q, n_g, dim=256, k=10):
    """K2's ("f32") or K4's ("int8") roofline at a shape: the queries and the
    gallery (int8 rows and f32 scales) read once, the [Q, k] values and rows
    written once, against 2 Q G D operations (K4's products are bf16)."""
    if kind == "f32":
        return bound(4 * (n_q * dim + n_g * dim) + 8 * n_q * k,
                     2 * n_q * n_g * dim, "float32")
    return bound(4 * n_q * dim + n_g * dim + 4 * n_g + 8 * n_q * k,
                 2 * n_q * n_g * dim, "bfloat16")


def time_topk():
    """K2 (f32) and K4 at TOPK_SHAPES against the kernels they replaced
    (``tools/topk_variants.py``), in turns (old, new, new, old), as the host
    issues the launches and queued behind a device sleep; with each shape's
    bound, plan, and the rows a query a split that entered its running
    top-k (the plan's decomposition, ``ops/ranking.py:topk_by_plan``, on the
    same scores)."""
    import torch
    from textreid_torch.ops import ranking
    from textreid_torch.ops.quant import QuantizedGallery, quantized_scores
    from textreid_torch.tools import topk_variants

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for n_q, n_g in TOPK_SHAPES:
        res = topk_variants.compare(n_q, n_g)
        q, gal, values, scales = topk_variants.unit_inputs(n_q, n_g)
        for name, kind in (("K2", "f32"), ("K4", "int8")):
            plan = ranking.topk_plan(n_q, n_g, 256, sms, kind)
            scores = (q @ gal.T if kind == "f32" else quantized_scores(
                q, QuantizedGallery(values, scales)))
            _, _, inserted = ranking.topk_by_plan(scores, 10, plan)
            bound_ms, binds = topk_bound(kind, n_q, n_g)
            (new_i, old_i), (new_q, old_q) = (res[name]["issued"],
                                              res[name]["queued"])
            out[(name, n_q, n_g)] = dict(issued=new_i, queued=new_q,
                                         old_issued=old_i, old_queued=old_q,
                                         bound=bound_ms, binds=binds,
                                         inserted=inserted)
            log(f"time {name} Q={n_q} G={n_g} D=256 k=10 (plan: {plan.q_tile}"
                f"-query tiles x {plan.splits} splits, {plan.stages} stages):"
                f" kernel {new_i:.4f} ms as issued, {new_q:.4f} ms queued; "
                f"the kernel it replaced {old_i:.4f} / {old_q:.4f} ms (in "
                f"turns); bound {bound_ms:.5f} ms ({binds}); rows entering a "
                f"split's top-k {inserted:.1f} a query (k(1 + ln(rows / k)) "
                f"= {10 * (1 + math.log(max(n_g / plan.splits, 10) / 10)):.1f}"
                f"); outputs equal the replaced kernel's: "
                f"{res[name]['agree']}")
    return out


def kernel_bounds(bwd_steps):
    """Roofline bound (ms, what binds) of each kernel at the shape its row
    of the ``kernels`` line is timed at: every input read once, every
    output written once, against the operations of the function.
    ``bwd_steps``: the (row, step) pairs with ``t < len`` of K1's timed
    backward inputs, the steps whose gradient its data needs."""
    from textreid_torch.utils.profiling import (
        attention_work,
        k1_backward_work,
        k1_forward_work,
    )

    b, t, h = 256, 105, 512  # K1, K3: a batch of 256, bf16
    tb = 128  # K1's backward: the train step's batch, bf16
    q, d, g, k = 256, 256, 3074, 10  # K2, K4: the 3,074-row gallery
    ab, s, w, heads = 128, 193, 768, 12  # K5, K6: ViT-B/16 at 384x128, bf16
    (_, vr, vk, vn), (_, tr, tk, tn) = INT8_SHAPES[:2]  # K8, K9; K7
    k1_bwd_bytes, k1_bwd_ops = k1_backward_work(tb, t, h, bwd_steps)
    return {
        # the pooled-only forward (utils/profiling.py:k1_forward_work)
        "bigru_pooled_fwd": bound(*k1_forward_work(b, t, h)),
        # the backward with dW at the f32 rate and the serial product at
        # the bf16 rate, twice (utils/profiling.py:k1_backward_work)
        "bigru_pooled_bwd": bound(k1_bwd_bytes, k1_bwd_ops),
        # ... as rows before this kernel priced it: both products (the
        # serial one once) at the f32 rate (logged beside the row, for
        # comparison with them)
        "bigru_pooled_bwd f32-priced": bound(
            k1_bwd_bytes, k1_bwd_ops["float32"] + k1_bwd_ops["bfloat16"] // 2,
            "float32"),
        # one direction: x, W and h0 read, every h_t written
        "gru_scan_fwd": bound(
            2 * (b * t * 3 * h + h * 3 * h + b * h + b * t * h),
            t * 2 * b * h * 3 * h, "bfloat16"),
        "topk_similarity_f32": topk_bound("f32", q, g, d, k),
        "topk_similarity_int8": topk_bound("int8", q, g, d, k),
        # qkv read, out written; QK^T and PV
        "fused_attention_fwd": bound(*attention_work(ab, s, w, heads),
                                     "bfloat16"),
        # qkv and g read, dqkv written; S, dP, dV, dQ, dK
        "fused_attention_bwd": bound(
            *attention_work(ab, s, w, heads, backward=True), "bfloat16"),
        # the text FFN (bf16 out): int8 rows and both weights read, the
        # output written; two s8 products
        "int8_ffn": bound(
            tr * tk + 2 * tk * tn + 2 * tr * tk + 4 * (3 * tn + 2 * tk + tr),
            2 * tr * tn * (tk + tk), "int8"),
        # the ViT's c_fc: int8 rows and weight read, int8 rows and f32 row
        # scales written; one s8 product
        "int8_matmul_requant": bound(
            vr * vk + vk * vn + vr * vn + 4 * (3 * vn + 2 * vr),
            2 * vr * vk * vn, "int8"),
        # the ViT's ln sites: bf16 rows read, int8 rows and f32 row scales
        # written; ~10 f32 operations an element
        "fused_requant": bound(2 * vr * vk + 4 * vk + vr * vk + 4 * vr,
                               10 * vr * vk, "float32"),
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
        log(f"time index.search (1 query, k=10, {rows} "
            f"rows, 2-layer GRU model): float gallery "
            f"{out[('search', rows, False)]:.3f} ms, int8 gallery "
            f"{out[('search', rows, True)]:.3f} ms (median of 20)")
    # a micro-batch: 256 queries at once (the server's MAX_BATCH), the
    # largest gallery; host clock around a synchronised call and the device
    # time between CUDA events around it
    rng = np.random.RandomState(7)
    ids = rng.randint(1, 512, (256, 105)).astype(np.int32)
    lens = rng.randint(5, 106, 256).astype(np.int32)
    for quantize in (False, True):
        index = RetrievalIndex(model, quantize=quantize)
        index.load_index(os.path.join(service.reload_dir, "unit_98304.idx"))
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
        out[("search256", quantize)] = (float(np.median(host)),
                                        float(np.median(device)))
        log(f"time index.search (256 queries, k=10, 98304 rows, 2-layer GRU "
            f"model, {'int8' if quantize else 'float'} gallery): "
            f"{np.median(host):.3f} ms host, {np.median(device):.3f} ms "
            f"between events (median of 10)")
    return out


# -- the evaluation slice ------------------------------------------------------

class GridCapture:
    """Collects what ``PersonSearch.inference`` (or the logger ``name``)
    logs, with each record's time in ``times``: the metric grid is the last
    message of an evaluation."""

    def __init__(self, name="PersonSearch.inference"):
        import logging

        outer = self
        self.messages, self.times = [], []

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())
                outer.times.append(record.created)

        self.handler = Handler(logging.INFO)
        self.logger = logging.getLogger(name)

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

def yaml_cfg(yaml):
    from textreid_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, yaml))
    return cfg


def training_split(batch, steps):
    """``WORK/train<batch>/datasets/cuhkpedes``: a synthetic train split of
    ``steps`` batches of ``batch`` (4 images an identity) at 384x128,
    made once."""
    from textreid_torch.data import make_synthetic_dataset

    data = os.path.join(WORK, f"train{batch}", "datasets", "cuhkpedes")
    if not os.path.isdir(data):
        make_synthetic_dataset(data, num_identities=batch // 4 * steps,
                               images_per_id=4, image_size=(384, 128),
                               vocab_size=512, max_tokens=60, split="train")
    return data


def write_fullclip_archive(root):
    """A seeded CLIP-layout ``ROOT/pretrained/clip/ViT-B-16.pt``: the port's
    ViT-B/16 at CLIP's 224x224 (a 14x14 + 1 positional table) under
    ``visual.`` and its CLIP text transformer at 77 positions at the top
    level.  Returns the state dict."""
    import torch
    from textreid_torch.models.text_transformer import TextTransformer
    from textreid_torch.models.vit import VisionTransformer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(12)
        visual = VisionTransformer((224, 224), patch_size=16, width=768,
                                   layers=12, heads=12, output_dim=512)
        text = TextTransformer(context_length=77)
        archive = {"visual." + k: v for k, v in visual.state_dict().items()}
        archive.update({k: v + 0.01 * torch.randn(v.shape)
                        for k, v in text.state_dict().items()})
    folder = os.path.join(root, "pretrained", "clip")
    os.makedirs(folder, exist_ok=True)
    torch.save(archive, os.path.join(folder, "ViT-B-16.pt"))
    return archive


@contextmanager
def watching_the_start(frozen, archive=None):
    """As ``train_net`` hands its state to ``do_train`` (before the first
    step): a copy of every frozen parameter of the query model into
    ``frozen``; with ``archive`` (a full-CLIP ``ViT-B-16.pt``), a check
    that the query and the key text towers hold its text half (the token
    table equal, the positional table equal to the archive's resampled to
    the tower's context length) and the ViTs its visual half."""
    import torch
    from textreid_torch.engine import trainer
    from textreid_torch.utils.weight_convert import convert_clip_text

    real = trainer.do_train

    def checked(cfg, state, *args, **kwargs):
        frozen.update({n: p.detach().cpu().clone()
                       for n, p in state.model.named_parameters()
                       if not p.requires_grad})
        if archive is not None:
            tower = state.model.textual_model
            text = convert_clip_text(archive, tower.layers,
                                     tower.context_length, prefix="")
            for which, model in (("query", state.model),
                                 ("key", state.key_model)):
                tower = model.textual_model
                if not (torch.equal(tower.token_embedding.weight.cpu(),
                                    torch.as_tensor(text[
                                        "token_embedding.weight"]))
                        and torch.equal(tower.positional_embedding.cpu(),
                                        torch.as_tensor(text[
                                            "positional_embedding"]))
                        and torch.equal(
                            model.visual_model.conv1.weight.cpu(),
                            archive["visual.conv1.weight"])):
                    fail(f"the {which} towers do not hold the CLIP archive")
        return real(cfg, state, *args, **kwargs)

    with mock.patch.object(trainer, "do_train", checked):
        yield


def drive_training(model_name):
    """``textreid_torch.train_net.main`` on a synthetic train split, one
    epoch of TRAIN_STEPS batches (ACCUM8_STEPS for accum8), for one of
    TRAIN_MODELS, in a workspace of its own (the full-CLIP model's with a
    seeded ``ViT-B-16.pt``, whose halves both towers must hold as training
    starts); then the run's checks (:func:`check_training`) and its
    checkpoint through ``--resume-from``.  Returns the launches."""
    import shutil

    import torch
    from textreid_torch import train_net

    t0 = time.time()
    yaml = TRAIN_MODELS[model_name][0]
    cfg = yaml_cfg(yaml)
    batch = cfg.SOLVER.IMS_PER_BATCH
    steps = ACCUM8_STEPS if batch > 128 else TRAIN_STEPS
    data = training_split(batch, steps)
    root = os.path.join(WORK, "train_" + "".join(
        c if c.isalnum() else "_" for c in model_name))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "datasets"))
    os.symlink(data, os.path.join(root, "datasets", "cuhkpedes"))
    archive = (write_fullclip_archive(root) if model_name == "full-CLIP"
               else None)
    argv = ["--root", root, "--config-file", os.path.join(REPO, yaml),
            "--device", "cuda", "SOLVER.EVALUATE_PERIOD", "0",
            "SOLVER.NUM_EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "SOLVER.LOG_PERIOD", "1", "TPU.DEBUG_NANS", "True",
            "TPU.ALLOW_RANDOM_VOCAB", "True", "DATALOADER.NUM_WORKERS", "8"]
    frozen = {}
    zero_counts()
    t_run = time.time()
    with watching_the_start(frozen, archive):
        state, meters = train_net.main(argv)
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    counts = read_counts(TRAIN_KERNELS)
    waits = list(meters.data.deque)
    log(f"training slice, {model_name}: train_net.main, {state.step} steps "
        f"in {run_s:.1f} s; launches {counts}; the step waited "
        f"on the loader {', '.join(f'{w * 1e3:.1f}' for w in waits)} ms "
        f"(step times {', '.join(f'{v * 1e3:.1f}' for v in meters.time.deque)}"
        f" ms, the first with the tower's warmup)")
    ckpt = os.path.join(root, "output", "cuhkpedes",
                        os.path.splitext(os.path.basename(yaml))[0],
                        "epoch_1.pth")
    check_training(model_name, counts, state, meters, ckpt, steps=steps,
                   batch=batch)
    if cfg.MODEL.FREEZE != bool(frozen):
        fail(f"{model_name}: MODEL.FREEZE but no frozen parameter, or the "
             "reverse")
    moved = [n for n, p in state.model.named_parameters()
             if n in frozen and not torch.equal(p.detach().cpu(), frozen[n])]
    if moved:
        fail(f"{model_name}: frozen parameters moved: {moved[:4]}")
    resumed, _ = train_net.main(["--resume-from", ckpt] + argv)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    if resumed.step != steps or any(
            not torch.equal(v.cpu(), saved["model"][k])
            for k, v in resumed.model.state_dict().items()):
        fail(f"{model_name}: --resume-from {ckpt} does not restore the run")
    log(f"training slice, {model_name}: {len(frozen)} frozen parameters "
        f"bit-identical after the run; --resume-from restores step "
        f"{resumed.step} and every tensor of the model; phase "
        f"{time.time() - t0:.1f} s ({card_line()})")
    del state, resumed, saved
    shutil.rmtree(os.path.join(root, "output"), ignore_errors=True)
    return counts


def check_training(model_name, counts, state, meters, ckpt,
                   steps=TRAIN_STEPS, eval_launches=None, batch=128):
    """The run's steps, launches (per step, plus ``eval_launches`` of the
    evaluations), finite losses, queue pointer (MoCo) and checkpoint."""
    import torch

    if state.step != steps:
        fail(f"training slice ran {state.step} steps, not {steps}")
    want = {name: n * steps for name, n in TRAIN_MODELS[model_name][1].items()}
    for name, n in (eval_launches or {}).items():
        want[name] += n
    if counts != want:
        fail(f"training slice, {model_name}: launches {counts}, expected "
             f"{want}")
    losses = list(meters.loss.deque)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"training losses {losses}")
    moco = state.key_model is not None
    if moco and state.queue_ptr != steps * batch % 2048:
        fail(f"queue_ptr {state.queue_ptr} after {steps} steps")
    if not os.path.isfile(ckpt):
        fail(f"no checkpoint at {ckpt}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    if saved["meta"]["iteration"] != steps or moco != ("key_model" in saved):
        fail("the checkpoint does not hold the run's state")
    if moco and (saved["queue_ptr"] != state.queue_ptr
                 or not torch.isfinite(saved["v_queue"]).all()):
        fail("the checkpoint does not hold the run's queue")
    # BatchNorm towers: the running statistics are in the checkpoint,
    # finite, moved off their start (mean 0, var 1) by the batches, and
    # for MoCo apart from the key model's (the key forward moves those)
    stats = [k for k in saved["model"] if k.endswith(
        (".running_mean", ".running_var"))]
    if stats:
        for k in stats:
            q = saved["model"][k]
            key = saved["key_model"].get(k) if moco else q
            if key is None or not (torch.isfinite(q).all()
                                   and torch.isfinite(key).all()):
                fail(f"the checkpoint's BatchNorm statistic {k} is missing "
                     "or not finite")
        name = "visual_model.layer4.0.bn3.running_var"
        q = saved["model"][name]
        if torch.equal(q, torch.ones_like(q)) or (
                moco and torch.equal(q, saved["key_model"][name])):
            fail(f"{name} did not move, or equals the key model's")
    models = "the query and the key model" if moco else "the model"
    log(f"training slice, {model_name}: losses "
        f"{[round(v, 4) for v in losses]}, queue_ptr {state.queue_ptr}, "
        f"checkpoint {os.path.relpath(ckpt, REPO)} "
        f"({os.path.getsize(ckpt) >> 20} MB; {len(stats)} BatchNorm "
        f"statistics in each of {models})")
    return losses


# The flagship trained as shipped (phase 8): its yaml with no
# SOLVER.EVALUATE_PERIOD override (1: an evaluation after every epoch on the
# test split, a best.pth on t2i R@1), CHECKPOINT_KEEP 1, two epochs of
# TRAIN_STEPS steps, from a seeded CLIP-layout RN50.pt
PROTOCOL_EPOCHS = 2
# The resumed epoch's losses against the straight run's epoch 2, bf16 steps
# from the same state and batches, cuDNN deterministic for both: equal but
# where cuBLAS picks another algorithm in the resumed run's new state
# (that reorders an f32 sum: a loss moves by about one bf16 rounding of an
# activation, 2^-8 relative, averaged over 128 rows)
RESUME_LOSS_RTOL = 1e-3


def write_clip_archive(root):
    """A seeded CLIP-layout ``ROOT/pretrained/clip/RN50.pt``: the port's
    ModifiedResNet-50 at CLIP's 224x224 (a 7x7 + 1 positional embedding)
    under ``visual.``, BatchNorm statistics moved off (0, 1).  Returns the
    state dict."""
    import torch
    from textreid_torch.models.m_resnet import ModifiedResNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        clip = ModifiedResNet((3, 4, 6, 3), 1024, heads=32,
                              input_resolution=(224, 224))
        archive = {}
        for k, v in clip.state_dict().items():
            if k.endswith("running_mean"):
                v = torch.randn(v.shape) * 0.1
            elif k.endswith("running_var"):
                v = torch.rand(v.shape) + 0.5
            archive["visual." + k] = v
    folder = os.path.join(root, "pretrained", "clip")
    os.makedirs(folder, exist_ok=True)
    torch.save(archive, os.path.join(folder, "RN50.pt"))
    return archive


@contextmanager
def holding_the_archive(archive, seen):
    """Checks, as ``train_net`` hands its state to ``do_train`` (before the
    first step), that the query and the key trunk hold ``archive``: the
    first convolution and a BatchNorm's running variance equal, the
    attention pool's positional embedding equal to the archive's resized
    to the trunk's grid.  Appends the grid to ``seen``."""
    import torch
    from textreid_torch.engine import trainer
    from textreid_torch.utils.weight_convert import resize_pos_embed

    real = trainer.do_train

    def checked(cfg, state, *args, **kwargs):
        for which, model in (("query", state.model),
                             ("key", state.key_model)):
            visual = model.visual_model
            grid = visual.attnpool.spacial_dim
            pos = torch.from_numpy(resize_pos_embed(
                archive["visual.attnpool.positional_embedding"].numpy(),
                grid))
            if not (torch.equal(visual.conv1.weight.cpu(),
                                archive["visual.conv1.weight"])
                    and torch.equal(
                        visual.layer4[2].bn3.running_var.cpu(),
                        archive["visual.layer4.2.bn3.running_var"])
                    and torch.equal(
                        visual.attnpool.positional_embedding.cpu(), pos)):
                fail(f"the {which} trunk does not hold the CLIP archive")
            seen.append(grid)
        return real(cfg, state, *args, **kwargs)

    with mock.patch.object(trainer, "do_train", checked):
        yield


@contextmanager
def cudnn_deterministic():
    import torch

    kept = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = kept


def drive_flagship_protocol():
    """The flagship trained as shipped through ``train_net.main`` at full
    width: the CLIP archive in both trunks, PROTOCOL_EPOCHS epochs with an
    evaluation after each, ``best.pth`` and pruning; ``test_net.main`` on
    ``best.pth``; one epoch plus ``--resume-from auto`` against the
    straight run; a SIGTERM mid-epoch and the resume from ``preempt.pth``.
    Returns the straight run's launches (the main path's)."""
    import re
    import shutil
    import signal

    import torch
    from textreid_torch import test_net, train_net
    from textreid_torch.config import get_default_cfg
    from textreid_torch.data import make_data_loader, make_synthetic_dataset
    from textreid_torch.engine import trainer
    from textreid_torch.utils.checkpoint import auto_resume_path, read_meta

    t_phase = time.time()
    name = "CLIP RN50 + bi-GRU (flagship)"
    root = os.path.join(WORK, "protocol")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "datasets", "cuhkpedes")
    make_synthetic_dataset(data, num_identities=32 * TRAIN_STEPS,
                           images_per_id=4, image_size=(384, 128),
                           vocab_size=512, max_tokens=60, split="train")
    make_synthetic_dataset(data, num_identities=SPLIT_IDS,
                           images_per_id=SPLIT_IMAGES_PER_ID,
                           image_size=(384, 128), vocab_size=512,
                           max_tokens=60, split="test", seed=1)
    archive = write_clip_archive(root)
    opts = ["SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.CHECKPOINT_KEEP", "1",
            "SOLVER.LOG_PERIOD", "1", "TPU.DEBUG_NANS", "True",
            "TPU.ALLOW_RANDOM_VOCAB", "True", "DATALOADER.NUM_WORKERS", "8"]

    def yaml_of(run):  # a copy of the flagship's yaml a run: its own output
        path = os.path.join(root, "configs", run, "flagship.yaml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copy(os.path.join(REPO, FLAGSHIP_YAML), path)
        return path

    def out_of(run):
        return os.path.join(root, "output", run, "flagship")

    def run(run_name, *extra):
        return train_net.main(["--root", root, "--config-file",
                               yaml_of(run_name), "--device", "cuda",
                               *extra, *opts])

    cfg = get_default_cfg()
    cfg.merge_from_file(yaml_of("straight"))
    cfg.merge_from_list(opts)
    cfg.ROOT = root
    eval_batches = len(make_data_loader(cfg, is_train=False)[0])
    steps = PROTOCOL_EPOCHS * TRAIN_STEPS

    # the straight run: the main path, its launches counted
    grids = []
    with GridCapture("PersonSearch") as logs, cudnn_deterministic(), \
            holding_the_archive(archive, grids):
        zero_counts()
        t0 = time.time()
        state, meters = run("straight", "SOLVER.NUM_EPOCHS",
                            str(PROTOCOL_EPOCHS))
        torch.cuda.synchronize()
        counts = read_counts(TRAIN_KERNELS)
        straight_s = time.time() - t0
    out = out_of("straight")
    # a step's launches as in the other runs (K1 forward 2, backward 1),
    # and K1's pooled-only forward once an evaluation batch: with 3 steps
    # an epoch and 2 evaluations of 2 batches (256 pairs, TEST.IMS_PER_BATCH
    # 128), K1's forward 16 and its backward 6
    check_training(name, counts, state, meters,
                   os.path.join(out, f"epoch_{PROTOCOL_EPOCHS}.pth"), steps,
                   {"bigru_pooled_fwd": eval_batches * PROTOCOL_EPOCHS})
    if len(grids) != 2 or grids[0] != (24, 8):
        fail(f"the archive check saw grids {grids}, not the query and key "
             "trunks' (24, 8)")
    top1 = list(meters.top1.deque)
    evals = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
             for m in map(re.compile(
                 r"Evaluation after epoch (\d+): t2i R@1 ([\d.]+) in "
                 r"([\d.]+) s").match, logs.messages) if m]
    if len(top1) != PROTOCOL_EPOCHS or not all(
            math.isfinite(v) for v in top1) or len(evals) != len(top1):
        fail(f"in-training evaluation: top1 {top1}, logged {evals}")
    best = read_meta(os.path.join(out, "best.pth"))
    kept = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
    if kept != ["best.pth", f"epoch_{PROTOCOL_EPOCHS}.pth"]:
        fail(f"checkpoints after the straight run: {kept}")
    if best["best_top1"] != max(top1) or best["epoch"] != 1 + top1.index(
            max(top1)):
        fail(f"best.pth meta {best}, top1 by epoch {top1}")
    saves = [(m.group(1), float(m.group(2)), float(m.group(3)))
             for m in map(re.compile(
                 r"Saved checkpoint (\S+): snapshot ([\d.]+) s, write "
                 r"([\d.]+) s").match, logs.messages) if m]
    straight_losses = list(meters.loss.deque)[-TRAIN_STEPS:]
    log(f"flagship as shipped: train_net.main, {PROTOCOL_EPOCHS} epochs of "
        f"{TRAIN_STEPS} steps with an evaluation after each ({eval_batches} "
        f"batches of {cfg.TEST.IMS_PER_BATCH}) in {straight_s:.1f} s; "
        f"launches {counts}; t2i R@1 by epoch {top1}; best.pth from epoch "
        f"{best['epoch']}; kept {kept} (CHECKPOINT_KEEP 1); both trunks "
        f"held the CLIP archive, its positional embedding resized 7x7 -> "
        f"{grids[0]}")
    for epoch, r1, secs in evals:
        log(f"  in-training evaluation after epoch {epoch}: t2i R@1 {r1:.4f}"
            f" in {secs:.3f} s (f32 weights, bf16 compute)")
    for path, snap, write in saves:
        size = (f"{os.path.getsize(path) >> 20} MB" if os.path.exists(path)
                else "pruned since")
        log(f"  checkpoint {os.path.basename(path)}: snapshot {snap:.3f} s "
            f"on the training thread, write {write:.3f} s in the background "
            f"({size})")
    del state, meters
    torch.cuda.empty_cache()

    # test_net on best.pth: bf16 weights and compute, against the logged
    # R@1 of that epoch (f32 weights, bf16 compute)
    zero_counts()
    test_top1 = test_net.main(["--root", root, "--config-file",
                               yaml_of("straight"), "--checkpoint-file",
                               os.path.join(out, "best.pth"), "--device",
                               "cuda", "TPU.ALLOW_RANDOM_VOCAB", "True",
                               "DATALOADER.NUM_WORKERS", "8"])
    test_top1 = test_top1["cuhkpedes_test"]
    if abs(test_top1 - best["best_top1"]) > EVAL_GRID_TOL:
        fail(f"test_net on best.pth: t2i R@1 {test_top1}, the training log "
             f"{best['best_top1']} (tolerance {EVAL_GRID_TOL} points)")
    log(f"  test_net.main on best.pth (bf16 weights): t2i R@1 {test_top1:.4f}"
        f" against {best['best_top1']:.4f} logged in training (tolerance "
        f"{EVAL_GRID_TOL} points)")

    # one epoch, then --resume-from auto for the second, deterministic
    with GridCapture("PersonSearch") as logs, cudnn_deterministic():
        state, _ = run("halves", "SOLVER.NUM_EPOCHS", "1")
        del state
        torch.cuda.empty_cache()
        t0 = time.time()
        state, meters = run("halves", "--resume-from", "auto",
                            "SOLVER.NUM_EPOCHS", str(PROTOCOL_EPOCHS))
        torch.cuda.synchronize()
    started = [t for t, m in zip(logs.times, logs.messages)
               if m == "Start training"]
    restart_s = started[-1] - t0
    resumed = list(meters.loss.deque)
    if state.step != steps or len(resumed) != TRAIN_STEPS or any(
            abs(a - b) > RESUME_LOSS_RTOL * abs(b)
            for a, b in zip(resumed, straight_losses)):
        fail(f"resumed epoch losses {resumed} against the straight run's "
             f"{straight_losses} (rtol {RESUME_LOSS_RTOL})")
    log(f"  1 epoch + --resume-from auto: epoch-2 losses {resumed}, the "
        f"straight run's {straight_losses} (rtol {RESUME_LOSS_RTOL}; equal "
        f"bit for bit: {resumed == straight_losses}); restart (main() to "
        f"the first step: build, archive, resume) {restart_s:.2f} s")
    del state, meters
    torch.cuda.empty_cache()

    # a SIGTERM from the loader side on the second step of epoch 2
    calls = []
    moves = trainer.to_device

    def to_device(batch, device):
        calls.append(1)
        if len(calls) == TRAIN_STEPS + 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return moves(batch, device)

    with mock.patch.object(trainer, "to_device", to_device):
        state, _ = run("preempted", "SOLVER.NUM_EPOCHS",
                       str(PROTOCOL_EPOCHS))
    out = out_of("preempted")
    meta = read_meta(os.path.join(out, "preempt.pth"))
    if state.step != TRAIN_STEPS + 2 or meta["epoch"] != 1 or \
            meta["iteration"] != TRAIN_STEPS + 2:
        fail(f"preemption: {state.step} steps, preempt.pth meta {meta}")
    if auto_resume_path(out) != os.path.join(out, "preempt.pth"):
        fail(f"--resume-from auto would take {auto_resume_path(out)}")
    del state
    torch.cuda.empty_cache()
    state, meters = run("preempted", "--resume-from", "auto",
                        "SOLVER.NUM_EPOCHS", str(PROTOCOL_EPOCHS))
    finished = read_meta(os.path.join(out, f"epoch_{PROTOCOL_EPOCHS}.pth"))
    if state.step != 2 * TRAIN_STEPS + 2 or finished["epoch"] != \
            PROTOCOL_EPOCHS or not all(math.isfinite(v)
                                       for v in meters.loss.deque):
        fail(f"the resume from preempt.pth: {state.step} steps, "
             f"epoch_{PROTOCOL_EPOCHS}.pth meta {finished}")
    log(f"  SIGTERM on step {TRAIN_STEPS + 2} (epoch 2): preempt.pth with "
        f"epoch {meta['epoch']}, iteration {meta['iteration']}; "
        f"--resume-from auto took it and ran epoch 2 again to step "
        f"{state.step}")
    del state, meters
    torch.cuda.empty_cache()
    # the straight run's best.pth is kept for the tools' phase
    # (drive_tools), the rest deleted: ~6 GB of checkpoints
    kept_best = os.path.join(WORK, "tools", "best.pth")
    os.makedirs(os.path.dirname(kept_best), exist_ok=True)
    os.replace(os.path.join(out_of("straight"), "best.pth"), kept_best)
    shutil.rmtree(os.path.join(root, "output"))
    log(f"flagship as shipped: the phase took {time.time() - t_phase:.1f} s")
    return counts, {"eval_s": [e[2] for e in evals],
                    "snapshot_s": [s[1] for s in saves],
                    "write_s": [s[2] for s in saves], "restart_s": restart_s,
                    "top1": top1, "test_top1": test_top1, "root": root,
                    "yaml": yaml_of("straight"), "best": kept_best,
                    "opts": opts}


@contextmanager
def plain_train_kernels():
    """Route the ViT blocks' attention and the text tower's fused scan
    through their plain PyTorch versions (autograd through both)."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.models.vit as vit_model
    from textreid_torch.ops import attention, gru

    def plain_attention(qkv, heads, causal=False, scale=None):
        return attention.fused_attention_plain(qkv, heads, causal, scale)

    def plain_scan(xf, xb, w_f, w_b, lengths, pool_mode, batch_max=None):
        pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode,
                                      batch_max)

    with mock.patch.object(vit_model, "attention", plain_attention), \
            mock.patch.object(gru_model, "bigru_pooled_scan", plain_scan):
        yield


def train_setup(model_name, compute_dtype_name, f64=False):
    """Full-width train state of one of TRAIN_MODELS on the card and one
    device batch of its IMS_PER_BATCH (B / 4 identities x 4).  ``f64``:
    masters and towers in f64 (``--dp-f64``; the loss tail stays f32, as
    the step casts the embeddings)."""
    import torch
    from textreid_torch.engine import create_train_state, make_train_step
    from textreid_torch.models import build_model
    from textreid_torch.solver import make_optimizer, set_learning_rate
    from textreid_torch.utils.platform import compute_dtype

    cfg = yaml_cfg(TRAIN_MODELS[model_name][0])
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    cfg.TPU.COMPUTE_DTYPE = compute_dtype_name
    size = cfg.SOLVER.IMS_PER_BATCH
    if f64:
        model = build_model(cfg, "cuda", torch.float64, torch.float64,
                            train=True)
    else:
        model = build_model(cfg, "cuda", torch.float32,
                            compute_dtype(cfg, "cuda"), train=True)

    def state_of(m):
        opt = make_optimizer(cfg, m)
        set_learning_rate(opt, cfg.SOLVER.BASE_LR)
        return create_train_state(cfg, m, opt, size)

    rng = np.random.RandomState(11)
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    lengths = rng.randint(5, seq + 1, size).astype(np.int32)
    ids = np.zeros((size, seq), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(1, 512, n)
    erase = np.zeros((size, 5), np.int32)
    erase[::4] = [1, 100, 20, 80, 40]
    batch = {"pixels": rng.randint(0, 256, (size, 384, 128, 3), np.uint8),
             "erase": erase, "token_ids": ids, "lengths": lengths,
             "pids": np.repeat(np.arange(size // 4), 4)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    return cfg, model, state_of, make_train_step(cfg), batch


def compare_steps(model_name):
    """One f32 step with the kernels and one with their plain versions,
    from the same state and batch.  cuDNN is held to deterministic
    algorithms and full f32 (no TF32) for this comparison only, so that the
    two steps' convolutions compute the same sums and the steps differ by
    the kernels alone."""
    t0 = time.time()
    with cudnn_exact():
        out = _compare_steps(model_name)
    log(f"f32 step, {model_name}: phase {time.time() - t0:.1f} s")
    return out


@contextmanager
def cudnn_exact():
    import torch

    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark, flags.allow_tf32
    flags.deterministic, flags.benchmark, flags.allow_tf32 = True, False, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark, flags.allow_tf32 = saved


def _compare_steps(model_name):
    import copy

    import torch

    import textreid_torch.models.gru as gru_model
    from textreid_torch.ops import gru

    want_counts = TRAIN_MODELS[model_name][1]
    cfg, model, state_of, step, batch = train_setup(model_name, "float32")
    # the third takes the plain step again: how far two identical steps
    # land apart (a diagnostic, logged)
    states = [state_of(model), state_of(copy.deepcopy(model)),
              state_of(copy.deepcopy(model))]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    scan, query_gates = gru_model.bigru_pooled_scan, []

    def keep_query_gates(*args):  # the query tower's scan inputs
        if args[0].requires_grad:
            query_gates.append([t.detach().clone() for t in args[:5]])
        return scan(*args)

    zero_counts()
    with mock.patch.object(gru_model, "bigru_pooled_scan", keep_query_gates):
        got = step(states[0], batch)
    counts = read_counts(TRAIN_KERNELS)
    with plain_train_kernels():
        want = step(states[1], batch)
        step(states[2], batch)
    torch.cuda.synchronize()
    if counts != want_counts or read_counts(TRAIN_KERNELS) != counts:
        fail(f"f32 step, {model_name}: launches {counts}, then "
             f"{read_counts(TRAIN_KERNELS)}")
    # where the kernel's and the plain forward's f32 states cross at a
    # near-tie, the two steps' pool gradients go to different steps
    flips = 0
    for args in query_gates:  # none in a text transformer
        flips = int((gru.bigru_pooled_fwd_train(*args)[3]
                     != gru.bigru_pooled_fwd_train_plain(*args)[3]).sum())
        log(f"f32 step, {model_name}, text tower: the kernel's and the "
            f"plain forward's argmax differ at {flips} of "
            f"{args[4].numel() * 2 * args[2].shape[0]} (row, unit) maxima")
    loss_err = 0.0
    for name in want:
        a, b = float(got[name]), float(want[name])
        err = abs(a - b) / max(abs(b), 1e-12)
        loss_err = max(loss_err, err)
        log(f"f32 step, {model_name}, {name}: kernels {a:.6f}, plain "
            f"{b:.6f}")
        if not math.isfinite(a) or err > STEP_LOSS_RTOL:
            fail(f"f32 step, {model_name}, {name} differs by {err:.3e} (rtol "
                 f"{STEP_LOSS_RTOL:.0e})")
    decay = {id(p): g["weight_decay"]
             for g in states[1].optimizer.param_groups for p in g["params"]}
    worst, worst_name, masked, total, again = 0.0, "", 0, 0, 0.0
    grad_worst, grad_name, bad, zero = 0.0, "", [], []
    plain_params = dict(states[1].model.named_parameters())
    again_params = dict(states[2].model.named_parameters())
    top_norm = max(q.grad.norm().item() for q in plain_params.values())
    for name, p in states[0].model.named_parameters():
        q = plain_params[name]
        diff = p.grad - q.grad
        grad_err = 0.0
        if q.grad.norm().item() < NOISE_FLOOR * top_norm:
            zero.append(name)
        else:
            grad_err = (diff.norm() / q.grad.norm()).item()
        if grad_err > grad_worst:
            grad_worst, grad_name = grad_err, name
        if not math.isfinite(grad_err) or grad_err > STEP_UPDATE_RTOL:
            bad.append(f"{name} (gradient {grad_err:.3e})")
        g = (q.grad + decay[id(q)] * before[name]).abs()
        keep = g >= max(NOISE_FLOOR, 2 * diff.abs().max().item())
        masked += int((~keep).sum())
        total += keep.numel()
        d_p = (q.detach() - before[name])[keep]
        if d_p.numel() == 0:
            continue
        d_k = (p.detach() - before[name])[keep]
        err = ((d_k - d_p).norm() / d_p.norm().clamp_min(1e-30)).item()
        d_a = (again_params[name].detach() - before[name])[keep]
        again = max(again, ((d_a - d_p).norm()
                            / d_p.norm().clamp_min(1e-30)).item())
        if err > worst:
            worst, worst_name = err, name
        if not math.isfinite(err) or err > STEP_UPDATE_RTOL:
            bad.append(f"{name} (update {err:.3e})")
    log(f"f32 step, {model_name}, kernels vs plain: gradients within "
        f"{grad_worst:.3e} at {grad_name} ({', '.join(zero) or 'none'} "
        f"under 1e-6 of the largest gradient norm, left out); the plain "
        f"step taken twice: worst update error {again:.3e}")
    if bad:
        fail(f"f32 step, {model_name}: {'; '.join(bad[:8])} differ past "
             f"{STEP_UPDATE_RTOL:.0e} ({flips} argmax flips in the text "
             "tower)")
    log(f"f32 step, {model_name}, kernels vs plain: losses within "
        f"{loss_err:.3e} "
        f"(rtol {STEP_LOSS_RTOL:.0e}); worst update error {worst:.3e} at "
        f"{worst_name} (bound {STEP_UPDATE_RTOL:.0e}; {masked} of {total} "
        f"entries under the gradient floor, the larger of {NOISE_FLOOR:.0e} "
        "and twice the tensor's largest gradient difference, left out)")
    del states, model, before
    torch.cuda.empty_cache()
    return loss_err, worst, grad_worst


def device_profile(fn, calls, families, what):
    """Device time of ``fn`` by kernel family
    (``textreid_torch/utils/profiling.py:device_time_by_family``), logged:
    {family: ms a call}, with "other", "total" and "launches" (kernels a
    call).  None when the trace holds no device events."""
    from textreid_torch.utils.profiling import device_time_by_family

    out = device_time_by_family(fn, calls, families)
    if out is None:
        log(f"profile of {what}: the trace holds no device events")
        return None
    log(f"profile of {what} (torch.profiler, device time a call): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items()
                    if k != "launches")
        + f"; {out['launches']} kernels a call")
    return out


# the int8 ViT forward's: K8 (both its kernels) and K9 (both designs)
# before the library's products
INT8_VIT_FAMILIES = (("K8", ("matmul_requant",)),
                     ("K9", ("rows_kernel", "staged_kernel")),
                     ("K5", ("attention_fwd",)),
                     ("torch._int_mm", ("gemm", "cutlass", "cublas", "xmma",
                                        "nvjet", "wgmma", "imma")),
                     ("elementwise (decodes, residual adds, casts)",
                      ("elementwise",)))


def profile_steps(step, state, batch, steps=2, what="the bf16 train step",
                  meta=None):
    """Device time of ``steps`` train steps by kernel family, through
    ``textreid_torch/tools/profile_step.py``'s ``capture`` and
    ``summarize`` (``utils/profiling.py:STEP_FAMILIES`` by kernel name, the
    convolutions and products by the call that launched each kernel;
    ``meta``: the step's shapes, for the tool's roofline), logged:
    {family: ms a step} with "other", "total", "launches" (kernels a step)
    and "summary" (the tool's whole breakdown).  None when the trace holds
    no device events."""
    import contextlib
    import io

    import torch
    from textreid_torch.tools import profile_step

    out_dir = os.path.join(WORK, "step_profile")
    meta = {"device": torch.cuda.get_device_name(), **(meta or {})}
    profile_step.capture(lambda: step(state, batch), steps, out_dir, meta)
    with contextlib.redirect_stdout(io.StringIO()):  # logged below
        summary = profile_step.summarize(out_dir)
    if summary["ms_per_step"] <= 0.0:
        log(f"profile of {what}: the trace holds no device events")
        return None
    out = {**summary["by_family_ms"], "total": summary["ms_per_step"],
           "launches": round(summary["launches_per_step"]),
           "summary": summary}
    log(f"profile of {what} (torch.profiler, device time a step; "
        f"convolutions and products by launching call): "
        + ", ".join(f"{k} {v:.2f} ms"
                    for k, v in summary["by_family_ms"].items())
        + f", total {out['total']:.2f} ms; {out['launches']:.0f} kernels a "
        f"step")
    return out


def check_k1_bwd_family(profile, what, kernels=True):
    """A bf16 step launches K1's W-resident backward (``kernels``: with the
    kernels; else the plain versions, none) and never the streamed one,
    which only f32 runs.  Nothing to check without a device trace."""
    if profile is None:
        return
    if profile["K1 bwd streamed"] > 0 or (profile["K1 bwd"] > 0) != kernels:
        fail(f"{what}: K1's backward families {profile['K1 bwd']:.3f} ms "
             f"W-resident, {profile['K1 bwd streamed']:.3f} ms streamed")


def time_training(model_name, reps=8):
    """Median ms per bf16 step (kernels, then plain versions, then kernels
    again), peak memory, and the profile of the step's device time with
    the kernels and with the plain versions, for one of TRAIN_MODELS.  The
    flagship's step is the port's counterpart of the JAX package's
    ``moco_train_step_ms_bs128`` (``bench.py``), logged under that name."""
    import torch

    cfg, model, state_of, step, batch = train_setup(model_name, "bfloat16")
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
        plain_profile = profile_steps(step, state, batch)
    kernel += timed(reps)
    ms, plain_ms = float(np.median(kernel)), float(np.median(plain))
    profile = profile_steps(step, state, batch)
    check_k1_bwd_family(profile, f"the bf16 {model_name} step")
    check_k1_bwd_family(plain_profile, f"the bf16 {model_name} step with "
                        "the plain versions", kernels=False)

    metric = ("moco_train_step_ms_bs128: " if "flagship" in model_name
              else "")
    log(f"time train step bf16 B=128 ({model_name}, 384x128, T="
        f"{cfg.INPUT.MAX_TEXT_LENGTH}, K={cfg.MODEL.MOCO.K}): {metric}median "
        f"{ms:.2f} ms with the kernels "
        f"({len(kernel)} steps), {plain_ms:.2f} ms with the plain versions "
        f"({len(plain)} steps); device time a step "
        f"{profile['total'] if profile else float('nan'):.2f} ms in "
        f"{profile['launches'] if profile else -1} kernels (plain versions "
        f"{plain_profile['total'] if plain_profile else float('nan'):.2f} "
        f"ms in {plain_profile['launches'] if plain_profile else -1}); peak "
        f"memory {peak / 2**30:.2f} GiB ({card_line()})")
    del state, model
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, peak=peak, profile=profile,
                plain_profile=plain_profile)


def time_accum8(reps=3):
    """accum8's step (bs1024 in 8 microbatches of 128, the gradient-cache
    step) beside the single-pass bs128 flagship step, bf16: the peak device
    memory of a step of each with its state the only one on the card
    (gated: accum8's at most ACCUM8_PEAK_RATIO of the flagship's), the
    pass-1 against pass-2 embeddings of one microbatch (REPLAY_RTOL), then
    the step time in turns (flagship, accum8, accum8, flagship: medians)
    and the device time a step (``torch.profiler``)."""
    import gc

    import torch
    from textreid_torch.engine.grad_cache import split_micro
    from textreid_torch.engine.steps import query_forward
    from textreid_torch.models.common import running_stats_frozen

    t0 = time.time()
    flagship = "CLIP RN50 + bi-GRU (flagship)"

    def setup(name):
        cfg, model, state_of, step, batch = train_setup(name, "bfloat16")
        return cfg, (step, state_of(model), batch)

    def peak(step, state, batch):
        step(state, batch)  # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    def timed(step, state, batch, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1000)
        return out

    _, single = setup(flagship)
    single_peak = peak(*single)
    del single
    gc.collect()
    torch.cuda.empty_cache()
    cfg, accum = setup("accum8")
    accum_peak = peak(*accum)
    _, state, batch = accum
    micro = split_micro(batch, cfg.SOLVER.GRAD_ACCUM_STEPS)[0]
    with running_stats_frozen(state.model):
        with torch.no_grad():
            pass1 = query_forward(state.model, micro, False, False)
        pass2 = [e.detach() for e in query_forward(state.model, micro,
                                                   False, False)]
    replay = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(pass1, pass2))
    log(f"accum8, one microbatch of 128: pass 1 (no gradient, K1 "
        f"pooled-only) against pass 2 (K1's training forward): embeddings "
        f"within {replay:.3e} of their largest entry (tol {REPLAY_RTOL:.0e})")
    if not replay <= REPLAY_RTOL:
        fail(f"accum8: pass 1 and pass 2 embeddings differ by {replay:.3e}")
    del pass1, pass2

    _, single = setup(flagship)
    timed(*single, 2)
    single_ms = timed(*single, 8)
    accum_ms = timed(*accum, reps)
    accum_ms += timed(*accum, reps)
    single_ms += timed(*single, 8)
    accum_prof = profile_steps(*accum, steps=1, what="the bf16 accum8 step")
    single_prof = profile_steps(*single, what="the bf16 bs128 step")
    check_k1_bwd_family(accum_prof, "the bf16 accum8 step")
    check_k1_bwd_family(single_prof, "the bf16 bs128 step")
    out = dict(
        ms=float(np.median(accum_ms)), single_ms=float(np.median(single_ms)),
        peak=accum_peak, single_peak=single_peak,
        device=accum_prof["total"] if accum_prof else float("nan"),
        single_device=single_prof["total"] if single_prof else float("nan"),
        replay=replay)
    log(f"time train step bf16, accum8 (B=1024 in 8 x 128, CLIP RN50 + "
        f"bi-GRU, 384x128, K=2048) against the single-pass flagship "
        f"(B=128), in turns: median {out['ms']:.1f} ms "
        f"({', '.join(f'{v:.1f}' for v in accum_ms)}) against "
        f"{out['single_ms']:.2f} ms; device {out['device']:.1f} ms against "
        f"{out['single_device']:.2f} ms; peak memory "
        f"{accum_peak / 2**30:.2f} GiB against {single_peak / 2**30:.2f} "
        f"GiB ({accum_peak / single_peak:.3f}x; gate "
        f"{ACCUM8_PEAK_RATIO}x); phase {time.time() - t0:.1f} s "
        f"({card_line()})")
    if not accum_peak <= ACCUM8_PEAK_RATIO * single_peak:
        fail(f"accum8 peak memory {accum_peak / 2**30:.2f} GiB is over "
             f"{ACCUM8_PEAK_RATIO} x {single_peak / 2**30:.2f} GiB")
    del accum, single, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_k1_backward():
    """K1 at the train step's shape (B=128, T=105, H=512), bf16 and f32:
    the backward (the kernel with its dW product) against its plain version
    and against the plain recompute that was K1's backward before it
    (autograd through ``bigru_pooled_scan_plain``), interleaved; in bf16
    also the W-resident kernel against the streamed one it replaced
    (``tools/gru_variants.py:streamed_backward``), in turns, alone and with
    the dW product; the training forward against the pooled-only one; and
    how many of the backward's clusters the card holds at once.  Keys
    (what, dtype name); ("steps",) is the number of (row, step) pairs with
    t < len of the timed inputs."""
    import ctypes

    import torch
    from textreid_torch.ops import _build, gru
    from textreid_torch.tools.gru_variants import streamed_backward

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        args = k1_inputs(128, dtype, seed=4)
        leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        g = torch.randn(128, 1024, device="cuda").to(dtype)
        _, *saved = gru.bigru_pooled_fwd_train(*args)

        def kernel():
            gru.bigru_pooled_bwd(g, args[2], args[3], args[4], *saved)

        if dtype == torch.bfloat16:
            def streamed_with_dw():
                dhg = streamed_backward(g, args[2], args[3], args[4],
                                        *saved)[2]
                torch.bmm(saved[0].view(2, -1, 512).transpose(1, 2),
                          dhg.view(2, -1, 1536))

            (out[("bwd alone", name)],
             out[("streamed alone", name)]) = interleaved_ms(
                lambda: gru.launch_bigru_pooled_bwd(g, args[2], args[3],
                                                   args[4], *saved),
                lambda: streamed_backward(g, args[2], args[3], args[4],
                                          *saved), 10, 10)
            _, out[("streamed", name)] = interleaved_ms(
                kernel, streamed_with_dw, 10, 10)
            rows, n_clusters, capacity = k1_plan(128,
                                                 "bigru_resident_bwd_plan")
            log(f"time K1 backward B=128 T=105 H=512 {name}, in turns: "
                f"W-resident kernel alone {out[('bwd alone', name)]:.3f} ms, "
                f"the streamed kernel it replaced "
                f"{out[('streamed alone', name)]:.3f} ms; with the dW "
                f"product: the streamed kernel {out[('streamed', name)]:.3f} "
                f"ms; plan: {rows} rows a cluster of 16, {n_clusters} "
                f"clusters (the card holds {capacity[32]} of 32 rows, "
                f"{capacity[16]} of 16 at once)")

        def recompute():
            with torch.enable_grad():
                torch.autograd.grad(gru.bigru_pooled_scan_plain(
                    *leaves, args[4]), leaves, g)

        out[("bwd", name)], out[("bwd plain", name)] = interleaved_ms(
            kernel, lambda: gru.bigru_pooled_bwd_plain(
                g, args[2], args[3], args[4], *saved), 10, 3)
        _, out[("recompute", name)] = interleaved_ms(kernel, recompute, 10, 3)
        with torch.no_grad():
            out[("fwd", name)], out[("fwd train", name)] = interleaved_ms(
                lambda: gru.bigru_pooled_scan(*args),
                lambda: gru.bigru_pooled_fwd_train(*args), 10, 10)
        clusters = ctypes.c_int(0)
        _build.check(_build.library().bigru_pooled_bwd_clusters(
            128, 512, int(dtype == torch.bfloat16), ctypes.byref(clusters)),
            "bigru_pooled_bwd_clusters")
        log(f"time K1 B=128 T=105 H=512 {name}: backward "
            f"({gru.bwd_kernel(dtype)}, with its dW "
            f"product) {out[('bwd', name)]:.3f} ms, its plain version "
            f"{out[('bwd plain', name)]:.3f} ms, the plain recompute "
            f"(autograd through the plain scan) "
            f"{out[('recompute', name)]:.3f} ms; forward pooled-only "
            f"{out[('fwd', name)]:.3f} ms, training forward "
            f"{out[('fwd train', name)]:.3f} ms; the card holds "
            f"{clusters.value} of the streamed backward's 32 clusters at "
            f"once")
        out[("steps",)] = int(args[4].clamp(max=105).sum())
    return out


def time_attention():
    """K5 and K6 at the ViT-B/16 shape (bf16 and f32) and at the served
    causal CLIP-text shape (bf16), kernel and plain version interleaved,
    and the library call's time beside each bf16 pair.  Keys: (kernel,
    dtype or "library") for the ViT shape, (kernel, "text", ...) for the
    text shape."""
    import torch
    import torch.nn.functional as F
    from textreid_torch.ops import attention as A

    out = {}
    for shape, batch, seq, width, heads, causal in ATTN_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            if shape == "text" and dtype == torch.float32:
                continue  # no path runs the text tower's attention in f32
            qkv, g = attn_inputs(batch, seq, width, dtype, seed=1)
            dname = str(dtype).split(".")[1]
            times = {
                "K5": interleaved_ms(
                    lambda: A.fused_attention(qkv, heads, causal),
                    lambda: A.fused_attention_plain(qkv, heads, causal),
                    20, 5),
                "K6": interleaved_ms(
                    lambda: A.fused_attention_bwd(qkv, g, heads, causal),
                    lambda: A.fused_attention_bwd_plain(qkv, g, heads,
                                                        causal), 20, 5)}
            for k, (ms, plain_ms) in times.items():
                out[(k, dname) if shape == "vit" else (k, "text", dname)] = (
                    ms, plain_ms)
                log(f"time {k} B={batch} S={seq} W={width} H={heads} "
                    f"causal={causal} {dname}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms")

        # The library's yardstick, timed here and called nowhere in the
        # port: scaled_dot_product_attention on the split bf16 slab, and
        # autograd's backward of that call.
        qkv, g = attn_inputs(batch, seq, width, torch.bfloat16, seed=1)
        split = qkv.view(batch, seq, 3, heads, width // heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = (t.contiguous().requires_grad_(True) for t in split)
        g_heads = g.view(batch, seq, heads, -1).transpose(1, 2).contiguous()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), 20)
        y = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y, (q, k, v), g_heads, retain_graph=True), 20)
        out[("K5", "library") if shape == "vit" else
            ("K5", "text", "library")] = fwd_ms
        out[("K6", "library") if shape == "vit" else
            ("K6", "text", "library")] = bwd_ms
        log(f"time library yardstick bf16 B={batch} S={seq} {heads} heads x "
            f"{width // heads} causal={causal}: scaled_dot_product_attention "
            f"{fwd_ms:.3f} ms, its autograd backward {bwd_ms:.3f} ms")
    return out


# -- phase 13: data parallelism ----------------------------------------------

FLAGSHIP = "CLIP RN50 + bi-GRU (flagship)"
DP_RANKS = 2
DP_STEPS = 2
# BatchNorm running statistics of the 2-rank step against the one-process
# step, over the tensor's largest |entry|: the ranks' statistics are merged
# from their parts (Chan's rule) where one process sums all 128 rows at once
DP_STATS_RTOL = 1e-4
# the data-parallel steps' errors against one process (losses, queues,
# step 1's gradients and updates), over those of the one-process steps on
# the same rows in another order (see compare_dp_steps): rounding is not
# reproducible, only its size
DP_NOISE_RATIO = 4.0
# the queues' entries (L2-normalised f32 keys, ~0.06 at D = 256) after each
# step: step 1's keys come from the same key parameters through the
# trunk's 53 BatchNorms, whose statistics the ranks merge from their parts
# (rounding of ~1e-7 a layer); step 2's also from query parameters one
# update apart (entries whose gradient is in the noise step +-lr either
# way); measured on an H100, 2 ranks on one card: step 2 1.46e-5.  Floors
# of the bound, with the reversed-order yardstick
DP_QUEUE_ATOL = (1e-5, 1e-4)
DP_SEARCH_TOL = 1e-6    # sharded replies against unsharded, f32 scores
DP_GALLERY_ROWS = (3074, 98304)
DP_SHARDS = (2, 4)
DP_CARD_STEPS = 5  # steps a run of --dp-cards' torchrun comparison


def dp_rank(store, out_path, backend, dtype_name="float32"):
    """One rank of :func:`drive_dp_steps` (``python3 chip_smoke.py
    --dp-rank STORE OUT BACKEND``, with ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` set): the f32 flagship state broadcast from rank 0 (on
    ``cuda:0`` for every rank under gloo, as NCCL refuses two ranks on one
    card; on ``cuda:LOCAL_RANK`` under NCCL), ``DP_STEPS`` steps on this
    rank's rows of the 128-row batch, the ranks' states against each
    other; then rank 0,
    out of the group, takes the same steps in one process on all 128 rows
    from the same start, holds the two runs together
    (:func:`compare_dp_steps`) and writes what it found to ``out_path``.
    ``dtype_name`` "float64" (``--dp-f64``) runs both in f64 through the
    plain versions (K1 has no f64 kernel)."""
    from contextlib import nullcontext

    import torch
    import torch.distributed as dist
    from textreid_torch.parallel import mesh as dp

    dp.init_process_group("cuda:0" if backend == "gloo" else "cuda",
                          "file://" + store, backend=backend, timeout_s=300)
    rank, world = dp.rank(), dp.world_size()
    torch.manual_seed(0)
    f64 = dtype_name == "float64"
    with cudnn_exact(), (plain_train_kernels() if f64 else nullcontext()):
        cfg, model, state_of, step, batch = train_setup(FLAGSHIP, "float32",
                                                        f64)
        state = state_of(model)
        dp.replicate_state(state)
        start = state.state_dict()
        rows = batch["pids"].shape[0] // world
        mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        zero_counts()
        got = []
        t0 = time.time()
        for i in range(DP_STEPS):
            got.append(dp_record(state, step(state, mine), full=i == 0))
        torch.cuda.synchronize()
        step_s = (time.time() - t0) / DP_STEPS
        counts = read_counts(TRAIN_KERNELS)
        # every rank's state against rank 0's, on the card
        apart = torch.zeros(1, device="cuda")
        for t in [*state.model.state_dict().values(),
                  *state.key_model.state_dict().values(), state.v_queue,
                  state.t_queue, state.id_queue]:
            ref = t.detach().clone()
            dist.broadcast(ref, 0)
            apart = torch.maximum(apart, (t.detach().double() - ref.double())
                                  .abs().max().float().reshape(1))
        dist.all_reduce(apart, op=dist.ReduceOp.MAX)
        all_counts = dp.all_gather_object(counts)
        pointers = dp.all_gather_object(state.queue_ptr)
        dp.destroy_process_group()
        if rank != 0:
            return
        del state, model
        torch.cuda.empty_cache()
        cfg, model, state_of, step, _ = train_setup(FLAGSHIP, "float32", f64)
        ref = state_of(model)
        ref.load_state_dict(start)
        want = [dp_record(ref, step(ref, batch), full=i == 0)
                for i in range(DP_STEPS)]
        want_pointer = ref.queue_ptr
        # the yardstick: one process again from the same start, on the 128
        # rows in reverse order (the same function, other sums)
        ref.load_state_dict(start)
        flipped = {k: v.flip(0) for k, v in batch.items()}
        alt = [dp_record(ref, step(ref, flipped), full=i == 0)
               for i in range(DP_STEPS)]
    decay = {n: g["weight_decay"] for g in ref.optimizer.param_groups
             for n, p in ref.model.named_parameters()
             if any(p is q for q in g["params"])}
    summary = compare_dp_steps(got, want, alt, start["model"], decay)
    torch.save({"counts": all_counts, "apart": float(apart),
                "step_s": step_s, "pointers": pointers,
                "want_pointer": want_pointer, "summary": summary}, out_path)


def dp_record(state, metrics, full):
    """What :func:`compare_dp_steps` reads of a step, on the CPU: the
    losses, the BatchNorm statistics and the queues; with ``full`` also the
    model and its gradients."""
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "queues": {n: getattr(state, n).cpu() for n in
                      ("v_queue", "t_queue", "id_queue")},
           "stats": {(which, n): v.detach().cpu()
                     for which in ("model", "key_model")
                     for n, v in getattr(state, which).state_dict().items()
                     if n.endswith(("running_mean", "running_var"))}}
    if full:
        out["model"] = {n: p.detach().cpu()
                        for n, p in state.model.named_parameters()}
        out["grads"] = {n: p.grad.detach().cpu()
                        for n, p in state.model.named_parameters()}
    return out


def compare_dp_steps(got, want, alt, start, decay):
    """The data-parallel steps (``got``) against the one-process steps
    (``want``), each error bounded by the larger of a floor and
    DP_NOISE_RATIO times the error of ``alt``, the one-process steps on the
    rows in reverse order: the ranks compute the trunk's sums in another
    order too (each rank's rows, its BatchNorm statistics merged), and a
    deep trunk on batch statistics carries f32 rounding far into its stem's
    gradient, and from there into the next step.  Every step's losses
    (floor STEP_LOSS_RTOL) and queues (DP_QUEUE_ATOL), the ids equal; step
    1's BatchNorm statistics within DP_STATS_RTOL; step 1's gradients and
    updates by the rules of the f32 comparison (phase 9, floor
    STEP_UPDATE_RTOL).  Returns the worst errors."""
    import torch

    def unreversed(queues, steps):
        """``alt``'s queues with each step's enqueued rows put back in
        the batch's order (the queue starts empty at row 0)."""
        out = {}
        for name, q in queues.items():
            q = q.clone()
            for i in range(steps):
                block = slice(i * 128, (i + 1) * 128)
                q[block] = q[block].flip(0)
            out[name] = q
        return out

    worst = {"loss": 0.0, "alt_loss": 0.0, "stats": [0.0] * len(got),
             "queue": [0.0] * len(got), "alt_queue": [0.0] * len(got)}
    for i, (g, w, r) in enumerate(zip(got, want, alt)):
        for name, b in w["metrics"].items():
            a = g["metrics"][name]
            err = abs(a - b) / max(abs(b), 1e-12)
            yard = abs(r["metrics"][name] - b) / max(abs(b), 1e-12)
            worst["loss"] = max(worst["loss"], err)
            worst["alt_loss"] = max(worst["alt_loss"], yard)
            if not math.isfinite(a) or err > max(STEP_LOSS_RTOL,
                                                 DP_NOISE_RATIO * yard):
                fail(f"data-parallel step {i + 1}, {name}: ranks {a:.6f}, "
                     f"one process {b:.6f} ({err:.3e}; reversed order "
                     f"{yard:.3e})")
        for key, v in w["stats"].items():
            err = ((g["stats"][key] - v).abs().max()
                   / v.abs().max().clamp_min(1e-30)).item()
            worst["stats"][i] = max(worst["stats"][i], err)
            if i == 0 and err > DP_STATS_RTOL:
                fail(f"data-parallel step 1, {key}: {err:.3e}")
        r_queues = unreversed(r["queues"], i + 1)
        for name in ("v_queue", "t_queue"):
            err = (g["queues"][name] - w["queues"][name]).abs().max().item()
            yard = (r_queues[name] - w["queues"][name]).abs().max().item()
            worst["queue"][i] = max(worst["queue"][i], err)
            worst["alt_queue"][i] = max(worst["alt_queue"][i], yard)
            if err > max(DP_QUEUE_ATOL[i], DP_NOISE_RATIO * yard):
                fail(f"data-parallel step {i + 1}, {name}: {err:.3e} "
                     f"(reversed order {yard:.3e})")
        for q in (g["queues"], r_queues):
            if not torch.equal(q["id_queue"], w["queues"]["id_queue"]):
                fail(f"data-parallel step {i + 1}: id queues differ")

    def step_errors(run):
        """{tensor: (gradient error, update error)} of ``run``'s step 1
        against ``want``'s, by phase 9's rules."""
        w1, out = want[0], {}
        top = max(v.norm().item() for v in w1["grads"].values())
        for name, wg in w1["grads"].items():
            diff = run["grads"][name] - wg
            grad_err = ((diff.norm() / wg.norm()).item()
                        if wg.norm().item() >= NOISE_FLOOR * top else 0.0)
            keep = (wg + decay[name] * start[name]).abs() >= max(
                NOISE_FLOOR, 2 * diff.abs().max().item())
            d_w = (w1["model"][name] - start[name])[keep]
            d_r = (run["model"][name] - start[name])[keep]
            update_err = ((d_r - d_w).norm() / d_w.norm().clamp_min(1e-30)
                          ).item() if d_w.numel() else 0.0
            out[name] = (grad_err, update_err)
        return out

    dp_err, alt_err = step_errors(got[0]), step_errors(alt[0])
    ranked = sorted(dp_err, key=lambda n: -dp_err[n][0])
    log("data-parallel step 1, the tensors farthest from one process "
        "(gradient error, update error; the reversed-order one-process step "
        "in brackets): " + "; ".join(
            f"{n} {dp_err[n][0]:.2e}, {dp_err[n][1]:.2e} "
            f"[{alt_err[n][0]:.2e}, {alt_err[n][1]:.2e}]" for n in ranked[:8]))
    bad = []
    for name, errs in dp_err.items():
        for what, err, yard in zip(("gradient", "update"), errs,
                                   alt_err[name]):
            if not math.isfinite(err) or err > max(STEP_UPDATE_RTOL,
                                                   DP_NOISE_RATIO * yard):
                bad.append(f"{what} of {name} {err:.3e} (reversed order "
                           f"{yard:.3e})")
    if bad:
        fail(f"data-parallel step 1: {'; '.join(bad[:8])}")
    for k, col in (("grad", 0), ("update", 1)):
        worst[k] = max(v[col] for v in dp_err.values())
        worst["alt_" + k] = max(v[col] for v in alt_err.values())
    return worst


def drive_dp_steps(ranks=DP_RANKS, backend="gloo", dtype_name="float32"):
    """Part 1 of the phase: the flagship's f32 step on ``ranks`` ranks
    (gloo: all on the one card; NCCL: one a card), 128 / ``ranks`` rows
    each, against one process on the same 128 rows; returns the ranks'
    launches, summed, and the worst errors (:func:`compare_dp_steps`).
    ``dtype_name`` "float64": both in f64 through the plain versions, no
    launches (``--dp-f64``)."""
    import torch

    t0 = time.time()
    where = ("on the one card (gloo, CUDA tensors)" if backend == "gloo"
             else f"one a card ({backend})")
    work = os.path.join(WORK, "dp")
    os.makedirs(work, exist_ok=True)
    store, out = os.path.join(work, "store"), os.path.join(work, "steps.pt")
    for path in (store, out):
        if os.path.exists(path):
            os.remove(path)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", store, out,
         backend, dtype_name], cwd=REPO, env={
             **os.environ, "RANK": str(r), "WORLD_SIZE": str(ranks),
             "LOCAL_RANK": "0" if backend == "gloo" else str(r)})
        for r in range(ranks)]
    deadline = time.time() + 600
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if any(p.returncode != 0 for p in procs):
        fail(f"data-parallel step: ranks exited "
             f"{[p.returncode for p in procs]}")
    res = torch.load(out, weights_only=False)
    want_counts = {k: v * DP_STEPS * (dtype_name != "float64")
                   for k, v in TRAIN_MODELS[FLAGSHIP][1].items()}
    for rank, counts in enumerate(res["counts"]):
        if counts != want_counts:
            fail(f"data-parallel step: rank {rank} launched {counts}, not "
                 f"{want_counts} ({DP_STEPS} steps)")
    if res["apart"] != 0.0:
        fail(f"data-parallel step: the ranks' states differ by "
             f"{res['apart']:.3e}")
    if set(res["pointers"]) != {res["want_pointer"]}:
        fail(f"data-parallel step: queue pointers {res['pointers']}, one "
             f"process {res['want_pointer']}")
    w = res["summary"]
    log(f"data parallel, {ranks} ranks {where}, the flagship "
        f"{'f64 (plain versions)' if dtype_name == 'float64' else 'f32'} at "
        f"384x128, global batch 128 ({128 // ranks} a rank), "
        f"{DP_STEPS} steps against one process on the 128 rows: losses "
        f"within {w['loss']:.3e} (the one-process steps on the rows "
        f"reversed: {w['alt_loss']:.3e}; rtol {STEP_LOSS_RTOL:.0e}), step-1 "
        f"gradients within {w['grad']:.3e}, updates within "
        f"{w['update']:.3e} (the one-process step on the rows reversed: "
        f"{w['alt_grad']:.3e}, {w['alt_update']:.3e}; bound a tensor the "
        f"larger of {STEP_UPDATE_RTOL:.0e} and {DP_NOISE_RATIO:g}x its "
        f"reversed-order error); BatchNorm statistics after each step "
        f"within {', '.join(f'{v:.3e}' for v in w['stats'])} of the largest "
        f"(step 1 bound {DP_STATS_RTOL:.0e}); queues after each step within "
        f"{', '.join(f'{v:.3e}' for v in w['queue'])} (reversed order "
        f"{', '.join(f'{v:.3e}' for v in w['alt_queue'])}; floors "
        f"{', '.join(f'{v:.0e}' for v in DP_QUEUE_ATOL)}); the ranks' "
        f"states equal; launches a rank "
        f"{res['counts'][0]}; {res['step_s'] * 1e3:.0f} ms a {ranks}-rank "
        f"step; phase {time.time() - t0:.1f} s ({card_line()})")
    return {k: sum(c[k] for c in res["counts"]) for k in want_counts}, w


def drive_nccl_train_net():
    """Part 2: ``train_net.main`` on the flagship yaml under a one-rank
    NCCL group (``RANK=0``, ``WORLD_SIZE=1``, ``MASTER_ADDR`` and a free
    ``MASTER_PORT``), in turns with the same run outside a group; the bf16
    step times of both, one checkpoint each.  Returns the group runs'
    launches and the readings."""
    import shutil
    import socket

    import torch
    import torch.distributed as dist
    from textreid_torch import train_net
    from textreid_torch.parallel import mesh as dp

    t0 = time.time()
    data = training_split(128, TRAIN_STEPS)
    root = os.path.join(WORK, "train_nccl")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "datasets"))
    os.symlink(data, os.path.join(root, "datasets", "cuhkpedes"))
    out_dir = os.path.join(root, "output", "cuhkpedes", os.path.splitext(
        os.path.basename(FLAGSHIP_YAML))[0])
    argv = ["--root", root, "--config-file",
            os.path.join(REPO, FLAGSHIP_YAML), "SOLVER.EVALUATE_PERIOD", "0",
            "SOLVER.NUM_EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "SOLVER.LOG_PERIOD", "1", "TPU.ALLOW_RANDOM_VOCAB", "True",
            "DATALOADER.NUM_WORKERS", "8"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    readings, launched, backends = {"group": [], "plain": []}, {}, []
    init = dp.init_process_group

    def watched_init(*args, **kwargs):
        device = init(*args, **kwargs)
        backends.append((dist.get_backend(), dist.get_world_size(), device))
        return device

    want = {k: v * TRAIN_STEPS for k, v in TRAIN_MODELS[FLAGSHIP][1].items()}
    for turn in ("group", "plain", "group", "plain"):
        env = group_env if turn == "group" else {}
        saved = {k: os.environ.pop(k, None) for k in group_env}
        os.environ.update(env)
        try:
            zero_counts()
            with mock.patch.object(dp, "init_process_group", watched_init):
                state, meters = train_net.main(argv)
            torch.cuda.synchronize()
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        counts = read_counts(TRAIN_KERNELS)
        if counts != want or state.step != TRAIN_STEPS:
            fail(f"train_net ({turn}): {state.step} steps, launches {counts}")
        if dist.is_initialized():
            fail("train_net left its process group standing")
        files = sorted(f for f in os.listdir(out_dir) if f != "log.txt")
        if files != ["epoch_1.pth"]:
            fail(f"train_net ({turn}) wrote {files}, not one checkpoint")
        # a step's time without its wait on the loader
        readings[turn] += [(t - d) * 1e3 for t, d in zip(
            list(meters.time.deque)[1:], list(meters.data.deque)[1:])]
        launched = counts
        shutil.rmtree(os.path.join(root, "output"))
        del state, meters
        torch.cuda.empty_cache()
    if [b[:2] for b in backends] != [("nccl", 1)] * 2:
        fail(f"train_net under the group environment formed {backends}")
    log(f"data parallel, train_net on the flagship yaml (bf16, batch 128, "
        f"{TRAIN_STEPS} steps a run) under a one-rank NCCL group on "
        f"{backends[0][2]}, in turns with the same run outside a group: "
        f"step ms without the wait on the loader (after the first) in the "
        f"group "
        f"{', '.join(f'{v:.2f}' for v in readings['group'])}, outside "
        f"{', '.join(f'{v:.2f}' for v in readings['plain'])}; median "
        f"{np.median(readings['group']):.2f} against "
        f"{np.median(readings['plain']):.2f} ms; one checkpoint a run; "
        f"phase {time.time() - t0:.1f} s ({card_line()})")
    return launched, readings


def drive_sharded_gallery():
    """Part 3: ``RetrievalIndex(mesh=)`` over ``[cuda:0] x 2`` and ``x 4``
    at 3,074 rows (4 does not divide it: the augmented pad rows) and
    98,304, float and int8, served over HTTP beside the unsharded index:
    the replies equal (scores within DP_SEARCH_TOL, rows equal outside
    ties), K2 / K4 once a shard a search, and /search p50 of each.
    Returns the launches and the p50s."""
    import torch
    from textreid_torch.config import flagship_cfg
    from textreid_torch.parallel import make_mesh
    from textreid_torch.server import RetrievalService, make_server
    from textreid_torch.serving import RetrievalIndex
    from textreid_torch.utils.bootstrap import build_eval_model

    t0 = time.time()
    work = os.path.join(WORK, "dp")
    os.makedirs(work, exist_ok=True)
    files = {}
    for rows in DP_GALLERY_ROWS:
        files[rows] = f"unit_{rows}.idx"
        write_unit_index(os.path.join(work, files[rows]), rows)
    cfg = flagship_cfg("")
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    model = build_eval_model(cfg, "", "cuda", torch.bfloat16)
    rng = np.random.RandomState(21)
    queries = []
    for n, k in ((1, 10), (3, 5), (16, 10), (1, 64)):
        lens = rng.randint(1, 106, n).astype(np.int32)
        ids = np.zeros((n, 105), np.int32)
        for i, ln in enumerate(lens):
            ids[i, :ln] = rng.randint(1, 512, ln)
        queries.append({"token_ids": ids.tolist(), "lengths": lens.tolist(),
                        "k": k})
    replies, p50, launched = {}, {}, {}
    cuda0 = torch.device("cuda", 0)
    for quantize in (False, True):
        kernel = "topk_similarity_int8" if quantize else "topk_similarity_f32"
        for shards in (None,) + DP_SHARDS:
            mesh = (None if shards is None
                    else make_mesh(shards, devices=[cuda0] * shards))
            service = RetrievalService(RetrievalIndex(model, mesh=mesh,
                                                      quantize=quantize),
                                       max_text_length=105, reload_dir=work,
                                       k_buckets=(5, 10, 64))
            server = make_server(service, port=0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            base = "http://127.0.0.1:%d" % server.server_address[1]
            try:
                for rows in DP_GALLERY_ROWS:
                    key = (quantize, shards, rows)
                    p50[key] = search_latency(service, base, files[rows],
                                              rows)
                    zero_counts()
                    replies[key] = [post(base + "/search", q)
                                    for q in queries]
                    counts = read_counts((kernel, "bigru_pooled_fwd"))
                    want = {kernel: len(queries) * (shards or 1),
                            "bigru_pooled_fwd": len(queries)}
                    if counts != want:
                        fail(f"sharded gallery {key}: launches {counts}, "
                             f"not {want}")
                    if shards is not None:
                        for name, n in counts.items():
                            launched[name] = launched.get(name, 0) + n
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
    worst, ties = 0.0, 0
    for (quantize, shards, rows), got in replies.items():
        if shards is None:
            continue
        for a, b in zip(got, replies[(quantize, None, rows)]):
            sa, sb = np.asarray(a["scores"]), np.asarray(b["scores"])
            ma, mb = np.asarray(a["meta"]), np.asarray(b["meta"])
            if sa.shape != sb.shape or not np.isfinite(sa).all():
                fail(f"sharded gallery {quantize, shards, rows}: scores "
                     f"{sa.shape}, unsharded {sb.shape}")
            worst = max(worst, float(np.abs(sa - sb).max()))
            for r, c in zip(*np.nonzero(ma != mb)):
                # a swap within a tie: the unsharded score of the sharded
                # reply's row equals its score there
                row = np.nonzero(mb[r] == ma[r, c])[0]
                if row.size == 0 or abs(sb[r, row[0]] - sa[r, c]) > \
                        DP_SEARCH_TOL:
                    fail(f"sharded gallery {quantize, shards, rows}: query "
                         f"{r} slot {c} row {ma[r, c]} against {mb[r, c]}")
                ties += 1
    if worst > DP_SEARCH_TOL:
        fail(f"sharded gallery: scores differ from the unsharded index's by "
             f"{worst:.3e}")
    log(f"data parallel, sharded gallery (RetrievalIndex(mesh=) over "
        f"cuda:0 x 2 and x 4, 256-d unit rows, the flagship's text tower): "
        f"replies equal to the unsharded index's (scores within "
        f"{worst:.2e}, {ties} slots swapped within a tie); K2 / K4 once a "
        f"shard a search; /search p50 (1 query, k=10) " + "; ".join(
            f"{'int8' if q else 'float'} {rows} rows: unsharded "
            f"{p50[(q, None, rows)]:.3f} ms, 2 shards "
            f"{p50[(q, 2, rows)]:.3f}, 4 shards {p50[(q, 4, rows)]:.3f}"
            for q in (False, True) for rows in DP_GALLERY_ROWS)
        + f"; phase {time.time() - t0:.1f} s ({card_line()})")
    del model
    torch.cuda.empty_cache()
    return launched, p50


def drive_dp_cards():
    """A development aid, ``python3 chip_smoke.py --dp-cards`` on a machine
    with two cards or more (prints no result line): (a) the flagship's f32
    step on every card, one NCCL rank a card, against one process on the
    same 128 rows (:func:`drive_dp_steps`' gates); (b) ``torchrun
    --standalone --nproc-per-node N -m textreid_torch.train_net`` on the
    flagship yaml at 128 rows a rank (global batch 128 N), DP_CARD_STEPS
    steps a run, in turns with one process at 128 rows on one card: the
    bf16 step's ms without the wait on the loader (from ``log.txt``) and
    the images a second."""
    import re
    import shutil

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--dp-cards needs two cards or more, found {n}")
    drive_dp_steps(n, "nccl")
    t0 = time.time()
    data = training_split(128 * n, DP_CARD_STEPS)
    step = re.compile(r"epoch \[1\]\[(\d+)/\d+\].*time: ([\d.]+) \([\d.]+\)"
                      r"\s+data: ([\d.]+)")
    readings = {n: [], 1: []}
    for ranks in (n, 1, n, 1):
        root = os.path.join(WORK, f"train_cards{ranks}")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(os.path.join(root, "datasets"))
        os.symlink(data, os.path.join(root, "datasets", "cuhkpedes"))
        argv = ["-m", "textreid_torch.train_net", "--root", root,
                "--config-file", os.path.join(REPO, FLAGSHIP_YAML),
                "SOLVER.IMS_PER_BATCH", str(128 * ranks),
                "SOLVER.EVALUATE_PERIOD", "0", "SOLVER.NUM_EPOCHS", "1",
                "SOLVER.CHECKPOINT_PERIOD", "0", "SOLVER.LOG_PERIOD", "1",
                "TPU.ALLOW_RANDOM_VOCAB", "True",
                "DATALOADER.NUM_WORKERS", "8"]
        if ranks > 1:
            argv = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(ranks)] + argv
        out = subprocess.run([sys.executable] + argv, cwd=REPO,
                             capture_output=True, text=True, timeout=900)
        log_path = os.path.join(root, "output", "cuhkpedes", os.path.splitext(
            os.path.basename(FLAGSHIP_YAML))[0], "log.txt")
        if out.returncode != 0 or not os.path.isfile(log_path):
            log(out.stdout[-5000:])
            log(out.stderr[-30000:])
            fail(f"train_net on {ranks} card(s): rc {out.returncode}")
        with open(log_path) as f:
            text = f.read()
        if ranks > 1 and f"Data parallel over {ranks} ranks" not in text:
            fail(f"train_net under torchrun did not train on {ranks} ranks")
        found = [(int(i), float(t), float(d))
                 for i, t, d in step.findall(text)]
        # the first two steps of a run warm up (cuDNN's and the kernels'
        # first calls at their shapes): 1.2-2.0 s on the card
        readings[ranks] += [(t - d) * 1e3 for i, t, d in found if i > 1]
    for ranks, ms in readings.items():
        log(f"data parallel across cards, train_net on the flagship yaml "
            f"(bf16, 128 rows a rank, {ranks} card(s)): step ms without the "
            f"wait on the loader (after the first two) "
            f"{', '.join(f'{v:.2f}' for v in ms)}; median "
            f"{np.median(ms):.2f} ms, {128 * ranks / np.median(ms) * 1e3:.0f} "
            f"images a second")
    log(f"data parallel across cards: {n} cards at 128 rows each "
        f"{128 * n / np.median(readings[n]) * 1e3:.0f} images a second "
        f"against one card's {128 / np.median(readings[1]) * 1e3:.0f} "
        f"({np.median(readings[1]) / np.median(readings[n]) * n:.2f}x); "
        f"phase {time.time() - t0:.1f} s ({card_line()})")


def drive_data_parallel():
    """Phase 13 (see the module's docstring): the three parts; returns
    their launches, each part's apart, and the /search and step readings."""
    steps, _ = drive_dp_steps()
    nccl, step_ms = drive_nccl_train_net()
    gallery, p50 = drive_sharded_gallery()
    return {"dp steps": steps, "train_net nccl": nccl,
            "sharded gallery": gallery}, step_ms, p50


# -- phase 14: the tools and the quickstart ---------------------------------

# the device time of the flagship step from tools/profile_step.py's command
# line against profile_steps' reading, in this process, of the same step
# (profile_step.build_step: config/flagship.py's config and batch, the same
# seed), in the same call: the same kernels (cuDNN picks by heuristics,
# benchmark mode off), so they differ by the card's run-to-run spread
PROFILE_TOOL_RTOL = 0.02
TOOLS_LOADER_WORKERS = (4, 8)  # DATALOADER.NUM_WORKERS: the default, phase 8's
# the loader's split: 1,024 identities x 4 JPEGs, 32 batches of 128 an epoch
TOOLS_LOADER_IDS = 1024


def parity_rc(args):
    """``tools.parity_eval.main(args)``'s exit code (0 when it returns)
    and its results."""
    from textreid_torch.tools import parity_eval

    try:
        return 0, parity_eval.main(args)
    except SystemExit as exc:
        return exc.code, None


def check_export(protocol, exported):
    """The exported ``.pth`` installed into a fresh state (another seed)
    by ``install_reference_checkpoint`` against ``best.pth`` restored
    whole: the query model, the key model's towers, the queues and the
    pointer, bit for bit (BatchNorm's ``num_batches_tracked``, written as
    zeros as the JAX exporter writes it, and the frozen token table, no
    reference weight, aside).  Returns the tensors compared."""
    import torch
    from textreid_torch.utils.bootstrap import (
        build_train_state,
        install_checkpoint,
        install_reference_checkpoint,
        read_reference_checkpoint,
    )
    from textreid_torch.utils.weight_convert import FROZEN_TABLE_KEY

    cfg = yaml_cfg(FLAGSHIP_YAML)
    cfg.merge_from_list(protocol["opts"])
    source = build_train_state(cfg, "cuda")
    install_checkpoint(source, protocol["best"])
    cfg.SEED += 1
    fresh = build_train_state(cfg, "cuda")
    install_reference_checkpoint(fresh, read_reference_checkpoint(exported))
    n, bad = 0, []
    for which, towers_only in (("model", False), ("key_model", True)):
        want = getattr(source, which).state_dict()
        got = getattr(fresh, which).state_dict()
        for key, value in want.items():
            if key.endswith("num_batches_tracked") or key == \
                    FROZEN_TABLE_KEY or (towers_only and not key.startswith(
                        ("visual_model.", "textual_model."))):
                continue
            n += 1
            if not torch.equal(got[key], value):
                bad.append(f"{which}.{key}")
    for name in ("v_queue", "t_queue", "id_queue"):
        n += 1
        if not torch.equal(getattr(fresh, name), getattr(source, name)):
            bad.append(name)
    if bad or fresh.queue_ptr != source.queue_ptr:
        fail(f"the exported best.pth did not reinstall bit for bit: {bad[:8]}"
             f", pointer {fresh.queue_ptr} against {source.queue_ptr}")
    return n


def drive_tools(protocol, flagship_step):
    """Phase 14: the port's tools and its quickstart through their entry
    points on the card.  ``tools.export_torch`` on phase 8's ``best.pth``
    (the export reinstalled bit for bit, :func:`check_export`);
    ``tools.parity_eval`` on it against ``test_net``'s numbers (rc 0, the
    npz replayed by ``test_net --load-result``) and against them moved by
    twice the budget (rc 1); ``tools.bench_loader`` at 384x128 against the
    flagship step time of phase 10; ``tools.int8_ffn_ab``; the quickstart
    on ``cuda`` (its launches counted); last ``tools.profile_step`` on the
    flagship against :func:`profile_steps` on the same step built in this
    process (``flagship_step``: phase 10's reading, whose step time sets
    the loader's demand).  Returns (the quickstart's launches, what to
    summarise)."""
    import shutil

    import torch
    from textreid_torch import quickstart, test_net
    from textreid_torch.tools import (
        bench_loader,
        export_torch,
        int8_ffn_ab,
        profile_step,
    )

    t0 = time.time()
    work = os.path.join(WORK, "tools")
    root, yaml, best = protocol["root"], protocol["yaml"], protocol["best"]
    opts = protocol["opts"]
    out = {}

    # export, and the file back into a fresh state
    exported = os.path.join(work, "exported.pth")
    sd = export_torch.main(["--root", root, "--config-file", yaml,
                            "--checkpoint-file", best, "--output", exported,
                            "--device", "cuda", *opts])
    out["export_tensors"] = len(sd)
    out["export_checked"] = check_export(protocol, exported)
    del sd
    torch.cuda.empty_cache()
    log(f"tools.export_torch on best.pth: {out['export_tensors']} tensors "
        f"(reference layout, {os.path.getsize(exported) >> 20} MB), "
        f"reinstalled by install_reference_checkpoint bit for bit "
        f"({out['export_checked']} tensors: query model, key towers, "
        f"queues; the pointer)")

    # the parity gate against test_net's numbers (both f32: the gate builds
    # its model in f32)
    f32 = ["TPU.COMPUTE_DTYPE", "float32"]
    with GridCapture() as cap:
        test_net.main(["--root", root, "--config-file", yaml,
                       "--checkpoint-file", best, "--device", "cuda",
                       *opts, *f32])
    want = cap.grid()["t2i"]
    common = ["--root", root, "--config-file", yaml, "--checkpoint-file",
              best, "--device", "cuda"]
    folder = os.path.join(work, "parity")
    rc, results = parity_rc(common + [
        "--expected", ",".join(f"{v:.2f}" for v in want),
        "--output-folder", folder, *opts])
    if rc != 0:
        fail(f"parity_eval at test_net's numbers {want}: rc {rc}")
    from textreid_torch.tools.parity_eval import t2i_row

    got = t2i_row(results)
    moved = [v + 0.4 for v in want]  # twice the default budget of 0.2
    rc_off, _ = parity_rc(common + [
        "--expected", ",".join(f"{v:.2f}" for v in moved), *opts])
    if rc_off != 1:
        fail(f"parity_eval at {moved}, twice the budget off: rc {rc_off}")
    cache = os.path.join(root, "output", "straight", "flagship",
                         "inference", "cuhkpedes_test")
    os.makedirs(cache, exist_ok=True)
    shutil.copy(os.path.join(folder, "inference_data.npz"), cache)
    with GridCapture() as cap:
        test_net.main(["--root", root, "--config-file", yaml,
                       "--checkpoint-file", best, "--device", "cuda",
                       "--load-result", *opts])
    replayed = cap.grid()["t2i"]
    if max(abs(a - b) for a, b in zip(replayed, got)) > 0.005:
        fail(f"test_net --load-result on parity_eval's npz: {replayed}, "
             f"the gate's {got}")
    shutil.rmtree(os.path.join(root, "output"))
    out["parity"] = (want, got)
    log(f"tools.parity_eval on best.pth (f32, 256 pairs): t2i R1, R5, R10, "
        f"mAP {', '.join(f'{v:.4f}' for v in got)} against test_net's "
        f"{', '.join(f'{v:.2f}' for v in want)}: rc 0; at "
        f"{', '.join(f'{v:.2f}' for v in moved)}: rc {rc_off}; its npz "
        f"replayed by test_net --load-result to the same t2i row")

    # the loader against the step's demand
    out["loader"] = {}
    for workers in TOOLS_LOADER_WORKERS:
        res = bench_loader.main([
            "--ids", str(TOOLS_LOADER_IDS), "--imgs-per-id", "4", "--batch",
            "128", "--epochs", "2", "--num-workers", str(workers),
            "--step-ms", str(flagship_step["ms"]), "--output",
            os.path.join(work, f"loader_{workers}.json"), "--device",
            "cuda"])
        out["loader"][workers] = res
        log(f"tools.bench_loader, {res['n_images']} JPEGs of 300x100 to "
            f"384x128, batch 128 ({res['batches_per_epoch']} an epoch), "
            f"{workers} threads, {res['host_cpus']} host cores: img/s by "
            f"epoch after the first batch "
            f"{', '.join(f'{v:.1f}' for v in res['ours_steady_imgs_per_s_by_epoch'])}"
            f" (whole epoch "
            f"{', '.join(f'{v:.1f}' for v in res['ours_imgs_per_s_by_epoch'])}"
            f"; first batch after "
            f"{', '.join(f'{v:.2f}' for v in res['first_batch_s_by_epoch'])}"
            f" s); decoded-image cache, after the first batch "
            f"{', '.join(f'{v:.1f}' for v in res['ours_cached_steady_imgs_per_s_by_epoch'])}"
            f"; the flagship step's demand {res['demand_imgs_per_s']:.1f} "
            f"img/s (128 images in {flagship_step['ms']:.2f} ms, phase 10): "
            f"cold {res['cold_over_demand']:.2f}x of it")

    # K7 at the encode level
    ab = int8_ffn_ab.main(["--iters", "10", "--output",
                           os.path.join(work, "int8_ffn_ab.json")])
    out["int8_ffn_ab"] = ab
    for tower in ("vit", "text"):
        if not ab[f"{tower}_ffn_min_cosine"] >= INT8_COSINE_BAR:
            fail(f"int8_ffn_ab: {tower} fused_ffn on against off, minimum "
                 f"cosine {ab[f'{tower}_ffn_min_cosine']}")
    log(f"tools.int8_ffn_ab (B=128; ViT-B/16 384x128, CLIP text T=105; "
        f"bf16, 10 forwards a timing, two rounds): ViT int8 fused_ffn off "
        f"{ab['vit_off_ms']:.2f} ms, on (K7) {ab['vit_on_ms']:.2f} ms "
        f"(float {ab['vit_float_ms']:.2f}), minimum cosine "
        f"{ab['vit_ffn_min_cosine']:.5f}; text on (K7) {ab['text_on_ms']:.2f}"
        f" ms, off {ab['text_off_ms']:.2f} ms (float "
        f"{ab['text_float_ms']:.2f}), minimum cosine "
        f"{ab['text_ffn_min_cosine']:.5f}")
    torch.cuda.empty_cache()

    # the quickstart on the card, its launches counted
    qs_root = os.path.join(work, "quickstart")
    shutil.rmtree(qs_root, ignore_errors=True)
    zero_counts()
    qs = quickstart.main(["--device", "cuda", "--root", qs_root])
    torch.cuda.synchronize()
    counts = read_counts(("bigru_pooled_fwd", "bigru_pooled_bwd",
                          "topk_similarity_f32"))
    if (counts["bigru_pooled_bwd"] != qs["steps"]
            or counts["bigru_pooled_fwd"] < 2 * qs["steps"] + 2
            or counts["topk_similarity_f32"] < 2
            or qs["http_meta"] != qs["matches"]):
        fail(f"the quickstart on the card: {qs['steps']} steps, launches "
             f"{counts}, matches {qs['matches']} / {qs['http_meta']}")
    out["quickstart"] = (qs, counts)
    log(f"python -m textreid_torch.quickstart on cuda (ResNet-18 + bi-GRU "
        f"H=32, MoCo K=16, D=32, bf16): {qs['steps']} steps over 2 epochs, "
        f"t2i R@1 {qs['top1']:.2f}; launches {counts}; /search over HTTP "
        f"equal to index.search: {qs['matches']}")

    # last: the step profile (torch.profiler), the tool's command line
    # against profile_steps on the same step built in this process
    step, state, batch, meta = profile_step.build_step("", False, "cuda")
    step(state, batch)  # the warm-up step, as the tool's
    ref = profile_steps(step, state, batch, meta=meta,
                        what="the tool's flagship step, in process")
    del step, state, batch
    torch.cuda.empty_cache()
    if ref is None:
        fail("profile_steps on the tool's flagship step: the trace holds no "
             "device events")
    prof = profile_step.main(["--steps", "2", "--out",
                              os.path.join(work, "profile"), "--json-out",
                              os.path.join(work, "profile_step.json")])
    fam = prof["by_family_ms"]
    if not all(fam[k] > 0 for k in ("K1 fwd", "K1 bwd", "convolutions",
                                    "matrix products")):
        fail("profile_step: families " + ", ".join(
            f"{k} {fam[k]:.3f} ms" for k in ("K1 fwd", "K1 bwd",
                                             "convolutions",
                                             "matrix products")))
    if fam["K1 bwd streamed"] > 0 or any(
            "bigru_pooled_bwd_kernel" in k["name"]
            for k in prof["top_kernels"]):
        fail("profile_step: a bf16 step ran the streamed K1 backward")
    apart = abs(prof["ms_per_step"] - ref["total"]) / ref["total"]
    if not apart <= PROFILE_TOOL_RTOL:
        fail(f"profile_step: {prof['ms_per_step']:.2f} ms a step on the "
             f"device, profile_steps on the same step {ref['total']:.2f} ms "
             f"({apart:.3f}; rtol {PROFILE_TOOL_RTOL})")
    out["profile"], out["profile_ref"] = prof, ref
    roof = {k: v for k, v in prof["roofline"].items()
            if v["share"] is not None}
    log(f"tools.profile_step --steps 2 (the flagship, bf16, B=128): device "
        f"{prof['ms_per_step']:.2f} ms a step in "
        f"{prof['launches_per_step']:.0f} kernels, by family "
        + ", ".join(f"{k} {v:.2f}" for k, v in fam.items())
        + f" ms; profile_steps on the same step {ref['total']:.2f} ms "
        f"({apart * 100:.2f}% apart; rtol {PROFILE_TOOL_RTOL}); phase 10's "
        f"step (train_setup's batch) "
        + (f"{flagship_step['profile']['total']:.2f} ms"
           if flagship_step["profile"] else "not profiled")
        + "; roofline (bound of measured) " + ", ".join(
            f"{k} {v['bound_ms']:.3f} of {v['measured_ms']:.2f} ms "
            f"({v['share'] * 100:.1f}%)" for k, v in roof.items())
        + "; longest kernels " + "; ".join(
            f"{k['name'][:60]} {k['ms']:.2f} ms x{k['calls']:.0f}"
            for k in prof["top_kernels"][:5]))
    out["seconds"] = time.time() - t0
    log(f"the tools' phase took {out['seconds']:.1f} s")
    return counts, out


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

    if sys.argv[1:2] == ["--dp-rank"]:
        # a rank of phase 13's 2-rank step, started by drive_dp_steps
        _build.library()
        dp_rank(*sys.argv[2:6])
        return
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

    if sys.argv[1:] == ["--int8-kernels"]:
        # a development aid: K7-K9 against their plain versions and their
        # times alone (about 25 s); prints no result line
        check_k9(), check_k8(), check_k7()
        time_int8_kernels()
        return
    if sys.argv[1:] == ["--gru-kernels"]:
        # a development aid: K1 (pooled-only and training forward, backward)
        # and K3 against their plain versions, then their times alone
        # (about 60 s); prints no result line
        check_k1(), check_k3(), check_k1_grad()
        time_kernels()
        time_k1_backward()
        return
    if sys.argv[1:] == ["--dp-cards"]:
        # a development aid: data parallelism across the machine's cards
        # (NCCL), prints no result line
        drive_dp_cards()
        return
    if sys.argv[1:] == ["--dp-f64"]:
        # a development aid: phase 13's 2-rank step against one process in
        # f32 (the kernels), then in f64 (the plain versions), one call;
        # prints no result line
        runs = {name: drive_dp_steps(dtype_name=name)[1]
                for name in ("float32", "float64")}
        log("data-parallel step against one process, f32 / f64: " + "; ".join(
            f"{what} {runs['float32'][key]:.3e} / {runs['float64'][key]:.3e}"
            f" (reversed order {runs['float32']['alt_' + key]:.3e} / "
            f"{runs['float64']['alt_' + key]:.3e})"
            for what, key in (("losses", "loss"), ("step-1 gradients",
                                                   "grad"),
                              ("updates", "update")))
            + f"; queues after each step f32 "
            f"{', '.join(f'{v:.3e}' for v in runs['float32']['queue'])}, "
            f"f64 {', '.join(f'{v:.3e}' for v in runs['float64']['queue'])}"
            f" ({card_line()})")
        return
    if sys.argv[1:] == ["--dp"]:
        # a development aid: phase 13 alone (about 90 s); prints no result
        # line
        drive_data_parallel()
        return
    if sys.argv[1:] == ["--attention-kernels"]:
        # a development aid: K5 and K6 against their plain versions and
        # their times alone (about 40 s); prints no result line
        check_attention()
        time_attention()
        return
    k1_err = check_k1()
    check_topk_plans()
    k2_err = check_k2()
    k3_err = check_k3()
    k4_err = check_k4()
    width_err = check_topk_widths()
    attn_err = check_attention()
    k1_bwd_err = check_k1_grad()
    k9_err, k8_err, k7_err = check_k9(), check_k8(), check_k7()

    service, server, thread, base, text, images, counts, _ = drive_slice()
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
     int8_counts, _) = drive_slice(quantized=True, workspace=workspace)
    try:
        check_slice(service, text, images, int8_counts)
        int8_times = time_int8_serving(service, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    del service
    torch.cuda.empty_cache()

    (service, server, thread, base, built, enc_counts,
     cosines) = drive_int8_encoders()
    try:
        int8_kernel_times = time_int8_kernels()
        enc_times, vit_forward = time_int8_encoders(service, base, built)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    del service, built
    vit_forward = to_device(vit_forward, "cpu")  # kept for the profile
    torch.cuda.empty_cache()

    trunk_err = check_int8_conv()
    trunk_kernel_times = time_int8_conv()
    flagship8, trunk_counts, trunk_cos = drive_int8_flagship()
    intercept_cos, _ = drive_intercept()
    trunk_times, trunk_tower = time_int8_flagship(flagship8.model)
    flagship8_model = flagship8.model  # kept for the profile
    del flagship8
    torch.cuda.empty_cache()

    train_launches, train_times = {}, {}
    for model_name in TRAIN_MODELS:
        if model_name == "CLIP RN50 + bi-GRU (flagship)":
            launched, protocol = drive_flagship_protocol()
        else:
            launched = drive_training(model_name)
        train_launches[model_name] = launched
        torch.cuda.empty_cache()
    for model_name in COMPARED_MODELS:
        compare_steps(model_name)
    for model_name in TIMED_MODELS:
        train_times[model_name] = time_training(model_name)
    vit_train, rn_train = (train_times[name] for name in TIMED_MODELS)
    accum = time_accum8()
    dp_launches, dp_step_ms, dp_p50 = drive_data_parallel()
    k1_times = time_k1_backward()
    attn_times = time_attention()
    topk_times = time_topk()  # after every host-paced timing, as the profile
    # the tools and the quickstart: after every host-paced timing, their
    # profile (tools.profile_step) last
    tools_counts, tools = drive_tools(protocol, rn_train)
    profile_int8_vit(*to_device(vit_forward, "cuda"),
                     enc_times[("vit", "off")])
    del vit_forward
    trunk_profile, trunk_ms = profile_int8_trunk(flagship8_model, trunk_tower)

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
        f"B=128, ViT-B/16 + bi-GRU {vit_train['ms']:.2f} ms (plain versions "
        f"{vit_train['plain_ms']:.2f} ms), peak "
        f"{vit_train['peak'] / 2**30:.2f} GiB; the flagship (CLIP RN50 + "
        f"bi-GRU, moco_train_step_ms_bs128) {rn_train['ms']:.2f} ms (plain "
        f"versions {rn_train['plain_ms']:.2f} ms), peak "
        f"{rn_train['peak'] / 2**30:.2f} GiB; K1 backward B=128 with dW "
        f"{k1_times[('bwd', 'bfloat16')]:.3f} ms (the streamed kernel in "
        f"turns {k1_times[('streamed', 'bfloat16')]:.3f} ms; the plain "
        f"recompute {k1_times[('recompute', 'bfloat16')]:.2f} ms), the "
        f"kernel alone {k1_times[('bwd alone', 'bfloat16')]:.3f} ms "
        f"({k1_times[('streamed alone', 'bfloat16')]:.3f}), a step "
        f"{times[('K1 bwd', 'step_us')]:.2f} us "
        f"({times[('K1 bwd streamed', 'step_us')]:.2f}) ({card})")
    log(f"summary, the gradient-cache step (accum8, bs1024 in 8 x 128): "
        f"{accum['ms']:.1f} ms a step, device {accum['device']:.1f} ms, peak "
        f"{accum['peak'] / 2**30:.2f} GiB, against the single-pass bs128 "
        f"flagship step {accum['single_ms']:.2f} ms, device "
        f"{accum['single_device']:.2f} ms, peak "
        f"{accum['single_peak'] / 2**30:.2f} GiB, in the same call; pass 1 "
        f"against pass 2 embeddings {accum['replay']:.3e} ({card})")
    log(f"summary, int8 encoders of the full-CLIP model: gallery encode "
        f"{enc_times[('encode', 'int8')]:.1f} img/s (bf16 float tower "
        f"{enc_times[('encode', 'float')]:.1f}); text encode B=256 "
        f"{enc_times[('text', 'on')]:.2f} ms (float "
        f"{enc_times[('text', 'float')]:.2f}); /search p50 "
        f"{enc_times[('p50', 'int8')]:.3f} ms (float text tower "
        f"{enc_times[('p50', 'float')]:.3f}); minimum cosine to the float "
        f"towers {cosines[0]:.5f} (ViT), {cosines[1]:.5f} (text) ({card})")
    k3 = {b: times[("K3 vs streamed", b)] for b in (256, 128, 1)}
    k7, k8 = ({name: int8_kernel_times[(kname, name)]
               for name in ("CLIP text", "ViT-B/16")}
              for kname in ("K7 vs rows16", "K8 vs rows16"))
    k9 = {name: int8_kernel_times[("K9 queued", name)]
          for name in ("CLIP text", "ViT-B/16")}
    log(f"summary, the kernels redesigned for this card: K3 bf16 T=105 "
        f"H=512 W-resident (the streamed kernel in the same run) B=256 "
        f"{k3[256][0]:.3f} ms ({k3[256][1]:.3f}), B=128 {k3[128][0]:.3f} "
        f"({k3[128][1]:.3f}), B=1 {k3[1][0]:.3f} ({k3[1][1]:.3f}), a step "
        f"{times[('K3', 'step_us')]:.2f} us ({times[('K3 streamed', 'step_us')]:.2f}); "
        f"K7 bf16 on the cluster tile (the 16-row kernel) CLIP text "
        f"{k7['CLIP text'][0]:.3f} ms ({k7['CLIP text'][1]:.3f}), ViT-B/16 "
        f"{k7['ViT-B/16'][0]:.3f} ({k7['ViT-B/16'][1]:.3f}); K8 gelu on the "
        f"cluster kernel (the 16-row kernel) ViT-B/16 c_fc "
        f"{k8['ViT-B/16'][0]:.4f} ms ({k8['ViT-B/16'][1]:.4f}), CLIP text "
        f"{k8['CLIP text'][0]:.4f} ({k8['CLIP text'][1]:.4f}); K9 ln bf16 "
        f"in registers, on the device (queued), warm (L2 flushed) "
        f"[24704, 768] {k9['ViT-B/16'][0]:.4f} ms "
        f"({k9['ViT-B/16'][1]:.4f}), [25600, 512] "
        f"{k9['CLIP text'][0]:.4f} ({k9['CLIP text'][1]:.4f}); K1 bf16 B=256 "
        f"{times[('K1', 256, 'bfloat16')][0]:.3f} ms ({card})")
    log("summary, K2 and K4 (D=256, k=10; queued on the device, as issued; "
        "the kernels they replaced in turns): " + "; ".join(
            f"{name} Q={n_q} G={n_g} {t['queued']:.4f} / {t['issued']:.4f} "
            f"ms ({t['old_queued']:.4f} / {t['old_issued']:.4f}), bound "
            f"{t['bound']:.5f}"
            for (name, n_q, n_g), t in topk_times.items())
        + f"; index.search of 256 queries at 98304 rows: float gallery "
        f"{int8_times[('search256', False)][0]:.3f} ms "
        f"({int8_times[('search256', False)][1]:.3f} on the device), int8 "
        f"{int8_times[('search256', True)][0]:.3f} "
        f"({int8_times[('search256', True)][1]:.3f}) ({card})")
    log(f"summary, the flagship as shipped (phase 8): in-training "
        f"evaluation {', '.join(f'{v:.3f}' for v in protocol['eval_s'])} s "
        f"(t2i R@1 {protocol['top1']}; test_net on best.pth "
        f"{protocol['test_top1']:.4f}); checkpoint snapshot "
        f"{', '.join(f'{v:.3f}' for v in protocol['snapshot_s'])} s, "
        f"background write "
        f"{', '.join(f'{v:.3f}' for v in protocol['write_s'])} s; restart "
        f"{protocol['restart_s']:.2f} s; K2 and K4 at D = 100 and 1,024, "
        f"worst error over the allowance "
        + ", ".join(f"{k} D={d} {v:.3f}" for (k, d), v in width_err.items())
        + f" ({card})")
    log(f"summary, the flagship's gallery in int8 (CLIP RN50 384x128, bf16, "
        f"batch {TRUNK_BATCH}, 3074 rows, two runs each): "
        + ", ".join(f"{k} {np.mean(v):.1f} img/s" for k, v in
                    trunk_times.items())
        + f"; the int8 trunk forward {trunk_ms:.2f} ms"
        + ("" if not trunk_profile else " (on the device: " + ", ".join(
            f"{k} {v:.2f}" for k, v in trunk_profile.items()
            if k != "launches") + " ms)")
        + f"; E1 {trunk_kernel_times['E1'][0]:.4f} ms (layer1 conv3 + "
        f"identity), E2 {trunk_kernel_times['E2'][0]:.4f} ms (stem pool); "
        f"gallery minimum cosine to the float tower {trunk_cos:.5f} "
        f"(interceptor, torchvision ResNet-50: {intercept_cos:.5f}) ({card})")
    log("summary, data parallel: train_net on the flagship yaml, bf16 step "
        f"under a one-rank NCCL group median "
        f"{np.median(dp_step_ms['group']):.2f} ms, outside a group "
        f"{np.median(dp_step_ms['plain']):.2f} ms (in turns); /search p50 "
        "(1 query, k=10), unsharded / 2 shards / 4 shards on the one card: "
        + "; ".join(
            f"{'int8' if q else 'float'} {rows} rows "
            + " / ".join(f"{dp_p50[(q, n, rows)]:.3f}"
                         for n in (None,) + DP_SHARDS) + " ms"
            for q in (False, True) for rows in DP_GALLERY_ROWS)
        + f" ({card})")
    loader = tools["loader"]
    parity_want, parity_got = tools["parity"]
    ab, prof = tools["int8_ffn_ab"], tools["profile"]
    log(f"summary, the tools and the quickstart (phase 14, "
        f"{tools['seconds']:.1f} s): export_torch of best.pth reinstalled "
        f"bit for bit ({tools['export_checked']} tensors); parity_eval rc 0 "
        f"at test_net's t2i {', '.join(f'{v:.2f}' for v in parity_want)} "
        f"(the gate's {', '.join(f'{v:.4f}' for v in parity_got)}), rc 1 "
        f"twice the budget off; the loader at 384x128, after the first "
        f"batch, cold / warm / cached img/s "
        + ", ".join(f"{w} threads {r['ours_cold_imgs_per_s']:.1f} / "
                    f"{r['ours_warm_imgs_per_s']:.1f} / "
                    f"{r['ours_cached_warm_imgs_per_s']:.1f}"
                    for w, r in loader.items())
        + f" against the step's demand "
        f"{loader[TOOLS_LOADER_WORKERS[0]]['demand_imgs_per_s']:.1f}; K7 at "
        f"the encode level (off / on): ViT {ab['vit_off_ms']:.2f} / "
        f"{ab['vit_on_ms']:.2f} ms, text {ab['text_off_ms']:.2f} / "
        f"{ab['text_on_ms']:.2f} ms; profile_step's flagship step "
        f"{prof['ms_per_step']:.2f} ms on the device (profile_steps on the "
        f"same step {tools['profile_ref']['total']:.2f}); the quickstart on "
        f"cuda, launches {tools_counts} ({card})")
    log(f"launches: serving {counts}; eval {eval_launches}; int8 serving "
        f"{int8_counts}; int8 encoders {enc_counts}; int8 flagship gallery "
        f"{trunk_counts}; "
        + "; ".join(f"training {name} {launched}"
                    for name, launched in train_launches.items())
        + "; " + "; ".join(f"data parallel, {name} {launched}"
                           for name, launched in dp_launches.items())
        + f"; the quickstart {tools_counts}")

    def launches(name):
        return sum(run.get(name, 0) for run in (
            counts, eval_launches, int8_counts, enc_counts, trunk_counts,
            *train_launches.values(), *dp_launches.values(), tools_counts))

    bounds = kernel_bounds(k1_times[("steps",)])
    bounds.update(int8_conv_bounds())
    log(f"bound K1 backward B=128 T=105 H=512 bf16 "
        f"({k1_times[('steps',)]} valid (row, step) pairs): "
        f"{bounds['bigru_pooled_bwd'][0]:.4f} ms "
        f"({bounds['bigru_pooled_bwd'][1]}; the serial product at the bf16 "
        f"rate, twice), "
        f"{bounds['bigru_pooled_bwd f32-priced'][0]:.4f} ms with both "
        f"products at the f32 rate; the kernel with dW "
        f"{k1_times[('bwd', 'bfloat16')]:.3f} ms")
    rows = [  # (entry point, source, replaces, error, (ms, plain ms), library)
        ("bigru_pooled_fwd", "bigru_resident.cu", "ops/gru_pallas.py:396",
         k1_err["bfloat16"], times[("K1", 256, "bfloat16")], None),
        # K1's backward replaces the custom VJP's bwd, which differentiates
        # the XLA scan; no single PyTorch call computes it (nn.GRU has
        # biases and another layout)
        ("bigru_pooled_bwd", "bigru_resident_bwd.cu", "ops/gru_pallas.py:421",
         k1_bwd_err["bfloat16"], (k1_times[("bwd", "bfloat16")],
                                  k1_times[("bwd plain", "bfloat16")]), None),
        ("gru_scan_fwd", "gru_scan_resident.cu", "ops/gru_pallas.py:107",
         k3_err["bfloat16"], times[("K3", 256, "bfloat16")], None),
        ("topk_similarity_f32", "topk_similarity.cu", "ops/ranking_pallas.py:211",
         k2_err, times[("K2", 3074)], None),
        ("topk_similarity_int8", "topk_similarity.cu", "ops/ranking_pallas.py:372",
         k4_err, times[("K4", 3074)], None),
        ("fused_attention_fwd", "fused_attention.cu",
         "ops/attention_pallas.py:429", attn_err[("K5", "bfloat16")],
         attn_times[("K5", "bfloat16")], attn_times[("K5", "library")]),
        ("fused_attention_bwd", "fused_attention.cu",
         "ops/attention_pallas.py:694", attn_err[("K6", "bfloat16")],
         attn_times[("K6", "bfloat16")], attn_times[("K6", "library")]),
        # K7-K9: max_abs_err is the largest int8 step (K8, K9) or output
        # difference (K7); no single PyTorch call computes any of the three
        ("int8_ffn", "int8_mm.cu", "ops/int8_mm_pallas.py:186", k7_err,
         int8_kernel_times[("K7", "CLIP text")], None),
        ("int8_matmul_requant", "int8_mm_sm90.cu", "ops/int8_mm_pallas.py:100",
         k8_err,
         int8_kernel_times[("K8", "ViT-B/16")], None),
        ("fused_requant", "requant.cu", "ops/quant_pallas.py:102", k9_err,
         int8_kernel_times[("K9", "ViT-B/16", "ln")], None),
        # E1 and E2 replace XLA fusions of the int8 trunk (no Pallas kernel):
        # int8_trunk_apply's epilogue chains and _avg_pool_int8; no single
        # PyTorch call computes either
        ("int8_conv_epilogue", "int8_conv.cu", "models/int8_tower.py:402",
         trunk_err, trunk_kernel_times["E1"], None),
        ("int8_avg_pool", "int8_conv.cu", "models/int8_tower.py:142",
         trunk_err, trunk_kernel_times["E2"], None),
    ]
    for name, *_ in rows:
        if launches(name) < 1:
            fail(f"no driven path launched {name}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "textreid_torch/csrc/" + source,
         "replaces": "textreid_tpu/" + replaces,
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
