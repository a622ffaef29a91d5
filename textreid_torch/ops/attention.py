"""Fused multi-head attention over the ``[q | k | v]`` projection slab.

Counterpart of ``textreid_tpu/ops/attention_pallas.py``: K5
:func:`fused_attention` (forward) and K6 :func:`fused_attention_bwd`
(backward, scores recomputed).  On a CUDA tensor each launches its
hand-written kernel in ``csrc/fused_attention.cu`` (bf16 on the tensor
cores, one launch each way; f32 on the FP32 cores, the backward in two
launches that share a scratch; :func:`launch_plan` says what is launched
for a shape); on a CPU tensor each
runs its plain version (:func:`fused_attention_plain`,
:func:`fused_attention_bwd_plain`), the kernel's contract written in torch
with the same casts.  Nothing falls back from one to the other.
:func:`attention` is the differentiable entry the transformer blocks call:
K5 forward, K6 backward.

Layout is the JAX package's: ``qkv [B, S, 3W]`` with head ``h`` at columns
``h*D``, ``W + h*D`` and ``2W + h*D``; the output ``[B, S, W]`` keeps head
order, and the gradient ``dqkv [B, S, 3W]`` uses the same slabs.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# The kernels keep a row's scores in registers (bf16: 16-key mma tiles, at
# most 18; f32: 32 keys per lane-chunk, at most 9); ViT-L/14 at 224 (S=257)
# fits.
S_MAX = 288
HEAD_DIMS = (32, 64)
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
KEY_TILE = 16                 # bf16: rows and keys per mma tile
KEY_TILE_COUNTS = (7, 13, 18)  # ... and the tile counts instantiated
TILE_GROUP = 4                # key tiles the kernels walk under one guard
F32_TILE = 64                 # f32: query rows per block


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def launch_plan(batch: int, seq: int, heads: int, head_dim: int,
                dtype: torch.dtype) -> dict:
    """What ``csrc/fused_attention.cu`` launches for this shape, computed
    the way its host code does: per kernel the grid, the threads and the
    dynamic shared-memory bytes; the padded ``S``; and the f32 scratch
    elements the backward needs in device memory (none in bf16).

    bf16: one block per (head, sample) on the tensor cores, Q, K, V (and G)
    staged whole, rows padded with zeros to whole groups of four 16-key
    tiles; instantiated for 7, 13 or 18 key tiles.  f32: one block per
    (64-row query tile, head, sample) on the FP32 cores, rows padded to 32
    at an odd-word stride; the backward is two launches that share a
    ``[B, H, S, 4]`` scratch."""
    if dtype == torch.bfloat16:
        live = -(-seq // KEY_TILE)
        tiles = next(n for n in KEY_TILE_COUNTS if live <= n)
        # whole groups of key tiles are staged (zero rows past S)
        s_pad = min(tiles, _ceil_to(live, TILE_GROUP)) * KEY_TILE
        operand = s_pad * head_dim * 2
        bwd_threads = 128 if tiles < KEY_TILE_COUNTS[-1] else 256
        return {
            "s_pad": s_pad, "key_tiles": tiles, "scratch_floats": 0,
            "fwd": [{"grid": (heads, batch), "threads": 128,
                     "smem": 3 * operand}],
            "bwd": [{"grid": (heads, batch), "threads": bwd_threads,
                     "smem": 4 * operand + 3 * s_pad * 4}],
        }
    if dtype != torch.float32:
        raise TypeError(f"fused attention takes f32 or bf16, not {dtype}")
    s_pad = _ceil_to(seq, 32)
    grid = (-(-seq // F32_TILE), heads, batch)
    staged = 2 * s_pad * (head_dim + 1) * 4
    tile = F32_TILE * head_dim * 4
    return {
        "s_pad": s_pad, "key_tiles": s_pad // 32,
        "scratch_floats": batch * heads * seq * 4,
        "fwd": [{"grid": grid, "threads": 256, "smem": staged + tile}],
        "bwd": [{"grid": grid, "threads": 256, "smem": staged + 2 * tile},
                {"grid": grid, "threads": 256,
                 "smem": staged + 2 * tile + 3 * s_pad * 4}],
    }


def _dims(qkv: torch.Tensor, heads: int):
    batch, seq, three_w = qkv.shape
    if three_w % (3 * heads):
        raise ValueError(
            f"qkv last dim {three_w} is not divisible by 3*heads="
            f"{3 * heads}; the [q|k|v] head slicing would misalign.")
    width = three_w // 3
    return batch, seq, width, width // heads


def _scale(head_dim: int, scale: Optional[float]) -> float:
    return float(head_dim) ** -0.5 if scale is None else float(scale)


def _split_heads(qkv: torch.Tensor, heads: int):
    """``[B, S, 3W]`` -> q, k, v each ``[B, H, S, D]`` (views)."""
    batch, seq, width, head_dim = _dims(qkv, heads)
    return [t.reshape(batch, seq, heads, head_dim).transpose(1, 2)
            for t in qkv.split(width, dim=-1)]


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    batch, heads, seq, head_dim = t.shape
    return t.transpose(1, 2).reshape(batch, seq, heads * head_dim)


def _scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """f32 ``(q k^T) * scale`` (scale after the dot), ``-inf`` above the
    diagonal when causal."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        seq = s.shape[-1]
        keep = torch.ones(seq, seq, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def fused_attention_plain(qkv: torch.Tensor, heads: int, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` as ``_attention_kernel`` computes it:
    f32 scores, ``e = exp(s - rowmax)``, ``(e cast to v's dtype) @ v`` with
    f32 accumulation, then ``/ rowsum(e)``, cast to the input dtype."""
    _, _, _, head_dim = _dims(qkv, heads)
    q, k, v = _split_heads(qkv, heads)
    s = _scores(q, k, _scale(head_dim, scale), causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = e.to(v.dtype).float() @ v.float()
    return _merge_heads((o / e.sum(dim=-1, keepdim=True)).to(qkv.dtype))


def fused_attention_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                              causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """d(attention)/d(qkv) as ``_attention_bwd_kernel`` computes it:
    normalised f32 ``p``, ``dv = (p cast)^T g``, ``dp = g v^T`` in f32,
    ``ds = p (dp - rowsum(dp p)) scale``, ``dq = (ds cast) k``,
    ``dk = (ds cast)^T q``; returns ``dqkv [B, S, 3W]``."""
    batch, seq, width, head_dim = _dims(qkv, heads)
    scale = _scale(head_dim, scale)
    q, k, v = _split_heads(qkv, heads)
    gh = g.reshape(batch, seq, heads, head_dim).transpose(1, 2).float()
    s = _scores(q, k, scale, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ gh
    dp = gh @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dsc = ds.to(q.dtype).float()
    dq = dsc @ k.float()
    dk = dsc.transpose(-1, -2) @ q.float()
    return torch.cat([_merge_heads(t.to(qkv.dtype)) for t in (dq, dk, dv)],
                     dim=-1)


def _check(name: str, qkv: torch.Tensor, heads: int, *others) -> None:
    if qkv.dim() != 3:
        raise ValueError(f"{name} needs qkv [B, S, 3W]; got "
                         f"{tuple(qkv.shape)}")
    batch, seq, width, head_dim = _dims(qkv, heads)
    if head_dim not in HEAD_DIMS or not 1 <= seq <= S_MAX or batch < 1:
        raise ValueError(f"{name} needs head_dim in {HEAD_DIMS}, "
                         f"1 <= S <= {S_MAX}, B >= 1; got B={batch} S={seq} "
                         f"head_dim={head_dim}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16, not {qkv.dtype}")
    tensors = (("qkv", qkv, qkv.shape), *others)
    for label, t, shape in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{label} must be {tuple(shape)}; got "
                             f"{tuple(t.shape)}")
        if t.dtype != qkv.dtype:
            raise TypeError(f"{label} is {t.dtype}, qkv is {qkv.dtype}")
    for label, t, _ in tensors:
        if not t.is_cuda or t.device != qkv.device:
            raise ValueError(f"{label} must be on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")


def _fused_attention_cuda(qkv, heads, causal, scale) -> torch.Tensor:
    _check("fused_attention_fwd", qkv, heads)
    batch, seq, width, head_dim = _dims(qkv, heads)
    out = torch.empty(batch, seq, width, dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), batch, seq, width, heads,
            _scale(head_dim, scale), int(causal),
            int(qkv.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_attention_fwd")
    fused_attention.launches += 1
    return out


def _fused_attention_bwd_cuda(qkv, g, heads, causal, scale) -> torch.Tensor:
    batch, seq, three_w = qkv.shape
    _check("fused_attention_bwd", qkv, heads,
           ("g", g, (batch, seq, three_w // 3)))
    _, _, width, head_dim = _dims(qkv, heads)
    dqkv = torch.empty_like(qkv)
    # f32 only: per-row (max, sum, rowsum(dp p)) handed from the dq launch
    # to the dk/dv launch; the bf16 kernel keeps them in shared memory
    floats = launch_plan(batch, seq, heads, head_dim,
                         qkv.dtype)["scratch_floats"]
    stats = torch.empty(floats, dtype=torch.float32,
                        device=qkv.device) if floats else None
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            None if stats is None else stats.data_ptr(), batch, seq, width,
            heads, _scale(head_dim, scale), int(causal),
            int(qkv.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    return dqkv


def fused_attention(qkv: torch.Tensor, heads: int, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K5: ``[B, S, 3W]`` -> ``[B, S, W]``.  A CUDA tensor launches
    ``fused_attention_fwd`` (counted in ``fused_attention.launches``); a
    CPU tensor runs the plain version."""
    if qkv.is_cuda:
        return _fused_attention_cuda(qkv, heads, causal, scale)
    return fused_attention_plain(qkv, heads, causal, scale)


def fused_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """K6: ``qkv [B, S, 3W]``, ``g [B, S, W]`` -> ``dqkv [B, S, 3W]``.  A
    CUDA tensor launches ``fused_attention_bwd`` (counted in
    ``fused_attention_bwd.launches``); a CPU tensor runs the plain
    version."""
    if qkv.is_cuda:
        return _fused_attention_bwd_cuda(qkv, g, heads, causal, scale)
    return fused_attention_bwd_plain(qkv, g, heads, causal, scale)


class _Attention(torch.autograd.Function):
    """K5 forward, K6 backward; only ``qkv`` is saved (scores are
    recomputed, never stored)."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, scale):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, causal, scale)
        return fused_attention(qkv, heads, causal, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return fused_attention_bwd(qkv, g.contiguous(), *ctx.args), None, \
            None, None


def attention(qkv: torch.Tensor, heads: int, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable fused attention (``hybrid_attention`` with the kernel
    in both directions)."""
    return _Attention.apply(qkv, heads, causal, scale)


fused_attention.launches = 0
fused_attention_bwd.launches = 0
