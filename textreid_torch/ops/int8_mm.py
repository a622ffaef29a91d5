"""Int8 matmuls with a fused (quickGELU +) requant epilogue, and the whole
int8 FFN in one kernel.

Counterpart of ``textreid_tpu/ops/int8_mm_pallas.py`` (K8
:func:`fused_int8_matmul_requant`, K7 :func:`fused_int8_ffn`) and of
``textreid_tpu/models/int8_vit.py:_int8_matmul`` (:func:`int8_matmul`).

The contract, exact integer accumulation and then f32:

    y  = (f32(xq @ w) * s_w) * r_row + b          [gelu: y * sigmoid(1.702 y)]
    xn = y * (1 / s_next);  r = max(rowmax |xn|, 1e-6) * (1 / 127)
    q  = truncate(clip(xn * (1 / r) +- 0.5, +-127))                      (K8)
    z  = (f32(q @ w2) * s_w2) * r;  out = cast(z) + cast(b2)             (K7)

K8 and K7 keep the first product's output in f32 up to the rounding.  The
composition they replace (``int8_matmul`` to the tower dtype, then the GELU
there) rounds it to the tower dtype first; in an f32 tower the two are the
same function, in a bf16 tower the kernels are the tighter path.  K7 casts
``z`` to ``out_dtype`` before adding ``b2`` in ``out_dtype``.

On a CUDA tensor the wrappers launch a kernel or raise on a shape none
takes; on a CPU tensor they run :func:`int8_matmul_requant_plain` and
:func:`int8_ffn_plain`.  Nothing falls back from one to the other.  K8
(:func:`matmul_plan` picks by shape) runs ``csrc/int8_mm_sm90.cu``: W
resident across a cluster of ``N / cols`` blocks, products by ``wgmma``
s8, 64-row tiles; shapes it does not take run the 16-row tile of
``csrc/int8_mm.cu`` (``mma.sync`` s8).  K7 runs a tile of up to 64 rows
split over a cluster of ``ceil(N / 512)`` blocks (:func:`ffn_plan`,
``csrc/int8_mm.cu``).

Weights are ``[K, N]`` as in the JAX package.  The kernels read them with
each output channel's K values contiguous, so a weight held as the
transpose of a contiguous ``[N, K]`` tensor (``w_t.t()``, the layout
``torch._int_mm`` wants too) is used as it is; any other is copied.

The int8 products that the JAX package leaves to XLA outside any Pallas
kernel (qkv, out_proj, c_proj after K8, the patchify conv) go through
:func:`int_matmul`: ``torch._int_mm`` on the card, an exact float64 product
on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .requant import _check_op, quick_gelu, requant_rowdyn

MM_OPS = ("none", "gelu")
ROW_TILE = 16  # rows a block of the 16-row K8 owns: one mma.sync row tile
WARPS = 16  # warps of a 16-row K8 block, each with a row-max slot
SMEM_MAX = 232448  # bytes of shared memory a block can take on sm_90
# K8's cluster kernel (csrc/int8_mm_sm90.cu): a block owns the first of
# MM_COLS columns that splits N into at most MM_CLUSTER_MAX slices; two
# consumer warpgroups, each on its own tiles of MM_ROWS rows fed through its
# own ring of up to MM_STAGES_MAX stages of MM_ROWS x MM_CHUNK input bytes
MM_COLS = (192, 128)
MM_CLUSTER_MAX = 16
MM_ROWS = 64
MM_CHUNK = 128
MM_CONSUMERS = 2
MM_STAGES_MAX = 8
# K7's cluster tile (csrc/int8_mm.cu, ffn_cluster_kernel): a block owns at
# most SLICE middle columns and OUT_SLICE output columns; rows a tile, in
# order of preference; the warps that share a row (a block's 16 warps work
# in two halves of the rows)
SLICE, OUT_SLICE = 512, 128
FFN_TILES = (64, 32)
FFN_HALF_WARPS = 8


def int_matmul(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., K]`` x int8 ``[K, N]`` -> the exact int32 accumulator
    ``[..., N]``."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    if not x2.is_cuda:
        # |acc| <= 127^2 K < 2^53: the float64 product is the integer sum
        acc = (x2.double() @ w_q.double()).to(torch.int32)
    else:
        rows = x2.shape[0]
        if rows <= 16:  # torch._int_mm wants more than 16 rows
            x2 = torch.cat([x2, x2.new_zeros(32 - rows, k)])
        acc = torch._int_mm(x2.contiguous(), w_q)[:rows]
    return acc.reshape(*lead, w_q.shape[1])


def int8_matmul(xq, w_q, s_w, b, r_row=None, out_dtype=torch.float32):
    """int8 x int8 -> int32 -> ``(* s_w [* r_row])`` in f32, cast to
    ``out_dtype``, ``+ b`` there."""
    y = int_matmul(xq, w_q) * s_w  # int32 * f32 -> f32, one pass
    if r_row is not None:
        y *= r_row
    return y.to(out_dtype).add_(b.to(out_dtype))


def int8_matmul_requant_plain(xq, w_q, s_w, b, r_row, s_next,
                              op: str = "gelu"):
    """K8's contract in plain PyTorch (see the module docstring)."""
    _check_op(op, MM_OPS)
    y = int_matmul(xq, w_q).float() * s_w
    y = y * r_row.float() + b
    if op == "gelu":
        y = quick_gelu(y)
    return requant_rowdyn(y, s_next)


def int8_ffn_plain(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2,
                   out_dtype=torch.float32):
    """K7's contract in plain PyTorch (see the module docstring)."""
    g, r = int8_matmul_requant_plain(xq, w1_q, s_w1, b1, r_row, s_mid, "gelu")
    z = int_matmul(g, w2_q).float() * s_w2
    z = z * r
    return z.to(out_dtype) + b2.to(out_dtype)


def _kernel_weight(name: str, w_q: torch.Tensor, device) -> torch.Tensor:
    """``w_q [K, N]`` int8 -> contiguous ``[N, K]`` (no copy for ``w_t.t()``)."""
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.device != device:
        raise ValueError(f"{name} must be int8 [K, N] on {device}; got "
                         f"{w_q.dtype} {tuple(w_q.shape)} on {w_q.device}")
    return w_q.t().contiguous()


def _vector(name: str, v: torch.Tensor, n: int, device) -> torch.Tensor:
    if v.shape != (n,) or v.dtype != torch.float32 or v.device != device:
        raise ValueError(f"{name} must be f32 [{n}] on {device}; got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.contiguous()


def _rows(xq: torch.Tensor, r_row: torch.Tensor):
    if xq.dtype != torch.int8:
        raise TypeError(f"xq must be int8, not {xq.dtype}")
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernel loads 16 bytes a thread
        x2 = x2.clone()
    if r_row.shape != (*lead, 1) or r_row.device != xq.device:
        raise ValueError(f"r_row must be {(*lead, 1)} on {xq.device}; got "
                         f"{tuple(r_row.shape)} on {r_row.device}")
    return lead, x2, r_row.float().reshape(-1).contiguous()


def _int8_stride(depth: int) -> int:
    """Bytes of an int8 row in shared memory (padded against bank
    conflicts, as ``csrc/int8_mm.cu:int8_stride``)."""
    return depth + (64 if depth % 128 == 0 else 0)


def shared_bytes(k: int, n: int) -> int:
    """Shared memory of one block of K8 (``csrc/int8_mm.cu``): the int8
    input tile, the f32 middle ``[ROW_TILE, N]`` (padded against bank
    conflicts), the reciprocal consumer scales and the row statistics."""
    return (ROW_TILE * (n + 8) * 4 + ROW_TILE * _int8_stride(k) + n * 4
            + (WARPS + 2) * ROW_TILE * 4)


def ffn_shared_bytes(k: int, n: int, m_out: int, rows: int) -> int:
    """Shared memory of one block of K7's cluster tile of ``rows`` rows
    (``csrc/int8_mm.cu:ffn_bytes``), with C = ceil(N / SLICE) blocks, S =
    N / C middle and P = M / C output columns a block: the f32 middle
    ``[rows, S + 8]``, whose place the s32 partial sums ``[3, rows, P + 8]``
    (the upper depth half's scratch and two ring stages) take after the
    requant; the int8 input ``[rows, K]``, whose place the int8 middle
    ``[rows, S]`` takes; the reciprocal consumer scales ``[S]``; and the row
    statistics (the maxima of each of the 8 warps that share a row, the
    input and middle scales, the block's maxima that its peers read)."""
    c = -(-n // SLICE)
    s, p = n // c, m_out // c
    mid = max(4 * rows * (s + 8), 12 * rows * (p + 8))
    ints = rows * max(_int8_stride(k), _int8_stride(s))
    return mid + ints + 4 * (s + (FFN_HALF_WARPS + 3) * rows)


def ffn_plan(k: int, n: int, m_out: int) -> tuple:
    """K7's cluster tile at (K, N, M): ``(blocks a cluster, rows a tile)``,
    the rows the largest of ``FFN_TILES`` whose block fits ``SMEM_MAX``.
    Raises on a shape the kernel does not take."""
    c = -(-n // SLICE)
    if (k % 64 or k < 64 or n % 64 or n < 64 or c > 8 or n % c
            or (n // c) % 64 or m_out % c or (m_out // c) % 32
            or m_out // c > OUT_SLICE):
        raise ValueError(
            f"fused_int8_ffn needs K % 64 == 0, N % 64 == 0 (N <= 4096) "
            f"split into C = ceil(N / {SLICE}) slices of a multiple of 64, "
            f"and M / C a multiple of 32 up to {OUT_SLICE}; got K={k} N={n} "
            f"M={m_out}")
    for rows in FFN_TILES:
        if ffn_shared_bytes(k, n, m_out, rows) <= SMEM_MAX:
            return c, rows
    raise ValueError(
        f"fused_int8_ffn: a {FFN_TILES[-1]}-row tile at K={k}, N={n}, "
        f"M={m_out} needs {ffn_shared_bytes(k, n, m_out, FFN_TILES[-1])} "
        f"bytes of shared memory, the card has {SMEM_MAX}")


def matmul_shared_bytes(k: int, cols: int, cluster: int, stages: int) -> int:
    """Shared memory of one block of K8's cluster kernel
    (``csrc/int8_mm_sm90.cu:sm90_bytes``): 1 KB of slack to align the base
    to a swizzle atom, the block's ``[cols, K]`` int8 slice of the weight,
    each consumer's ring of ``stages`` input stages and row maxima ``[2,
    cluster, MM_ROWS]`` f32, the slice's three f32 vectors and the
    mbarriers."""
    return (1024 + cols * k + MM_CONSUMERS * stages * MM_ROWS * MM_CHUNK
            + 4 * MM_CONSUMERS * 2 * cluster * MM_ROWS + 12 * cols
            + 8 * (MM_CONSUMERS * (2 * stages + 2) + 1))


class MatmulPlan(NamedTuple):
    """K8's kernel at a shape: ``"cluster"`` (``int8_mm_sm90.cu``) or
    ``"rows16"`` (``int8_mm.cu``), blocks a cluster, columns a block, rows a
    tile, input stages a consumer and shared bytes a block."""
    kernel: str
    cluster: int
    cols: int
    rows: int
    stages: int
    smem: int


def matmul_plan(k: int, n: int) -> MatmulPlan:
    """K8's kernel for ``[rows, K] @ [K, N]``, as the library's
    ``int8_matmul_requant_plan`` gives it: the cluster kernel where K is a
    multiple of ``MM_CHUNK`` and the first of ``MM_COLS`` that divides N
    into at most ``MM_CLUSTER_MAX`` slices fits at least 2 stages a
    consumer (as many as fit, up to ``MM_STAGES_MAX``); else the 16-row
    kernel.
    Raises on a shape neither takes."""
    if k >= MM_CHUNK and k % MM_CHUNK == 0:
        for cols in MM_COLS:
            cluster = n // cols
            if n % cols or cluster > MM_CLUSTER_MAX:
                continue
            for stages in range(MM_STAGES_MAX, 1, -1):
                smem = matmul_shared_bytes(k, cols, cluster, stages)
                if smem <= SMEM_MAX:
                    return MatmulPlan("cluster", cluster, cols, MM_ROWS,
                                      stages, smem)
    _check_dims("fused_int8_matmul_requant", k, n)
    return MatmulPlan("rows16", 1, n, ROW_TILE, 0, shared_bytes(k, n))


def _check_dims(name: str, k: int, n: int, m_out: int = 0) -> None:
    if k % 64 or n % 64 or m_out % 8 or k < 64 or n < 64 or n > 4096:
        raise ValueError(
            f"{name} needs K % 64 == 0, N % 64 == 0 (N <= 4096) and an "
            f"output width in multiples of 8; got K={k} N={n}"
            + (f" M={m_out}" if m_out else ""))
    if shared_bytes(k, n) > SMEM_MAX:
        raise ValueError(
            f"{name}: a {ROW_TILE}-row tile at K={k}, N={n} needs "
            f"{shared_bytes(k, n)} bytes of shared memory, the card has "
            f"{SMEM_MAX}")


def _matmul_requant_cuda(xq, w_q, s_w, b, r_row, s_next, op):
    dev = xq.device
    lead, x2, r2 = _rows(xq, r_row)
    rows, k = x2.shape
    w_t = _kernel_weight("w_q", w_q, dev)
    n = w_t.shape[0]
    if w_t.shape[1] != k:
        raise ValueError(f"w_q is {tuple(w_q.shape)}, xq has K={k}")
    entry = ("int8_matmul_requant" if matmul_plan(k, n).kernel == "cluster"
             else "int8_matmul_requant_rows16")
    q, r = _launch_matmul_requant(entry, x2, w_t, s_w, b, r2, s_next, op)
    if rows:
        fused_int8_matmul_requant.launches += 1
    return q.reshape(*lead, n), r.reshape(*lead, 1)


def _launch_matmul_requant(entry, x2, w_t, s_w, b, r2, s_next, op):
    """Launch K8's library entry ``entry`` on ``x2 [rows, K]`` and ``w_t
    [N, K]``; returns (q ``[rows, N]``, r ``[rows, 1]``)."""
    dev = x2.device
    (rows, k), n = x2.shape, w_t.shape[0]
    s_w, b, s_next = (_vector(name, v, n, dev) for name, v in (
        ("s_w", s_w), ("b", b), ("s_next", s_next)))
    q = torch.empty(rows, n, dtype=torch.int8, device=dev)
    r = torch.empty(rows, 1, dtype=torch.float32, device=dev)
    if rows:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, entry)(
                x2.data_ptr(), w_t.data_ptr(), s_w.data_ptr(), b.data_ptr(),
                r2.data_ptr(), s_next.data_ptr(), q.data_ptr(), r.data_ptr(),
                rows, k, n, int(op == "gelu"), stream)
        _build.check(err, entry)
    return q, r


def _ffn_cuda(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2, out_dtype):
    dev = xq.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_int8_ffn emits f32 or bf16, not {out_dtype}")
    lead, x2, r2 = _rows(xq, r_row)
    rows, k = x2.shape
    w1_t = _kernel_weight("w1_q", w1_q, dev)
    w2_t = _kernel_weight("w2_q", w2_q, dev)
    n, m_out = w1_t.shape[0], w2_t.shape[0]
    if w1_t.shape[1] != k or w2_t.shape[1] != n:
        raise ValueError(f"w1_q {tuple(w1_q.shape)} and w2_q "
                         f"{tuple(w2_q.shape)} do not chain from K={k}")
    ffn_plan(k, n, m_out)
    s_w1, b1, s_mid = (_vector(name, v, n, dev) for name, v in (
        ("s_w1", s_w1), ("b1", b1), ("s_mid", s_mid)))
    s_w2, b2 = (_vector(name, v, m_out, dev) for name, v in (
        ("s_w2", s_w2), ("b2", b2)))
    out = torch.empty(rows, m_out, dtype=out_dtype, device=dev)
    if rows:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.int8_ffn(
                x2.data_ptr(), w1_t.data_ptr(), s_w1.data_ptr(),
                b1.data_ptr(), r2.data_ptr(), s_mid.data_ptr(),
                w2_t.data_ptr(), s_w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), rows, k, n, m_out,
                int(out_dtype == torch.bfloat16), stream)
        _build.check(err, "int8_ffn")
        fused_int8_ffn.launches += 1
    return out.reshape(*lead, m_out)


def fused_int8_matmul_requant(xq, w_q, s_w, b, r_row, s_next,
                              op: str = "gelu"):
    """K8: ``xq [..., K]`` int8 ``@ w_q [K, N]`` int8 -> decode -> (quickGELU)
    -> requant for the consumer site.  ``s_w [N]`` decodes the weights,
    ``b [N]`` is the bias, ``r_row [..., 1]`` the input's row scale,
    ``s_next [N]`` the consumer's calibrated scale.  Returns (int8
    ``[..., N]``, f32 ``[..., 1]``).  A CUDA tensor launches the kernel
    :func:`matmul_plan` picks (counted in ``.launches``) or raises; a CPU
    tensor runs :func:`int8_matmul_requant_plain`."""
    _check_op(op, MM_OPS)
    if xq.is_cuda:
        return _matmul_requant_cuda(xq, w_q, s_w, b, r_row, s_next, op)
    return int8_matmul_requant_plain(xq, w_q, s_w, b, r_row, s_next, op)


def fused_int8_ffn(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2,
                   out_dtype=torch.float32):
    """K7: ``c_fc`` -> decode -> quickGELU -> requant -> ``c_proj`` ->
    decode in one kernel; the ``[rows, N]`` middle never reaches device
    memory.  Returns ``[..., M]`` in ``out_dtype`` (the residual add is the
    caller's).  A CUDA tensor launches ``int8_ffn`` (counted in
    ``.launches``) or raises; a CPU tensor runs :func:`int8_ffn_plain`."""
    if xq.is_cuda:
        return _ffn_cuda(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2,
                         out_dtype)
    return int8_ffn_plain(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2,
                          out_dtype)


fused_int8_matmul_requant.launches = 0
fused_int8_ffn.launches = 0
