"""Int8 convolutions on NHWC tensors: the static requant, the 2x2 integer
pool, im2col, and the fused epilogue after each int8 product.

Counterpart of the elementwise work that ``textreid_tpu/models/
int8_tower.py`` leaves to XLA's fusions (no Pallas kernel there):
``_requant`` (:func:`requant_static`), ``_avg_pool_int8``
(:func:`avg_pool_int8`) and the chain that follows every int8 convolution
in ``int8_trunk_apply`` (:func:`conv_epilogue_plain`).  Everything runs on
NHWC tensors, so that a 1x1 convolution is a ``[B H W, Ci] @ [Ci, Co]``
product and an epilogue's channel is the last axis.

The products themselves stay a library call, as JAX leaves them to XLA:
:func:`int8_conv2d` is im2col (:func:`im2col_int8`) and then
``ops.int8_mm.int_matmul`` (``torch._int_mm`` on the card, an exact
float64 product on the CPU).  ``torch._int_mm`` wants K and N multiples of
8: im2col pads K with zero columns, and the prepared weights carry as many
zero rows (the stem's 3 x 3 x 3 = 27 becomes 32).

The epilogue contract, in the epilogue dtype ``ep`` (f32 or bf16; every
operation rounded to ``ep``), per element of channel n:

    v = ep(acc) * s_w[n] + b[n]           (or v = ep(x) for a float input)
    v += (q_res + 128) * s_res[n]         residual "asym": a block's input
    v += q_res * s_res[n]                 residual "sym": the downsample
    v = max(v, 0)                         relu
    sym:   q = trunc(clip(v * inv[n] +- 0.5, -127, 127))
    asym:  q = trunc(clip(v * inv[n], 0, 254) + 0.5) - 128
    float: v in f32 or bf16

The rounding is half away from zero by +-0.5 and truncation, as the JAX
graph rounds (``jnp.round``, half to even, was too slow on the TPU); the
interceptor (``models/quant_tower.py``) rounds half to even after a
division, so the two share no helper.

On a CUDA tensor :func:`int8_conv_epilogue` (E1) and :func:`int8_avg_pool`
(E2) launch the hand-written kernels of ``csrc/int8_conv.cu`` or raise; on
a CPU tensor they run :func:`conv_epilogue_plain` and
:func:`avg_pool_int8`.  Nothing falls back from one to the other.  E1 and
E2 are the port's own numbers (the K numbers are the Pallas functions').
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .int8_mm import int_matmul

K_MULTIPLE = 8  # torch._int_mm wants K and N multiples of 8
OUTS = ("sym", "asym", "float32", "bfloat16")
RESIDUALS = (None, "asym", "sym")
EPILOGUE_DTYPES = (torch.float32, torch.bfloat16)
_IN_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def round_up(n: int, multiple: int = K_MULTIPLE) -> int:
    return -(-n // multiple) * multiple


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def requant_static(y: torch.Tensor, inv_scale: torch.Tensor,
                   asym: bool = False) -> torch.Tensor:
    """``y`` (f32 or bf16, channels last) -> int8 at the per-channel inverse
    scale ``inv_scale`` (already in ``y``'s dtype), in ``y``'s dtype.

    Symmetric: ``q = round(y / s)`` in [-127, 127].  Asymmetric (ReLU
    outputs): ``q = round(y / s) - 128`` in [-128, 126], decoding as
    ``(q + 128) s``.  Rounds half away from zero by +-0.5 and truncation
    (``float -> int`` truncates toward zero)."""
    v = y * inv_scale
    if asym:
        v = v.clamp(0.0, 254.0) + 0.5
        return (v.to(torch.int32) - 128).to(torch.int8)
    half = torch.full((), 0.5, dtype=v.dtype, device=v.device)
    v = v + torch.where(v >= 0, half, -half)
    return v.clamp(-127.0, 127.0).to(torch.int32).to(torch.int8)


def avg_pool_int8(xq: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of NHWC int8, scale-preserving: ``(sum + 2) >> 2``
    of the four values (an arithmetic shift: round half up, negatives too),
    clipped to [-128, 127]; an odd last row or column is dropped (VALID)."""
    b, h, w, c = xq.shape
    x = xq[:, :h // 2 * 2, :w // 2 * 2].to(torch.int32)
    summed = x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))
    return torch.bitwise_right_shift(summed + 2, 2).clamp(-128, 127).to(
        torch.int8)


def conv_epilogue_plain(x: torch.Tensor, inv: Optional[torch.Tensor] = None,
                        s_w: Optional[torch.Tensor] = None,
                        b: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        s_res: Optional[torch.Tensor] = None,
                        res_mode: Optional[str] = None, relu: bool = False,
                        out: str = "sym", ep: torch.dtype = torch.float32):
    """E1's contract in plain PyTorch (see the module docstring)."""
    v = x.to(ep)
    if s_w is not None:
        v = v * s_w.to(ep) + b.to(ep)
    if res_mode is not None:
        r = residual.to(ep)
        if res_mode == "asym":
            r = r + 128.0
        v = v + r * s_res.to(ep)
    if relu:
        v = torch.relu(v)
    if out in ("sym", "asym"):
        return requant_static(v, inv.to(ep), out == "asym")
    return v.to(getattr(torch, out))


def _as_words(xq: torch.Tensor) -> torch.Tensor:
    """``xq`` viewed with 8 (or 4, 2) int8 channels to one integer word
    where its layout allows: the same bytes, so that a copy of it moves a
    word per element instead of a byte (PyTorch's strided copy pays its
    index arithmetic per element)."""
    for dtype, width in ((torch.int64, 8), (torch.int32, 4),
                         (torch.int16, 2)):
        if (xq.shape[-1] % width == 0 and xq.stride(-1) == 1
                and all(st % width == 0 for st in xq.stride()[:-1])
                and xq.storage_offset() % width == 0
                and xq.data_ptr() % width == 0):
            return xq.view(dtype)
    return xq


def im2col_int8(xq: torch.Tensor, kernel: Tuple[int, int],
                stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NHWC int8 ``[B, H, W, C]`` (any strides) -> ``[B Ho Wo, K]``: the
    receptive field of each output pixel in (kh, kw, ci) order, the input
    zero-padded, and K padded with zero columns to a multiple of 8."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    b, ho, wo = conv_out_shape(xq.shape, kernel, stride, padding)
    c = xq.shape[-1]
    if ph or pw:
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
    words = _as_words(xq)
    s_b, s_h, s_w, s_c = words.stride()
    cols = words.as_strided((b, ho, wo, kh, kw, words.shape[-1]),
                            (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))
    cols = cols.reshape(b * ho * wo, -1).view(torch.int8)
    k = kh * kw * c
    if k % K_MULTIPLE:
        cols = F.pad(cols, (0, round_up(k) - k))
    return cols


def conv_out_shape(shape, kernel, stride=(1, 1), padding=(0, 0)):
    """``(B, Ho, Wo)`` of a convolution of NHWC ``shape``."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    return (shape[0], (shape[1] + 2 * ph - kh) // sh + 1,
            (shape[2] + 2 * pw - kw) // sw + 1)


def int8_conv2d(xq: torch.Tensor, w_q: torch.Tensor, kernel,
                stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NHWC int8 ``xq`` x the flattened int8 weight ``w_q [K, N]`` (rows in
    (kh, kw, ci) order, zero rows to K's multiple of 8; held as the
    transpose of a contiguous ``[N, K]``, as ``torch._int_mm`` reads it) ->
    the exact int32 accumulator ``[B, Ho, Wo, N]``.  An unpadded 1x1
    convolution at stride 1 of a contiguous input is the product alone."""
    b, ho, wo = conv_out_shape(xq.shape, kernel, stride, padding)
    if (_pair(kernel) == (1, 1) and _pair(stride) == (1, 1)
            and _pair(padding) == (0, 0) and xq.is_contiguous()
            and xq.shape[-1] % K_MULTIPLE == 0):
        cols = xq.reshape(-1, xq.shape[-1])
    else:
        cols = im2col_int8(xq, kernel, stride, padding)
    n = w_q.shape[1]
    if n % K_MULTIPLE:  # zero columns to N's multiple of 8, cut after
        w_q = F.pad(w_q.t(), (0, 0, 0, round_up(n) - n)).t()
    return int_matmul(cols, w_q)[:, :n].reshape(b, ho, wo, n)


def flatten_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[co, ci, kh, kw]`` -> ``[K, co]`` in (kh, kw, ci) order with
    zero rows to K's multiple of 8, held as the transpose of a contiguous
    ``[co, K]`` (the JAX kernel's HWIO order, flattened)."""
    co = w.shape[0]
    flat = w.permute(0, 2, 3, 1).reshape(co, -1)
    k = flat.shape[1]
    if k % K_MULTIPLE:
        flat = F.pad(flat, (0, round_up(k) - k))
    return flat.contiguous().t()


# ---------------------------------------------------------------------------
# E1: the fused epilogue
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) at a 16-byte address: the kernels load 16 bytes
    (4 channels) at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def _check_vector(name, v, n, device):
    if v is None or v.shape != (n,) or v.dtype != torch.float32 or (
            v.device != device):
        got = None if v is None else (v.dtype, tuple(v.shape), v.device)
        raise ValueError(f"{name} must be f32 [{n}] on {device}; got {got}")
    return _aligned(v.contiguous())


def _int8_conv_epilogue_cuda(x, inv, s_w, b, residual, s_res, res_mode,
                             relu, out, ep):
    lead, n = x.shape[:-1], x.shape[-1]
    if x.dtype not in _IN_KINDS:
        raise TypeError(f"int8_conv_epilogue takes int32, f32 or bf16, not "
                        f"{x.dtype}")
    dev = x.device
    affine = s_w is not None
    if affine != (x.dtype == torch.int32):
        raise ValueError("an int32 accumulator takes s_w and b, a float "
                         "input neither")
    x2 = _aligned(x.reshape(-1, n).contiguous())
    rows = x2.shape[0]
    if rows * n >= 2 ** 31:  # the kernel indexes elements in 32 bits
        raise ValueError(f"int8_conv_epilogue takes fewer than 2^31 "
                         f"elements; got {rows} x {n}")
    keep = [x2]  # every buffer the kernel reads lives until the launch
    ptrs = {}
    for name, v in (("s_w", s_w), ("b", b), ("s_res", s_res),
                    ("inv", inv)):
        need = {"s_w": affine, "b": affine, "s_res": res_mode is not None,
                "inv": out in ("sym", "asym")}[name]
        if need:
            v = _check_vector(name, v, n, dev)
            keep.append(v)
            ptrs[name] = v.data_ptr()
        else:
            ptrs[name] = None
    res_ptr = None
    if res_mode is not None:
        if residual is None or residual.dtype != torch.int8 or (
                residual.shape != x.shape) or residual.device != dev:
            raise ValueError(f"residual must be int8 {tuple(x.shape)} on "
                             f"{dev}")
        r2 = _aligned(residual.reshape(-1, n).contiguous())
        keep.append(r2)
        res_ptr = r2.data_ptr()
    out_dtype = {"sym": torch.int8, "asym": torch.int8,
                 "float32": torch.float32, "bfloat16": torch.bfloat16}[out]
    y = torch.empty(rows, n, dtype=out_dtype, device=dev)
    if rows:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.int8_conv_epilogue(
                x2.data_ptr(), _IN_KINDS[x.dtype], ptrs["s_w"], ptrs["b"],
                res_ptr, ptrs["s_res"], RESIDUALS.index(res_mode), int(relu),
                ptrs["inv"], y.data_ptr(), OUTS.index(out), rows, n,
                int(ep == torch.bfloat16), stream)
        _build.check(err, "int8_conv_epilogue")
        int8_conv_epilogue.launches += 1
    return y.reshape(*lead, n)


def int8_conv_epilogue(x: torch.Tensor, inv: Optional[torch.Tensor] = None,
                       s_w: Optional[torch.Tensor] = None,
                       b: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       s_res: Optional[torch.Tensor] = None,
                       res_mode: Optional[str] = None, relu: bool = False,
                       out: str = "sym", ep: torch.dtype = torch.float32):
    """E1: the epilogue of an int8 convolution over channels-last ``x``:
    the int32 accumulator with ``s_w`` and ``b`` (f32 ``[N]``), or a float
    tensor (f32, bf16) to requantize, without them.  ``residual`` int8 of
    ``x``'s shape decoded by ``res_mode`` ("asym": ``(q + 128) s_res``,
    "sym": ``q s_res``); ``relu``; ``out`` "sym" or "asym" int8 at ``inv``
    (f32 ``[N]``, the reciprocal scale), or "float32" / "bfloat16";
    ``ep`` the epilogue dtype (f32 or bf16).  A CUDA tensor launches
    ``int8_conv_epilogue`` (counted in ``int8_conv_epilogue.launches``) or
    raises; a CPU tensor runs :func:`conv_epilogue_plain`."""
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}; got {out!r}")
    if res_mode not in RESIDUALS:
        raise ValueError(f"res_mode must be one of {RESIDUALS}; got "
                         f"{res_mode!r}")
    if ep not in EPILOGUE_DTYPES:
        raise ValueError(f"ep must be f32 or bf16; got {ep}")
    if x.is_cuda:
        return _int8_conv_epilogue_cuda(x, inv, s_w, b, residual, s_res,
                                        res_mode, relu, out, ep)
    return conv_epilogue_plain(x, inv, s_w, b, residual, s_res, res_mode,
                               relu, out, ep)


int8_conv_epilogue.launches = 0


# ---------------------------------------------------------------------------
# E2: the 2x2 integer pool
# ---------------------------------------------------------------------------

def _int8_avg_pool_cuda(xq):
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"int8_avg_pool takes int8 NHWC; got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    b, h, w, c = xq.shape
    if c % 4:
        raise ValueError(f"int8_avg_pool needs C % 4 == 0; got C={c}")
    if xq.numel() >= 2 ** 33:  # 4-channel units indexed in 32 bits
        raise ValueError(f"int8_avg_pool takes fewer than 2^33 elements; "
                         f"got {tuple(xq.shape)}")
    x = _aligned(xq.contiguous())
    y = torch.empty(b, h // 2, w // 2, c, dtype=torch.int8, device=xq.device)
    if y.numel():
        lib = _build.library()
        with torch.cuda.device(xq.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.int8_avg_pool(x.data_ptr(), y.data_ptr(), b, h, w, c,
                                    stream)
        _build.check(err, "int8_avg_pool")
        int8_avg_pool.launches += 1
    return y


def int8_avg_pool(xq: torch.Tensor) -> torch.Tensor:
    """E2: the 2x2 integer pool of NHWC int8 (:func:`avg_pool_int8`'s
    contract).  A CUDA tensor launches ``int8_avg_pool`` (counted in
    ``int8_avg_pool.launches``) or raises; a CPU tensor runs
    :func:`avg_pool_int8`."""
    if xq.is_cuda:
        return _int8_avg_pool_cuda(xq)
    return avg_pool_int8(xq)


int8_avg_pool.launches = 0
