"""Fused (LayerNorm | quickGELU | identity) + two-level int8 requant.

Counterpart of ``textreid_tpu/ops/quant_pallas.py`` (K9
:func:`fused_requant`) and of the composition it stands for in
``textreid_tpu/models/int8_vit.py`` (``_norm_no_affine``, ``_quick_gelu``,
``_requant_rowdyn``).  The int8-dataflow towers put one such pass before
every block matmul: normalize (or not), multiply by the reciprocal of the
calibrated per-channel scale, take the row's abs-max, round to int8.

Eager PyTorch fuses nothing, so on the card the composition is eight or so
launches over the activation; the kernel (``csrc/requant.cu``) reads each
row once and writes the int8 row and one scale: a warp a row, the row held
in registers up to C = 1024 (16-byte loads, two rows in flight a warp),
staged in shared memory above that.  On a CUDA tensor :func:`fused_requant`
launches it or raises; on a CPU tensor it runs :func:`requant_plain`, the
same contract step for step:

    x  = f32(x);  ln: (x - mean) * rsqrt(mean((x - mean)^2) + eps)
                  gelu: x * sigmoid(1.702 x)
    xn = x * (1 / s)
    r  = max(rowmax |xn|, 1e-6) * (1 / 127)
    v  = xn * (1 / r);  v += (v >= 0 ? 0.5 : -0.5);  clip to +-127; truncate

Row scales come back as ``[..., 1]`` (the TPU kernel's ``[1, rows]`` lane
layout has no counterpart here).
"""

from __future__ import annotations

import torch

from . import _build

OPS = ("none", "ln", "gelu")
# above C = 1024 the kernel keeps 8 rows and the reciprocal scales in shared
# memory as f32
C_MAX = 4096


def norm_no_affine(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without the affine (the consumer's weights carry gamma and
    beta); two-pass statistics in f32 whatever ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def requant_rowdyn(x: torch.Tensor, s_ci: torch.Tensor):
    """f32 ``[..., C]`` -> (int8 ``[..., C]``, f32 row scale ``[..., 1]``):
    the static per-channel scale ``s_ci`` sets the channels' relative
    weight, the dynamic row scale stretches each row over the int8 range.
    Rounds half away from zero by +-0.5 and truncation (clipped first: a
    float -> int8 cast is only defined in range)."""
    xn = x * torch.reciprocal(s_ci)
    r = xn.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    v = xn * torch.reciprocal(r)
    v = v + torch.where(v >= 0, 0.5, -0.5)
    return v.clamp(-127.0, 127.0).to(torch.int8), r


def _check_op(op: str, ops=OPS) -> None:
    if op not in ops:
        raise ValueError(f"op must be one of {ops}; got {op!r}")


def requant_plain(x: torch.Tensor, s_ci: torch.Tensor, op: str = "none",
                  eps: float = 1e-5):
    """The kernel's contract in plain PyTorch (see the module docstring)."""
    _check_op(op)
    xf = x.float()
    if op == "ln":
        xf = norm_no_affine(xf, eps)
    elif op == "gelu":
        xf = quick_gelu(xf)
    return requant_rowdyn(xf, s_ci.float())


def _fused_requant_cuda(x, s_ci, op, eps):
    lead, c = x.shape[:-1], x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_requant takes f32 or bf16, not {x.dtype}")
    if c % 4 or not 4 <= c <= C_MAX:
        raise ValueError(f"fused_requant needs C % 4 == 0 and C <= {C_MAX}; "
                         f"got C={c}")
    if s_ci.shape != (c,) or s_ci.dtype != torch.float32 or (
            s_ci.device != x.device):
        raise ValueError(f"s_ci must be f32 [{c}] on {x.device}; got "
                         f"{s_ci.dtype} {tuple(s_ci.shape)} on {s_ci.device}")
    x2 = x.reshape(-1, c).contiguous()
    if x2.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        x2 = x2.clone()
    rows = x2.shape[0]
    q = torch.empty(rows, c, dtype=torch.int8, device=x.device)
    r = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    if rows:
        lib = _build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fused_requant(
                x2.data_ptr(), s_ci.contiguous().data_ptr(), q.data_ptr(),
                r.data_ptr(), rows, c, OPS.index(op), float(eps),
                int(x.dtype == torch.bfloat16), stream)
        _build.check(err, "fused_requant")
        fused_requant.launches += 1
    return q.reshape(*lead, c), r.reshape(*lead, 1)


def fused_requant(x: torch.Tensor, s_ci: torch.Tensor, op: str = "none",
                  eps: float = 1e-5):
    """K9: ``x [..., C]`` f32/bf16, ``s_ci [C]`` f32 -> (int8 ``[..., C]``,
    f32 ``[..., 1]``).  ``op``: ``"none"``, ``"ln"`` (unscaled LayerNorm
    first) or ``"gelu"`` (quickGELU in f32 first).  A CUDA tensor launches
    ``fused_requant`` (counted in ``fused_requant.launches``) or raises on
    a shape the kernel does not take; a CPU tensor runs
    :func:`requant_plain`."""
    _check_op(op)
    if x.is_cuda:
        return _fused_requant_cuda(x, s_ci, op, eps)
    return requant_plain(x, s_ci, op, eps)


fused_requant.launches = 0
