"""E3: train-mode BatchNorm with the ReLU and the residual add after it,
over channels-last activations, forward and backward.

Replaces no TPU kernel: on the TPU flax's BatchNorm, its ReLU and the
bottleneck's add are XLA fusions.  On the card eager PyTorch ran about ten
launches a BatchNorm (``native_batch_norm``, seven f32 ops for flax's running
update, the ReLU, the add) and four passes over the activation; the kernels
(``csrc/batch_norm.cu``) make two launches each way.  The contract, on the
``[rows, C]`` view of an NHWC tensor, the statistics and every sum in f32:

    stats:   mean, biased var; invstd = rsqrt(var + eps); a = weight invstd,
             b = bias - mean a; unless frozen, running = (1 - m) running
             + m batch (the biased variance, as flax; ``m = bn.momentum``)
    apply:   y = relu(x a + b [+ residual]), rounded once to x's dtype
    reduce:  g = dy [mask]; d bias = sum g, d weight = invstd sum g (x - mean)
    elemt:   dx = a (g - sum g / n - (x - mean) invstd^2 sum g (x - mean) / n)

The mask is ``x a + b > 0``, recomputed from x, without a residual, and
``y > 0`` with one (the next convolution holds y already): nothing is saved
that the eager graph did not hold.  With a residual and the ReLU, the elemt
pass also writes g, the identity branch's gradient.

:func:`batch_norm_act` is the entry ``models/common.py:batch_norm`` takes in
train mode when :func:`takes` holds and no data-parallel group is open: under
autograd the :class:`_BatchNormAct` function, without it (the key tower, under
``no_grad``) the two forward launches alone.  Each launching entry point
counts its launches (``bn_fw_stats.launches`` and so on); a CUDA tensor
launches or raises, a CPU tensor runs the plain version (``stats_plain``,
``apply_plain``, ``reduce_plain``, ``elemt_plain``), which launches nothing.
The kernels keep no float atomics, so two identical calls are bit-equal (the
gradient-cache step and ``TPU.REMAT`` replay a forward).  Their workspace is
one a device and serves one stream at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_F32, _BF16 = torch.float32, torch.bfloat16
DTYPES = (_F32, _BF16)
# the widest C the kernels' workspace holds (csrc/batch_norm.cu refuses more)
C_MAX = 65536
_CL = torch.channels_last
_WORKSPACE: dict = {}  # device index -> the zeroed int32 workspace


def _c(v: torch.Tensor) -> torch.Tensor:
    """Per-channel ``[C]`` shaped to broadcast over ``[N, C, H, W]``."""
    return v.view(1, -1, 1, 1)


def stats_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float):
    """f32 ``[4, C]`` (mean, invstd, a, b) of ``x [N, C, H, W]``, and the
    biased variance: two-pass, in f32 whatever ``x``'s dtype."""
    dims = (0, 2, 3)
    xf = x.float()
    mean = xf.mean(dims)
    var = (xf - _c(mean)).square().mean(dims)
    invstd = torch.rsqrt(var + eps)
    a = weight.float() * invstd
    return torch.stack([mean, invstd, a, bias.float() - mean * a]), var


def apply_plain(x: torch.Tensor, stats: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(x a + b [+ residual])`` in f32, rounded once to ``x``'s dtype
    (the kernel's operations in its order: equal bit for bit)."""
    pre = x.float() * _c(stats[2]) + _c(stats[3])
    if residual is not None:
        pre = pre + residual.float()
    return (pre.clamp_min(0.0) if relu else pre).to(x.dtype)


def running_update_plain(bn: torch.nn.Module, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """``running = (1 - m) running + m batch`` in place, as
    ``models/common.py`` moves them (the biased variance)."""
    m = bn.momentum
    bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
    bn.running_var.mul_(1.0 - m).add_(var, alpha=m)


def _masked(dy, x, y, stats, relu):
    g = dy.float()
    if relu:
        pre = (y.float() if y is not None
               else x.float() * _c(stats[2]) + _c(stats[3]))
        g = torch.where(pre > 0, g, 0.0)
    return g


def reduce_plain(dy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
                 stats: torch.Tensor, relu: bool) -> torch.Tensor:
    """f32 ``[4, C]``: d weight, d bias, ``sum g / n``, ``invstd^2 sum g (x -
    mean) / n``; the mask from ``y`` when given, else from ``x``."""
    dims = (0, 2, 3)
    g = _masked(dy, x, y, stats, relu)
    s1 = g.sum(dims)
    s2 = (g * (x.float() - _c(stats[0]))).sum(dims)
    n = x.numel() // x.shape[1]
    invstd = stats[1]
    return torch.stack([s2 * invstd, s1, s1 / n, invstd * invstd * s2 / n])


def elemt_plain(dy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
                stats: torch.Tensor, grads: torch.Tensor, relu: bool):
    """``(dx, g)`` in ``x``'s dtype from :func:`reduce_plain`'s ``grads``."""
    g = _masked(dy, x, y, stats, relu)
    dx = _c(stats[2]) * (g - _c(grads[2])
                         - (x.float() - _c(stats[0])) * _c(grads[3]))
    return dx.to(x.dtype), g.to(dy.dtype)


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x``: a non-empty CUDA ``[N, C, H, W]`` in
    f32 or bf16, channels-last contiguous at a 16-byte aligned address, C a
    multiple of one 16-byte access (8 bf16, 4 f32) and at most ``C_MAX``,
    fewer than 2^31 rows.  Every ResNet's C is such a multiple; any other
    keeps ``models/common.py``'s eager path."""
    return (x.is_cuda and x.dtype in DTYPES and x.dim() == 4
            and x.numel() > 0 and x.is_contiguous(memory_format=_CL)
            and x.shape[1] % (16 // x.element_size()) == 0
            and x.data_ptr() % 16 == 0
            and x.shape[1] <= C_MAX and x.numel() // x.shape[1] < 2 ** 31)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` channels-last contiguous at a 16-byte aligned address (a copy
    only where it is not: the kernels' 16-byte accesses need both)."""
    t = t.contiguous(memory_format=_CL)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=_CL)


def _workspace(dev: int) -> int:
    """Address of device ``dev``'s workspace: the kernels' ticket counters
    (zeroed here once; each launch's last blocks reset theirs) and
    partials."""
    buf = _WORKSPACE.get(dev)
    if buf is None:
        buf = torch.zeros(_build.library().bn_workspace_words(),
                          dtype=torch.int32, device=f"cuda:{dev}")
        _WORKSPACE[dev] = buf
    return buf.data_ptr()


def _launch(dev: int, entry, name: str, *args) -> None:
    """``entry(*args, stream)`` on device ``dev`` (made current only if it
    is not) and its current stream; raises on a refused launch."""
    if dev == torch.cuda.current_device():
        err = entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(err, name)


def _check(t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    if (t.shape != like.shape or t.dtype is not like.dtype
            or t.get_device() != like.get_device()
            or not t.is_contiguous(memory_format=_CL)):
        raise ValueError(
            f"{what} must be a channels-last {like.dtype} "
            f"{tuple(like.shape)} on {like.device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _check_vector(t: torch.Tensor, c: int, dev: int, what: str) -> None:
    if (t.dtype is not _F32 or t.numel() != c or t.get_device() != dev
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be f32 [{c}] on cuda:{dev}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stats(x, weight, bias, bn) -> torch.Tensor:
    """bn_fw_stats's launch on ``x`` as :func:`takes` holds it."""
    c, dev = x.shape[1], x.get_device()
    if weight.dtype is not _F32:
        weight = weight.float()
    if bias.dtype is not _F32:
        bias = bias.float()
    rm, rv = bn.running_mean, bn.running_var
    _check_vector(weight, c, dev, "weight")
    _check_vector(bias, c, dev, "bias")
    _check_vector(rm, c, dev, "running_mean")
    _check_vector(rv, c, dev, "running_var")
    stats = torch.empty((4, c), dtype=_F32, device=x.device)
    _launch(dev, _build.library().bn_fw_stats, "bn_fw_stats", x.data_ptr(),
            int(x.dtype is _BF16), x.numel() // c, c, weight.data_ptr(), bias.data_ptr(), rm.data_ptr(), rv.data_ptr(),
            float(bn.momentum), float(bn.eps),
            int(not getattr(bn, "stats_frozen", False)), stats.data_ptr(),
            _workspace(dev))
    bn_fw_stats.launches += 1
    return stats


def _apply(x, stats, relu, residual) -> torch.Tensor:
    """bn_fw_apply's launch on ``x`` as :func:`takes` holds it."""
    if residual is not None:
        residual = _aligned(residual)
        _check(residual, x, "residual")
    c = x.shape[1]
    y = torch.empty_like(x)
    _launch(x.get_device(), _build.library().bn_fw_apply, "bn_fw_apply",
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), int(x.dtype is _BF16), x.numel() // c, c,
            stats.data_ptr(), int(relu))
    bn_fw_apply.launches += 1
    return y


def _refuse(x: torch.Tensor, name: str) -> None:
    if not takes(x):
        raise ValueError(
            f"{name} takes a non-empty channels-last f32 or bf16 [N, C, H, "
            f"W] at a 16-byte aligned address, with C a multiple of 8 (bf16) "
            f"or 4 (f32) and at most {C_MAX}; got {x.dtype} "
            f"{tuple(x.shape)}, strides {x.stride()}")


def bn_fw_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                bn: torch.nn.Module) -> torch.Tensor:
    """f32 ``[4, C]`` (mean, invstd, a, b) of ``x``'s batch; moves ``bn``'s
    running statistics unless ``bn.stats_frozen``.  A CUDA tensor launches
    ``bn_fw_stats`` (counted in ``bn_fw_stats.launches``) or raises on what
    :func:`takes` refuses; a CPU tensor runs :func:`stats_plain`."""
    if not x.is_cuda:
        stats, var = stats_plain(x, weight, bias, bn.eps)
        if not getattr(bn, "stats_frozen", False):
            with torch.no_grad():
                running_update_plain(bn, stats[0], var)
        return stats
    _refuse(x, "bn_fw_stats")
    return _stats(x, weight, bias, bn)


def bn_fw_apply(x: torch.Tensor, stats: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(x a + b [+ residual])`` with ``stats`` from
    :func:`bn_fw_stats`.  A CUDA tensor launches ``bn_fw_apply`` (counted in
    ``bn_fw_apply.launches``); a CPU tensor runs :func:`apply_plain`."""
    if not x.is_cuda:
        return apply_plain(x, stats, relu, residual)
    _refuse(x, "bn_fw_apply")
    return _apply(x, stats, relu, residual)


def bn_bw_reduce(dy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
                 stats: torch.Tensor, relu: bool) -> torch.Tensor:
    """f32 ``[4, C]``: d weight, d bias and the two terms of
    :func:`bn_bw_elemt`; the ReLU's mask from ``y`` when given, else from
    ``x``.  A CUDA tensor launches ``bn_bw_reduce`` (counted in
    ``bn_bw_reduce.launches``); a CPU tensor runs :func:`reduce_plain`."""
    if not x.is_cuda:
        return reduce_plain(dy, x, y, stats, relu)
    _check(dy, x, "dy")
    if y is not None:
        _check(y, x, "y")
    c, dev = x.shape[1], x.get_device()
    grads = torch.empty((4, c), dtype=_F32, device=x.device)
    _launch(dev, _build.library().bn_bw_reduce, "bn_bw_reduce",
            dy.data_ptr(), x.data_ptr(), None if y is None else y.data_ptr(),
            int(x.dtype is _BF16), x.numel() // c, c, stats.data_ptr(),
            int(relu), grads.data_ptr(), _workspace(dev))
    bn_bw_reduce.launches += 1
    return grads


def bn_bw_elemt(dy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
                stats: torch.Tensor, grads: torch.Tensor, relu: bool,
                want_dx: bool = True, want_g: bool = False):
    """``(dx, g)``: the input's gradient and the masked ``g`` (the
    residual's gradient), each None unless wanted.  A CUDA tensor launches
    ``bn_bw_elemt`` (counted in ``bn_bw_elemt.launches``); a CPU tensor runs
    :func:`elemt_plain`."""
    if not x.is_cuda:
        dx, g = elemt_plain(dy, x, y, stats, grads, relu)
        return dx if want_dx else None, g if want_g else None
    _check(dy, x, "dy")
    if y is not None:
        _check(y, x, "y")
    c = x.shape[1]
    dx = torch.empty_like(x) if want_dx else None
    g = torch.empty_like(x) if want_g else None
    _launch(x.get_device(), _build.library().bn_bw_elemt, "bn_bw_elemt",
            dy.data_ptr(), x.data_ptr(), None if y is None else y.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if g is None else g.data_ptr(), int(x.dtype is _BF16),
            x.numel() // c, c, stats.data_ptr(), grads.data_ptr(), int(relu))
    bn_bw_elemt.launches += 1
    return dx, g


bn_fw_stats.launches = 0
bn_fw_apply.launches = 0
bn_bw_reduce.launches = 0
bn_bw_elemt.launches = 0


class _BatchNormAct(torch.autograd.Function):
    """``relu(bn(x) [+ residual])`` in train mode: two launches forward,
    two backward.  Saves x and the statistics, and y where the mask is read
    from it (a residual and the ReLU)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, bn, relu):
        stats, y = _forward(x, weight, bias, bn, relu, residual)
        ctx.relu, ctx.residual = relu, residual is not None
        ctx.save_for_backward(x, y if relu and ctx.residual else None, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, stats = ctx.saved_tensors
        if dy.is_cuda:
            dy = _aligned(dy)
        grads = bn_bw_reduce(dy, x, y, stats, ctx.relu)
        want_dx = ctx.needs_input_grad[0]
        want_res = ctx.residual and ctx.needs_input_grad[3]
        dx = g = None
        if want_dx or (want_res and ctx.relu):
            dx, g = bn_bw_elemt(dy, x, y, stats, grads, ctx.relu, want_dx,
                                want_res and ctx.relu)
        dres = (g if ctx.relu else dy) if want_res else None
        return dx, grads[0], grads[1], dres, None, None


def batch_norm_act(x: torch.Tensor, bn: torch.nn.Module, relu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(bn(x) [+ residual])`` with ``bn`` in train mode (the batch's
    statistics; the running ones move unless ``bn.stats_frozen``): through
    :class:`_BatchNormAct` when autograd records, else the two forward
    launches alone."""
    weight, bias = bn.weight, bn.bias
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad
            or (residual is not None and residual.requires_grad)):
        return _BatchNormAct.apply(x, weight, bias, residual, bn, relu)
    return _forward(x, weight, bias, bn, relu, residual)[1]


def _forward(x, weight, bias, bn, relu, residual):
    """``(stats, y)``: the two forward launches on a CUDA ``x`` that
    :func:`takes` holds (``models/common.py`` checked it), the plain
    version on a CPU one."""
    if not x.is_cuda:
        stats = bn_fw_stats(x, weight, bias, bn)
        return stats, apply_plain(x, stats, relu, residual)
    stats = _stats(x, weight, bias, bn)
    return stats, _apply(x, stats, relu, residual)
