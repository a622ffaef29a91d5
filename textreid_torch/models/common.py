"""Layers applied with their parameters cast to the input's dtype.

The port keeps parameters in their own dtype (f32 masters when training)
and runs each tower in the dtype of the tensor it is handed, as ``flax``
modules with ``dtype=`` do in the JAX package.  The casts are
differentiable, so gradients reach the masters in f32.

:func:`batch_norm` in training follows ``flax.linen.BatchNorm``
(``momentum=0.9``, the JAX package's setting) rather than
``torch.nn.BatchNorm2d``: the batch statistics are f32 whatever the input
dtype, the scale and bias stay f32 inside the normalisation, and the
running variance moves towards the *biased* batch variance (torch's module
uses the unbiased one, ``n / (n - 1)`` larger).

:func:`running_stats_frozen` holds the running statistics still across a
forward that replays one already taken: ``TPU.REMAT``'s recompute in the
backward and the gradient-cache step's second pass.  In train mode the
output depends on the batch statistics alone, so the replay is exact.

:func:`conv2d` and :func:`dense` read :data:`INT8_CONVS` and
:data:`INT8_LINEARS`, the context variables that
``models/quant_tower.py``'s ``int8_convs`` and ``int8_linears`` set: inside
them a qualifying convolution or dense layer runs as an int8 product with
dynamic activation and static weight scales (the counterpart of the JAX
package's flax method interceptors)."""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import batch_norm_act, takes
from ..parallel.mesh import all_gather_stats, all_reduce_sum_, data_distributed

# the smallest kh kw cout of a convolution that runs in int8 (None: none
# does), and the smallest out_features of a dense layer that does; set by
# models/quant_tower.py's context managers
INT8_CONVS: contextvars.ContextVar = contextvars.ContextVar(
    "int8_convs", default=None)
INT8_LINEARS: contextvars.ContextVar = contextvars.ContextVar(
    "int8_linears", default=None)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` with the parameters cast to ``x``'s
    dtype; inside ``quant_tower.int8_linears`` an int8 product when
    ``weight`` has at least its ``min_out_features`` rows."""
    min_out = INT8_LINEARS.get()
    if min_out is not None and weight.shape[0] >= min_out:
        from .quant_tower import int8_dense

        return int8_dense(x, weight, bias)
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` with the weights cast to ``x``'s dtype (:func:`dense`)."""
    return dense(x, layer.weight, layer.bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``ln(x)`` with the affine parameters cast to ``x``'s dtype."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv(x)`` with the weight (and bias) cast to ``x``'s dtype; inside
    ``quant_tower.int8_convs`` an int8 convolution when ``conv`` has one
    group, no dilation, explicit padding and ``kh kw cout`` at least the
    threshold."""
    threshold = INT8_CONVS.get()
    if threshold is not None:
        kh, kw = conv.kernel_size
        if (conv.groups == 1 and tuple(conv.dilation) == (1, 1)
                and not isinstance(conv.padding, str)
                and kh * kw * conv.out_channels >= threshold):
            from .quant_tower import int8_conv

            y = int8_conv(x, conv.weight, conv.stride, conv.padding)
            return y if conv.bias is None else (
                y + conv.bias.to(y.dtype)[:, None, None])
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


@contextmanager
def running_stats_frozen(module: nn.Module):
    """Train-mode :func:`batch_norm` leaves the running statistics of
    every BatchNorm in ``module`` where they are while this is open (a
    flag on each BatchNorm, not on the thread: autograd runs a CUDA
    backward, and so a checkpoint's recompute, on a thread of its own).
    Nests."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [getattr(bn, "stats_frozen", False) for bn in bns]
    for bn in bns:
        bn.stats_frozen = True
    try:
        yield
    finally:
        for bn, value in zip(bns, saved):
            bn.stats_frozen = value


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn`` over the channels of NCHW ``x``, in ``x``'s dtype, then
    ``+ residual`` and the ReLU when asked: ``relu(bn(x) + residual)``.

    Train mode on a tensor the fused kernels take (``ops/batch_norm.py:
    takes``: CUDA, f32 or bf16, channels-last contiguous), outside a
    data-parallel group, runs E3 (``ops/batch_norm.py:batch_norm_act``): the
    statistics, the running update, the ReLU and the add in two launches
    each way, with the contract below.  Anything else takes the path below,
    then the add and the ReLU as separate ops.

    Eval mode normalises with the running statistics, every operand cast to
    ``x``'s dtype.  Train mode normalises with the batch statistics,
    computed in f32, and the f32 scale and bias (one fused
    ``native_batch_norm``, differentiable through the statistics), then
    moves the running statistics in place, under ``no_grad`` and in f32,
    as flax does: ``running = (1 - m) running + m batch`` with ``m =
    bn.momentum`` (0.1, flax's 0.9) and the biased batch variance, read
    back from the kernel's ``1 / sqrt(var + eps)``.  The key encoders run
    this too (their statistics move and are never read, as in the JAX
    step).  ``num_batches_tracked`` is left alone: with a fixed momentum
    nothing reads it.

    Inside a data-parallel group (``parallel/mesh.py``) train mode
    normalises with the statistics of the global batch, every data shard's
    rows (:class:`_GlobalBatchNorm`, over the data axes), as the JAX step
    does under a data mesh, and the running statistics move towards them;
    with one shard the path above, unchanged."""
    if bn.training and takes(x) and not data_distributed():
        return batch_norm_act(x, bn, relu, residual)
    out = _batch_norm(x, bn)
    if residual is not None:
        out = out + residual
    return F.relu(out) if relu else out


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    if not bn.training:
        return F.batch_norm(x, bn.running_mean.to(x.dtype),
                            bn.running_var.to(x.dtype),
                            bn.weight.to(x.dtype), bn.bias.to(x.dtype),
                            False, 0.0, bn.eps)
    if data_distributed():
        out, mean, var = _GlobalBatchNorm.apply(x, bn.weight, bn.bias,
                                                bn.eps)
    else:
        out, mean, invstd = torch.native_batch_norm(
            x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
        var = None
    if getattr(bn, "stats_frozen", False):
        return out
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
        if var is None:
            var = invstd.float().pow(-2).sub_(bn.eps).clamp_min_(0.0)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return out


def _channels(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-channel ``t [C]`` shaped to broadcast over ``x [N, C, ...]``."""
    return t.view((1, -1) + (1,) * (x.dim() - 2))


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of a data-parallel group.

    Forward: each rank's per-channel f32 mean and sum of squared
    deviations with its row count, gathered and merged by Chan et al.'s
    pairwise rule (no cancellation of ``E[x^2] - E[x]^2``); the biased
    variance.  Backward: ``sum dy`` and ``sum dy (x - mean)`` all-reduced
    for the input's gradient, the scale's and bias's gradients this rank's
    own sums (the step's gradient all-reduce adds the ranks').  On CUDA
    tensors PyTorch's fused synchronised-BatchNorm kernels do the passes
    over the activations (``torch.batch_norm_stats``, ``batch_norm_elemt``,
    ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``: one read
    for the statistics, one pass for the output, as ``native_batch_norm``);
    the CPU, which has none of them, runs the same in plain tensor math.
    Returns ``(out, mean, var)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        rows = x.numel() // x.shape[1]
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
            m2 = invstd.pow(-2).sub_(eps).clamp_min_(0.0).mul_(rows)
        else:
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dims)
            m2 = (xf - _channels(mean, x)).square().sum(dims)
        c = mean.numel()
        stats = all_gather_stats(torch.cat([mean, m2, mean.new_tensor([rows])]))
        means, m2s, counts = stats[:, :c], stats[:, c:2 * c], stats[:, -1]
        n = counts.sum()
        mean = (counts[:, None] * means).sum(0) / n
        var = (m2s.sum(0) + (counts[:, None] * (means - mean).square())
               .sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            out = ((xf - _channels(mean, x)) * _channels(invstd * weight, x)
                   + _channels(bias.float(), x)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, counts)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        dout = dout.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, d_weight, d_bias = \
                torch.batch_norm_backward_reduce(
                    dout, x, mean, invstd, weight, True,
                    ctx.needs_input_grad[1], ctx.needs_input_grad[2])
            total = all_reduce_sum_(torch.cat([sum_dy, sum_dy_xmu]))
            sum_dy, sum_dy_xmu = total.chunk(2)
            dx = torch.batch_norm_backward_elemt(
                dout, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                counts.to(torch.int32))
            return dx, d_weight, d_bias, None
        dims = [0] + list(range(2, x.dim()))
        n = counts.sum()
        dy = dout.float()
        x_hat = (x.float() - _channels(mean, x)) * _channels(invstd, x)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * x_hat).sum(dims)
        total = all_reduce_sum_(torch.cat([sum_dy, sum_dy_xhat]))
        g_dy, g_dy_xhat = total.chunk(2)
        dx = _channels(invstd * weight.float(), x) * (
            dy - _channels(g_dy / n, x) - x_hat * _channels(g_dy_xhat / n, x))
        return (dx.to(x.dtype),
                sum_dy_xhat if ctx.needs_input_grad[1] else None,
                sum_dy if ctx.needs_input_grad[2] else None, None)
