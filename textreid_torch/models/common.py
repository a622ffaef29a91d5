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


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """``bn`` over the channels of NCHW ``x``, in ``x``'s dtype.

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
    nothing reads it."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean.to(x.dtype),
                            bn.running_var.to(x.dtype),
                            bn.weight.to(x.dtype), bn.bias.to(x.dtype),
                            False, 0.0, bn.eps)
    out, mean, invstd = torch.native_batch_norm(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
    if getattr(bn, "stats_frozen", False):
        return out
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
        var = invstd.float().pow(-2).sub_(bn.eps).clamp_min_(0.0)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return out
