"""Layers applied with their parameters cast to the input's dtype.

The port keeps parameters in their own dtype (f32 masters when training)
and runs each tower in the dtype of the tensor it is handed, as ``flax``
modules with ``dtype=`` do in the JAX package.  The casts are
differentiable, so gradients reach the masters in f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` with the weights cast to ``x``'s dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``ln(x)`` with the affine parameters cast to ``x``'s dtype."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)
