"""Int8 convolutions and dense layers quantized where they are called
(counterpart of ``textreid_tpu/models/quant_tower.py``).

Inside :func:`int8_convs` every qualifying convolution that a tower runs
through ``models/common.py:conv2d`` executes as

    s_x = amax(|x|) / 127                    (dynamic, per tensor)
    s_w = amax(|w|, spatial + in) / 127      (static, per output channel)
    y   = conv_int8(round(x / s_x), round(w / s_w)) * (s_x s_w)  [+ bias]

with int32 accumulation (im2col and ``torch._int_mm`` on the card,
``ops/int8_conv.py:int8_conv2d``); :func:`int8_linears` does the same for
the dense layers run through ``common.dense`` / ``common.linear``.  The
rounding is ``torch.round`` (half to even) after a division, as the JAX
package's ``jnp.round``: not the int8-dataflow trunk's rule.  BatchNorm,
ReLU, the pools and the attention pool stay in the model's dtype.  The
context managers set ``contextvars`` that ``common.py`` reads: nothing is
patched, and another thread is not affected.

A convolution qualifies with one group, no dilation and ``kh kw cout`` at
least the threshold (``min_flops_per_byte``, the FLOPs a byte of activation
buys; 0 takes every convolution).  This is the int8 encoder for towers with
no int8-dataflow graph (the torchvision ResNets), and ``int8_encode=
"intercept"`` on any tower (``serving.py``).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..ops.int8_conv import K_MULTIPLE, flatten_weight, int8_conv2d, round_up
from ..ops.int8_mm import int_matmul
from .common import INT8_CONVS, INT8_LINEARS
from .losses import l2_normalize

# Quantize the convolutions with kh kw cout >= this: on CLIP RN50 every 3x3
# with >= 256 output channels and no 1x1; on the torchvision ResNet-50 also
# the 7x7 stem.  The JAX package's default.
SELECTIVE_THRESHOLD = 2304


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8)


def _dynamic_scale(xf: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(xf.abs().amax() / 127.0, 1e-8)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1),
              padding=(0, 0)) -> torch.Tensor:
    """Quantized NCHW convolution (``weight`` OIHW): dynamic per-tensor int8
    activations, static per-output-channel int8 weights, int32
    accumulation, float rescale; the output in ``x``'s dtype."""
    out_dtype = x.dtype
    xf = x.float()
    s_x = _dynamic_scale(xf)
    x_q = _quantize(xf, s_x)
    wf = weight.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    w_q = _quantize(wf, s_w[:, None, None, None])
    acc = int8_conv2d(x_q.permute(0, 2, 3, 1), flatten_weight(w_q),
                      tuple(weight.shape[2:]), stride, padding)
    y = acc.float() * (s_x * s_w)
    return y.to(out_dtype).permute(0, 3, 1, 2)


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias=None) -> torch.Tensor:
    """Quantized dense layer (``weight [out, in]``): dynamic per-tensor int8
    activations, static per-output-column int8 weights, int32
    accumulation, float rescale, ``+ bias`` in f32; the output in ``x``'s
    dtype."""
    out_dtype = x.dtype
    xf = x.float()
    s_x = _dynamic_scale(xf)
    x_q = _quantize(xf, s_x)
    wf = weight.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=1) / 127.0, 1e-12)
    w_q = _quantize(wf, s_w[:, None])  # [out, in], contiguous
    k, n = w_q.shape[1], w_q.shape[0]
    if k % K_MULTIPLE or n % K_MULTIPLE:  # torch._int_mm's multiples
        x_q = F.pad(x_q, (0, round_up(k) - k))
        w_q = F.pad(w_q, (0, round_up(k) - k, 0, round_up(n) - n))
    y = int_matmul(x_q, w_q.t())[..., :n].float() * (s_x * s_w)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@contextmanager
def int8_convs(min_flops_per_byte: float = 0.0):
    """Inside, ``common.conv2d`` runs every supported convolution with ``kh
    kw cout >= min_flops_per_byte`` as :func:`int8_conv`."""
    token = INT8_CONVS.set(min_flops_per_byte)
    try:
        yield
    finally:
        INT8_CONVS.reset(token)


@contextmanager
def int8_linears(min_out_features: int = 512):
    """Inside, ``common.dense`` runs every dense layer with at least
    ``min_out_features`` outputs as :func:`int8_dense` (for a ViT block:
    qkv, out_proj, c_fc and c_proj)."""
    token = INT8_LINEARS.set(min_out_features)
    try:
        yield
    finally:
        INT8_LINEARS.reset(token)


def int8_image_encoder(model, min_flops_per_byte: float = SELECTIVE_THRESHOLD):
    """``encode(pixels)``: NHWC pixels (uint8, or already normalized float)
    -> normalized embeddings, the model's image tower with its qualifying
    convolutions in int8: a drop-in for ``serving.RetrievalIndex``'s image
    encoder."""

    @torch.no_grad()
    def encode(pixels: torch.Tensor) -> torch.Tensor:
        with int8_convs(min_flops_per_byte):
            feat = model.encode_image(pixels)
        return l2_normalize(model.embed_image(feat).float(), dim=1)

    return encode
