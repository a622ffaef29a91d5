"""CLIP's modified ResNet (arXiv:2103.00020) as an image tower of the
reference: a three-convolution stem with an average pool, anti-aliased
bottlenecks (an average pool before each strided 1x1), and the attention
pool from the mean token (CLIP's ``query=x[:1]``), at the widths of
``MODEL.RESNET``.  BatchNorm in training normalises with the biased batch
variance (eps 1e-5) and leaves the running statistics unmoved; in
evaluation it reads them."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..layers import (
    Params,
    Precision,
    Spec,
    batch_norm,
    bn_of,
    conv,
    dense,
    linear,
)


def blocks(layers: Sequence[int], width: int, last_stride: int):
    """(stage, block, inplanes, planes, stride) of every bottleneck."""
    out, inplanes = [], width
    for stage, (mult, count, stride) in enumerate(
            [(1, layers[0], 1), (2, layers[1], 2), (4, layers[2], 2),
             (8, layers[3], last_stride)], start=1):
        planes = width * mult
        for block in range(count):
            out.append((stage, block, inplanes, planes,
                        stride if block == 0 else 1))
            inplanes = planes * 4
    return out


def grid(cfg: dict) -> Tuple[int, int]:
    down = 16 if cfg["MODEL"]["RESNET"]["RES5_STRIDE"] == 1 else 32
    return cfg["INPUT"]["HEIGHT"] // down, cfg["INPUT"]["WIDTH"] // down


def out_dim(cfg: dict) -> int:
    return cfg["MODEL"]["RESNET"]["OUTPUT_DIM"]


def spec(cfg: dict) -> Spec:
    r = cfg["MODEL"]["RESNET"]
    width = r["WIDTH"]
    v = "visual_model"
    out = [(f"{v}.conv1.weight", (width // 2, 3, 3, 3), "conv"),
           *bn_of(f"{v}.bn1", width // 2),
           (f"{v}.conv2.weight", (width // 2, width // 2, 3, 3), "conv"),
           *bn_of(f"{v}.bn2", width // 2),
           (f"{v}.conv3.weight", (width, width // 2, 3, 3), "conv"),
           *bn_of(f"{v}.bn3", width)]
    for stage, block, inplanes, planes, stride in blocks(
            r["LAYERS"], width, r["RES5_STRIDE"]):
        b = f"{v}.layer{stage}.{block}"
        out += [(f"{b}.conv1.weight", (planes, inplanes, 1, 1), "conv"),
                *bn_of(f"{b}.bn1", planes),
                (f"{b}.conv2.weight", (planes, planes, 3, 3), "conv"),
                *bn_of(f"{b}.bn2", planes),
                (f"{b}.conv3.weight", (planes * 4, planes, 1, 1), "conv"),
                *bn_of(f"{b}.bn3", planes * 4, "norm_residual")]
        if stride > 1 or inplanes != planes * 4:
            out += [(f"{b}.downsample.0.weight",
                     (planes * 4, inplanes, 1, 1), "conv"),
                    *bn_of(f"{b}.downsample.1", planes * 4)]
    c = width * 32
    gh, gw = grid(cfg)
    a = f"{v}.attnpool"
    out += [(f"{a}.positional_embedding", (gh * gw + 1, c), "embedding"),
            *linear(f"{a}.k_proj", c, c), *linear(f"{a}.q_proj", c, c),
            *linear(f"{a}.v_proj", c, c),
            *linear(f"{a}.c_proj", c, r["OUTPUT_DIM"])]
    return out


def _avg_pool(x, stride: int):
    return F.avg_pool2d(x, stride) if stride > 1 else x


def forward(P: Params, x: torch.Tensor, cfg: dict, train: bool,
            q: Precision, record: Optional[dict] = None) -> torch.Tensor:
    """The tower on normalised NCHW pixels.  ``record``: a dict that takes
    each BatchNorm's batch ``(mean, var)`` in training."""
    r = cfg["MODEL"]["RESNET"]
    v = "visual_model"

    def bn(t, name):
        return batch_norm(t, P, name, train, record)

    for i in (1, 2, 3):
        x = conv(x, P[f"{v}.conv{i}.weight"], q, 2 if i == 1 else 1, 1)
        x = F.relu(bn(x, f"{v}.bn{i}"))
    x = F.avg_pool2d(x, 2)
    for stage, block, inplanes, planes, stride in blocks(
            r["LAYERS"], r["WIDTH"], r["RES5_STRIDE"]):
        b = f"{v}.layer{stage}.{block}"
        out = F.relu(bn(conv(x, P[f"{b}.conv1.weight"], q), f"{b}.bn1"))
        out = F.relu(bn(conv(out, P[f"{b}.conv2.weight"], q, 1, 1),
                        f"{b}.bn2"))
        out = bn(conv(_avg_pool(out, stride), P[f"{b}.conv3.weight"], q),
                 f"{b}.bn3")
        identity = x
        if f"{b}.downsample.0.weight" in P:
            identity = bn(conv(_avg_pool(x, stride),
                               P[f"{b}.downsample.0.weight"], q),
                          f"{b}.downsample.1")
        x = F.relu(out + identity)
    return attention_pool(P, x, r["HEADS"], q)


@torch.no_grad()
def batch_statistics(P: Params, cfg: dict, x: torch.Tensor) -> dict:
    """Each BatchNorm's ``(mean, var)`` over the batch ``x`` (normalised
    NCHW pixels) in a training forward."""
    record: dict = {}
    forward(P, x, cfg, True, Precision(), record)
    return record


def attention_pool(P: Params, x: torch.Tensor, heads: int,
                   q: Precision) -> torch.Tensor:
    """Multi-head attention from the mean token over ``[mean, tokens]``
    with a learned position embedding, then the output projection."""
    a = "visual_model.attnpool"
    batch, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + P[f"{a}.positional_embedding"]
    n, hd = tokens.shape[1], c // heads
    query = dense(tokens[:, :1], P[f"{a}.q_proj.weight"],
                  P[f"{a}.q_proj.bias"], q)
    key = dense(tokens, P[f"{a}.k_proj.weight"], P[f"{a}.k_proj.bias"], q)
    value = dense(tokens, P[f"{a}.v_proj.weight"], P[f"{a}.v_proj.bias"], q)
    query = query.reshape(batch, 1, heads, hd).transpose(1, 2)
    key = key.reshape(batch, n, heads, hd).transpose(1, 2)
    value = value.reshape(batch, n, heads, hd).transpose(1, 2)
    scores = (q(query) @ q(key).transpose(-1, -2)) / math.sqrt(hd)
    out = q(torch.softmax(scores, dim=-1)) @ q(value)  # [B, h, 1, hd]
    out = out.transpose(1, 2).reshape(batch, c)
    return dense(out, P[f"{a}.c_proj.weight"], P[f"{a}.c_proj.bias"], q)


def _conv_ops(n, cout, ho, wo, cin, k):
    return 2 * n * cout * ho * wo * cin * k * k


def forward_ops(cfg: dict, n: int = 1) -> int:
    """Operations of ``n`` images' forward, counted from the shapes: 2 N Co
    Ho Wo Ci kh kw a convolution, 2 M N K a product; the attention pool
    attends from the mean token alone."""
    r = cfg["MODEL"]["RESNET"]
    width = r["WIDTH"]
    h, w = cfg["INPUT"]["HEIGHT"] // 2, cfg["INPUT"]["WIDTH"] // 2
    ops = (_conv_ops(n, width // 2, h, w, 3, 3)
           + _conv_ops(n, width // 2, h, w, width // 2, 3)
           + _conv_ops(n, width, h, w, width // 2, 3))
    h, w = h // 2, w // 2
    for _, _, inplanes, planes, stride in blocks(
            r["LAYERS"], width, r["RES5_STRIDE"]):
        ops += _conv_ops(n, planes, h, w, inplanes, 1)
        ops += _conv_ops(n, planes, h, w, planes, 3)
        ho, wo = h // stride, w // stride
        ops += _conv_ops(n, planes * 4, ho, wo, planes, 1)
        if stride > 1 or inplanes != planes * 4:
            ops += _conv_ops(n, planes * 4, ho, wo, inplanes, 1)
        h, w = ho, wo
    c = width * 32
    gh, gw = grid(cfg)
    tokens = gh * gw + 1
    # q from the mean token; k and v from all; scores and weighted sum;
    # the output projection
    ops += 2 * n * (c * c + 2 * tokens * c * c + 2 * tokens * c
                    + c * r["OUTPUT_DIM"])
    return ops
