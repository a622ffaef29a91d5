"""CLIP's ViT (arXiv:2103.00020) as an image tower of the reference:
patchify convolution, class token, position embedding, pre-LN blocks
(multi-head attention, QuickGELU MLP), ``ln_post`` on the class token,
projection, at the widths of ``MODEL.VIT``."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..layers import Params, Precision, Spec, conv, dense, layer_norm, linear


def grid(cfg: dict) -> Tuple[int, int]:
    p = cfg["MODEL"]["VIT"]["PATCH_SIZE"]
    return cfg["INPUT"]["HEIGHT"] // p, cfg["INPUT"]["WIDTH"] // p


def out_dim(cfg: dict) -> int:
    return cfg["MODEL"]["VIT"]["OUTPUT_DIM"]


def spec(cfg: dict) -> Spec:
    t = cfg["MODEL"]["VIT"]
    w, p = t["WIDTH"], t["PATCH_SIZE"]
    gh, gw = grid(cfg)
    v = "visual_model"
    out = [(f"{v}.conv1.weight", (w, 3, p, p), "conv"),
           (f"{v}.class_embedding", (w,), "embedding"),
           (f"{v}.positional_embedding", (gh * gw + 1, w), "embedding"),
           (f"{v}.ln_pre.weight", (w,), "norm"),
           (f"{v}.ln_pre.bias", (w,), "bias")]
    for i in range(t["LAYERS"]):
        b = f"{v}.transformer.resblocks.{i}"
        out += [(f"{b}.ln_1.weight", (w,), "norm"),
                (f"{b}.ln_1.bias", (w,), "bias"),
                (f"{b}.attn.in_proj_weight", (3 * w, w), "matrix"),
                (f"{b}.attn.in_proj_bias", (3 * w,), "bias"),
                *linear(f"{b}.attn.out_proj", w, w),
                (f"{b}.ln_2.weight", (w,), "norm"),
                (f"{b}.ln_2.bias", (w,), "bias"),
                *linear(f"{b}.mlp.c_fc", w, 4 * w),
                *linear(f"{b}.mlp.c_proj", 4 * w, w)]
    out += [(f"{v}.ln_post.weight", (w,), "norm"),
            (f"{v}.ln_post.bias", (w,), "bias"),
            (f"{v}.proj", (w, t["OUTPUT_DIM"]), "matrix_t")]
    return out


def forward(P: Params, x: torch.Tensor, cfg: dict, train: bool,
            q: Precision) -> torch.Tensor:
    """The tower on normalised NCHW pixels (the same in training)."""
    t = cfg["MODEL"]["VIT"]
    v = "visual_model"
    heads, p = t["HEADS"], t["PATCH_SIZE"]
    x = conv(x, P[f"{v}.conv1.weight"], q, p).flatten(2).transpose(1, 2)
    cls = P[f"{v}.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + P[f"{v}.positional_embedding"]
    x = layer_norm(x, P, f"{v}.ln_pre")
    batch, seq, width = x.shape
    hd = width // heads
    for i in range(t["LAYERS"]):
        b = f"{v}.transformer.resblocks.{i}"
        qkv = dense(layer_norm(x, P, f"{b}.ln_1"),
                    P[f"{b}.attn.in_proj_weight"],
                    P[f"{b}.attn.in_proj_bias"], q)
        qh, kh, vh = (part.reshape(batch, seq, heads, hd).transpose(1, 2)
                      for part in qkv.split(width, dim=-1))
        scores = (q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(hd)
        att = q(torch.softmax(scores, dim=-1)) @ q(vh)
        att = att.transpose(1, 2).reshape(batch, seq, width)
        x = x + dense(att, P[f"{b}.attn.out_proj.weight"],
                      P[f"{b}.attn.out_proj.bias"], q)
        h = dense(layer_norm(x, P, f"{b}.ln_2"), P[f"{b}.mlp.c_fc.weight"],
                  P[f"{b}.mlp.c_fc.bias"], q)
        h = h * torch.sigmoid(1.702 * h)
        x = x + dense(h, P[f"{b}.mlp.c_proj.weight"],
                      P[f"{b}.mlp.c_proj.bias"], q)
    cls = layer_norm(x[:, 0], P, f"{v}.ln_post")
    return q(cls) @ q(P[f"{v}.proj"])


def forward_ops(cfg: dict, n: int = 1) -> int:
    """Operations of ``n`` images' forward, counted from the shapes."""
    t = cfg["MODEL"]["VIT"]
    width, p = t["WIDTH"], t["PATCH_SIZE"]
    gh, gw = grid(cfg)
    seq = gh * gw + 1
    ops = 2 * n * width * gh * gw * 3 * p * p
    block = (2 * seq * width * 3 * width + 2 * 2 * seq * seq * width
             + 2 * seq * width * width + 2 * 2 * seq * width * 4 * width)
    ops += n * t["LAYERS"] * block
    return ops + 2 * n * width * t["OUTPUT_DIM"]
