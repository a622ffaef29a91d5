"""CLIP Vision Transformer visual tower (counterpart of
``textreid_tpu/models/vit.py``): patchify conv, class token, learned
position embedding, pre-LN residual attention blocks, ``ln_post`` on the
class token, projection.

Parameters are plain tensors named in CLIP's layout (``conv1``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_post``, ``proj``), so a
CLIP ``visual.*`` subtree loads by renaming keys alone
(``utils/weight_convert.py:convert_clip_vit``).  The fused qkv projection
goes straight into ``ops.attention.attention``: K5 forward and K6 backward
on a CUDA tensor, their plain versions on the CPU.

Parameters stay in their own dtype (f32 masters when training) and are
cast to the input's dtype on use (``models/common.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.attention import attention
from ..parallel.mesh import from_model_parallel, to_model_parallel
from .common import conv2d, dense, layer_norm, linear


class _Attention(nn.Module):
    """Holder of CLIP's ``attn.*`` parameters (``nn.MultiheadAttention``
    names); the block reads them directly."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class TransformerBlock(nn.Module):
    """Pre-LN residual attention block; CLIP's QuickGELU MLP.

    ``tensor_parallel`` (set by ``parallel/mesh.py:shard_model`` under a
    model axis): the MLP holds this rank's ``4W / m`` columns of ``c_fc``
    and rows of ``c_proj``; ``ln_2``'s output enters through Megatron's
    *f*, the partial sum leaves through *g* (the model group's all-reduce)
    and ``c_proj``'s bias is added once, after it.  Attention stays
    replicated.  Off, the block is unchanged."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.tensor_parallel = False
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.ln_1)
        qkv = dense(h, self.attn.in_proj_weight,
                    self.attn.in_proj_bias)  # [B, S, 3W]
        x = x + linear(attention(qkv.contiguous(), self.heads, self.causal),
                       self.attn.out_proj)
        if self.tensor_parallel:
            return x + self._split_mlp(layer_norm(x, self.ln_2))
        h = linear(layer_norm(x, self.ln_2), self.mlp.c_fc)
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + linear(h, self.mlp.c_proj)

    def _split_mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(to_model_parallel(x), self.mlp.c_fc)
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        h = from_model_parallel(dense(h, self.mlp.c_proj.weight))
        return h + self.mlp.c_proj.bias.to(h.dtype)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            TransformerBlock(width, heads) for _ in range(layers))


class VisionTransformer(nn.Module):
    """NCHW pixels ``[B, 3, H, W]`` -> ``[B, output_dim]``."""

    def __init__(self, input_resolution: Tuple[int, int] = (224, 224),
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, output_dim: int = 512):
        super().__init__()
        self.patch_size = patch_size
        self.width = width
        self.layers = layers
        self.output_dim = output_dim
        self.grid = (input_resolution[0] // patch_size,
                     input_resolution[1] // patch_size)
        if min(self.grid) < 1:
            raise ValueError(
                f"input_resolution {tuple(input_resolution)} smaller than "
                f"patch_size {patch_size}: the {self.grid} patch grid is "
                "empty, so the tower would attend over the CLS token alone.")
        scale = width ** -0.5
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(self.grid[0] * self.grid[1] + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim))

    @property
    def out_channels(self) -> int:
        return self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = conv2d(x, self.conv1)  # stride patch_size, no padding
        x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, W], row-major grid
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = layer_norm(x, self.ln_pre)
        for block in self.transformer.resblocks:
            x = block(x)
        return layer_norm(x[:, 0], self.ln_post) @ self.proj.to(dtype)


VIT_SPECS = {
    "clip_vit_b32": dict(patch_size=32, width=768, layers=12, heads=12,
                         output_dim=512),
    "clip_vit_b16": dict(patch_size=16, width=768, layers=12, heads=12,
                         output_dim=512),
    "clip_vit_l14": dict(patch_size=14, width=1024, layers=24, heads=16,
                         output_dim=768),
}


def build_vit(cfg) -> VisionTransformer:
    """``MODEL.VISUAL_MODEL`` names a ``VIT_SPECS`` entry, or anything else
    takes the ``MODEL.VIT`` section.

    The ``TPU.FUSED_ATTENTION*`` keys pick among TPU lowerings that compute
    the same function (XLA, or the Pallas kernel in one of its block
    layouts), so they select nothing here: on a CUDA tensor every block
    runs K5 and K6, on a CPU tensor their plain versions."""
    name = cfg.MODEL.VISUAL_MODEL
    if name in VIT_SPECS:
        spec = dict(VIT_SPECS[name])
    else:
        spec = dict(patch_size=cfg.MODEL.VIT.PATCH_SIZE,
                    width=cfg.MODEL.VIT.WIDTH, layers=cfg.MODEL.VIT.LAYERS,
                    heads=cfg.MODEL.VIT.HEADS,
                    output_dim=cfg.MODEL.VIT.OUTPUT_DIM)
    return VisionTransformer(
        input_resolution=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH), **spec)
