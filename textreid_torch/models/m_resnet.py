"""CLIP Modified ResNet visual encoder (counterpart of
``textreid_tpu/models/m_resnet.py``).

* 3-conv stem with an average pool instead of a max pool;
* anti-aliased bottlenecks: an average pool precedes every strided
  projection;
* an attention pool that evaluates only the CLS query, with the k- and
  v-projections collapsed algebraically (see :class:`AttentionPool2d`);
* configurable res5 stride (``last_stride``).

Module and parameter names are CLIP's (``conv1``, ``bn1``, ``layer1.0``,
``downsample.{-1,0,1}``, ``attnpool.{q,k,v,c}_proj``), so a reference
state dict loads with ``load_state_dict``.  Convolutions are ``F.conv2d``
through cuDNN (the JAX package has no kernel of its own here).  Every
layer runs in the dtype of its input with its parameters cast on use
(``models/common.py``), so f32 masters train a bf16 tower; BatchNorm
(eps 1e-5) reads its running statistics in eval mode and, in train mode,
normalises with f32 batch statistics and updates the running ones as
``flax``'s ``BatchNorm(momentum=0.9)`` does (``common.batch_norm``).  The
tensor layout inside is NCHW; the model's public entry takes NHWC pixels
like the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, conv2d, linear


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _pool(stride: int) -> nn.Module:
    return nn.AvgPool2d(stride) if stride > 1 else nn.Identity()


class Bottleneck(nn.Module):
    """Anti-aliased CLIP bottleneck."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.avgpool = _pool(stride)
        self.conv3 = _conv(planes, out_planes, 1)
        self.bn3 = nn.BatchNorm2d(out_planes)
        self.downsample = None
        if stride > 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", _pool(stride)),
                ("0", _conv(inplanes, out_planes, 1)),
                ("1", nn.BatchNorm2d(out_planes)),
            ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = F.relu(batch_norm(conv2d(out, self.conv2), self.bn2))
        out = batch_norm(conv2d(self.avgpool(out), self.conv3), self.bn3)
        identity = x
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            identity = batch_norm(conv2d(pool(x), conv), bn)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """CLS-query attention pooling.

    Tokens are the flattened spatial features behind a prepended mean token,
    plus a learned position embedding.  One round of multi-head attention
    is evaluated for the CLS query only (the reference attends from every
    token and keeps the first output).  With one query the projections
    collapse: the k-path becomes ``q~ = Wk_h^T q_h`` per head, scored
    against the raw tokens (the bias adds a per-head constant), and the
    v-path averages the raw tokens under the attention weights before one
    projection (the weights sum to 1, so ``bv`` is added once).
    """

    def __init__(self, spacial_dim: Tuple[int, int], embed_dim: int,
                 num_heads: int, output_dim: Optional[int] = None):
        super().__init__()
        self.spacial_dim = tuple(spacial_dim)
        self.num_heads = num_heads
        n_tok = self.spacial_dim[0] * self.spacial_dim[1] + 1
        self.positional_embedding = nn.Parameter(
            torch.randn(n_tok, embed_dim) / embed_dim ** 0.5)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, c, h, w = x.shape
        if (h, w) != self.spacial_dim:
            raise ValueError(f"attention pool built for grid "
                             f"{self.spacial_dim}, got {(h, w)}")
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C], (h, w) order
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)

        heads = self.num_heads
        head_dim = c // heads
        q = linear(tokens[:, 0], self.q_proj).reshape(batch, heads, head_dim)
        q = q * head_dim ** -0.5
        dtype = tokens.dtype
        w_k = self.k_proj.weight.to(dtype).T.reshape(c, heads, head_dim)
        w_v = self.v_proj.weight.to(dtype).T.reshape(c, heads, head_dim)
        b_k = self.k_proj.bias.to(dtype).reshape(heads, head_dim)
        b_v = self.v_proj.bias.to(dtype).reshape(heads, head_dim)

        q_tilde = torch.einsum("bhd,chd->bhc", q, w_k)  # [B, H, C]
        score_bias = torch.einsum("bhd,hd->bh", q, b_k)
        scores = torch.einsum("bhc,bnc->bhn", q_tilde, tokens)
        attn = torch.softmax(scores + score_bias[..., None], dim=-1)
        pooled_tokens = torch.einsum("bhn,bnc->bhc", attn, tokens)
        pooled = torch.einsum("bhc,chd->bhd", pooled_tokens, w_v) + b_v
        return linear(pooled.reshape(batch, c), self.c_proj)


class ModifiedResNet(nn.Module):
    """CLIP's modified ResNet trunk + attention pool."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 last_stride: int = 1,
                 input_resolution: Tuple[int, int] = (224, 224),
                 width: int = 64):
        super().__init__()
        self.output_dim = output_dim
        self.conv1 = _conv(3, width // 2, 3, stride=2)
        self.bn1 = nn.BatchNorm2d(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3)
        self.bn2 = nn.BatchNorm2d(width // 2)
        self.conv3 = _conv(width // 2, width, 3)
        self.bn3 = nn.BatchNorm2d(width)
        self.avgpool = nn.AvgPool2d(2)

        inplanes = width
        for stage, (mult, blocks, stride) in enumerate(
                [(1, layers[0], 1), (2, layers[1], 2), (4, layers[2], 2),
                 (8, layers[3], last_stride)], start=1):
            planes = width * mult
            mods = []
            for block in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       stride if block == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*mods))

        down = 16 if last_stride == 1 else 32
        grid = (input_resolution[0] // down, input_resolution[1] // down)
        if min(grid) < 1:
            raise ValueError(
                f"input_resolution {tuple(input_resolution)} too small for "
                f"this trunk: it downsamples by {down}x, leaving an empty "
                f"{grid} final grid.")
        self.attnpool = AttentionPool2d(grid, width * 32, heads, output_dim)

    @property
    def out_channels(self) -> int:
        return self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, 3, H, W]`` normalized pixels -> ``[B, output_dim]``."""
        x = F.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        x = F.relu(batch_norm(conv2d(x, self.conv2), self.bn2))
        x = F.relu(batch_norm(conv2d(x, self.conv3), self.bn3))
        x = self.avgpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)


def build_m_resnet(cfg) -> ModifiedResNet:
    """RN50 (1024-d, 32 heads) or RN101 (512-d, 32 heads) at the config's
    input size and res5 stride."""
    spec = {"m_resnet50": ((3, 4, 6, 3), 1024), "m_resnet": ((3, 4, 6, 3), 1024),
            "m_resnet101": ((3, 4, 23, 3), 512)}
    if cfg.MODEL.VISUAL_MODEL not in spec:
        raise NotImplementedError(cfg.MODEL.VISUAL_MODEL)
    layers, out_dim = spec[cfg.MODEL.VISUAL_MODEL]
    return ModifiedResNet(layers, out_dim, heads=32,
                          last_stride=cfg.MODEL.RESNET.RES5_STRIDE,
                          input_resolution=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH))
