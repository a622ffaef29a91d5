"""CLIP text-transformer textual tower (counterpart of
``textreid_tpu/models/text_transformer.py``): token embedding, learned
positional embedding, causally-masked pre-LN transformer, ``ln_final`` at the
end-of-text slot, linear projection.  ``MODEL.TEXTUAL_MODEL: "transformer"``.

Parameters carry CLIP's own names (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.{i}.*``, ``ln_final``,
``text_projection``), so the text half of a CLIP archive loads by renaming
alone (``utils/weight_convert.py:convert_clip_text``).  The blocks are the
ViT's (``models/vit.py:TransformerBlock``) with ``causal=True``: K5 on a
CUDA tensor, its plain version on the CPU.

The end-of-text feature is taken at ``clip(lengths - 1, 0, T - 1)``, the
pipeline's explicit lengths, not CLIP's ``argmax(token_ids)``.  Under the
causal mask that slot sees only the sample's own valid prefix, so the
embedding does not depend on the padding or on the batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import layer_norm
from .vit import TransformerBlock


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            TransformerBlock(width, heads, causal=True)
            for _ in range(layers))


class TextTransformer(nn.Module):
    """``(token_ids [B, T], lengths [B]) -> [B, output_dim]``: the contract
    of ``BiGRUEncoder``, so the model's ``encode_text`` serves either."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 output_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.width = width
        self.layers = layers
        self.heads = heads
        self.output_dim = output_dim
        # CLIP's init scales: tokens N(0, 0.02), positions N(0, 0.01),
        # projection N(0, width^-0.5)
        self.token_embedding = nn.Embedding(vocab_size, width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, width))
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(
            width ** -0.5 * torch.randn(width, output_dim))

    @property
    def out_channels(self) -> int:
        return self.output_dim

    def check_length(self, seq: int) -> None:
        if seq > self.context_length:
            raise ValueError(
                f"sequence length {seq} exceeds context_length "
                f"{self.context_length}: positions past the learned "
                "positional embedding would have no row.  Lower "
                "INPUT.MAX_TEXT_LENGTH or raise "
                "MODEL.TRANSFORMER.CONTEXT_LENGTH (convert_clip_text resizes "
                "the CLIP table by linear interpolation).")

    def forward(self, token_ids: torch.Tensor, lengths: torch.Tensor,
                pool_mode: Optional[str] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Computed in ``dtype`` (default: the parameters').  ``pool_mode``
        is the bi-GRU's pooling rule and selects nothing here: the causal
        mask already makes the embedding independent of the padding."""
        del pool_mode
        batch, seq = token_ids.shape
        self.check_length(seq)
        dtype = dtype or self.token_embedding.weight.dtype
        x = F.embedding(token_ids, self.token_embedding.weight).to(dtype)
        x = x + self.positional_embedding[:seq].to(dtype)
        for block in self.transformer.resblocks:
            x = block(x)
        x = layer_norm(x, self.ln_final)
        eot = (lengths.long() - 1).clamp(0, seq - 1)
        x = x[torch.arange(batch, device=x.device), eot]
        return x @ self.text_projection.to(dtype)


TEXT_TRANSFORMER_SPECS = {
    # the text halves of the published CLIP archives
    "clip_text_rn50": dict(width=512, layers=12, heads=8, output_dim=1024),
    "clip_text_rn101": dict(width=512, layers=12, heads=8, output_dim=512),
    "clip_text_b32": dict(width=512, layers=12, heads=8, output_dim=512),
    "clip_text_b16": dict(width=512, layers=12, heads=8, output_dim=512),
    "clip_text_l14": dict(width=768, layers=12, heads=12, output_dim=768),
}


def build_text_transformer(cfg) -> TextTransformer:
    """From the ``MODEL.TRANSFORMER`` section: a named preset
    (``MODEL.TRANSFORMER.ARCH``) or the explicit fields."""
    t = cfg.MODEL.TRANSFORMER
    if t.ARCH:
        if t.ARCH not in TEXT_TRANSFORMER_SPECS:
            raise KeyError(
                f"unknown MODEL.TRANSFORMER.ARCH {t.ARCH!r}; known: "
                f"{sorted(TEXT_TRANSFORMER_SPECS)} (or leave it empty and set "
                "WIDTH/LAYERS/HEADS/OUTPUT_DIM)")
        spec = dict(TEXT_TRANSFORMER_SPECS[t.ARCH])
    else:
        spec = dict(width=t.WIDTH, layers=t.LAYERS, heads=t.HEADS,
                    output_dim=t.OUTPUT_DIM)
    return TextTransformer(vocab_size=t.VOCAB_SIZE,
                           context_length=t.CONTEXT_LENGTH, **spec)
