"""Int8-dataflow CLIP text-transformer encoder (counterpart of
``textreid_tpu/models/int8_text.py``), the tower on the serving hot path:
every query pays one text forward.

The block machinery is ``models/int8_vit.py``'s (LN-affine folding,
two-level requantization through K9, int8 block matmuls, K7 or K8 for the
FFN).  What is specific to text:

* the input is a gather from the token table, kept at the tower dtype (one
  copy on the device: the float tower's own table when the dtypes agree);
* attention is causal;
* the head is ``ln_final`` at the end-of-text slot, then the projection;
* the FFN runs through K7 ``fused_int8_ffn`` by default (``fused_ffn`` on),
  where the ViT's default is K8;
* padding tokens need no mask: the dynamic scale is per token, and the
  causal mask keeps pad positions out of every valid token's attention.

Calibration batches are ``(token_ids [B, T], lengths [B])`` with the serving
query distribution, e.g. the dataset's captions (``tools/build_index
--text-calib-out``, ``tools/serve --int8-text-calib``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.requant import norm_no_affine
from .int8_vit import (Int8Tower, _ln_affine, accumulate_amax,
                       activation_scales, folded_block_float,
                       int8_block_apply, quantize_block, resolve_fused_ffn)
from .losses import l2_normalize
from .text_transformer import TextTransformer


def _eot(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``x [B, T, W]`` at each row's end-of-text slot."""
    batch, seq, _ = x.shape
    at = (lengths.long() - 1).clamp(0, seq - 1)
    return x[torch.arange(batch, device=x.device), at]


def folded_text_float(tt: TextTransformer, token_ids, lengths,
                      record: Optional[dict] = None) -> torch.Tensor:
    """Eval forward of the text transformer with every LN affine folded
    into its consumer (the module's forward, reassociated; f32), recording
    the per-channel abs-max at every quantization site."""
    seq = token_ids.shape[1]
    tt.check_length(seq)
    x = F.embedding(token_ids, tt.token_embedding.weight.float())
    x = x + tt.positional_embedding[:seq].float()
    for i, block in enumerate(tt.transformer.resblocks):
        x = folded_block_float(x, block, f"block_{i}.", record)
    x = _eot(_ln_affine(x, tt.ln_final), lengths)
    return x @ tt.text_projection.float()


@torch.no_grad()
def calibrate_text_amax(tt: TextTransformer,
                        batches) -> Dict[str, torch.Tensor]:
    """Per-channel abs-max at every quantized-matmul input over batches of
    ``(token_ids [B, T], lengths [B])``, the elementwise max across
    batches."""
    device = tt.text_projection.device
    acc: Dict[str, torch.Tensor] = {}
    for token_ids, lengths in batches:
        record: dict = {}
        folded_text_float(tt, torch.as_tensor(token_ids).long().to(device),
                          torch.as_tensor(lengths).to(device), record)
        accumulate_amax(acc, record)
    if not acc:
        raise ValueError("calibration needs at least one batch")
    return acc


@torch.no_grad()
def prepare_int8_text(tt: TextTransformer, amax: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> Int8Tower:
    """Fold the LN affines and the activation scales into the weights and
    quantize them per output channel (the ``int8_vit`` recipe)."""
    scales = activation_scales(amax)
    units: Dict[str, dict] = {}
    for i, block in enumerate(tt.transformer.resblocks):
        quantize_block(block, f"block_{i}.", scales, units)
    consts = {
        # the gather is bound by bytes: the table sits at the tower dtype,
        # which is also what the float tower reads
        "token": tt.token_embedding.weight.detach().to(dtype),
        "pos": tt.positional_embedding.detach().float(),
        "ln_final_scale": tt.ln_final.weight.detach().float(),
        "ln_final_bias": tt.ln_final.bias.detach().float(),
        "proj": tt.text_projection.detach().to(torch.bfloat16),
    }
    return Int8Tower(units=units, scales=scales, consts=consts, dtype=dtype)


@torch.no_grad()
def int8_text_apply(tt: TextTransformer, tower: Int8Tower, token_ids,
                    lengths, fused_ffn=None) -> torch.Tensor:
    """``token_ids [B, T]``, ``lengths [B]`` -> ``[B, output_dim]``.
    ``fused_ffn``: ``None`` takes this tower's default (on: K7), a bool
    forces it, anything else raises."""
    resolve_fused_ffn(fused_ffn, True)  # reject a bad value before any work
    seq = token_ids.shape[1]
    tt.check_length(seq)
    fdt = tower.dtype
    consts = tower.consts
    x = F.embedding(token_ids.long(), consts["token"]).to(fdt)
    x = x + consts["pos"][:seq].to(fdt)
    for i in range(tt.layers):
        x = int8_block_apply(x, tower, f"block_{i}.", tt.heads, causal=True,
                             fused_ffn=fused_ffn, fused_ffn_default=True)
    x = (norm_no_affine(x) * consts["ln_final_scale"]
         + consts["ln_final_bias"])
    return _eot(x, lengths).to(fdt) @ consts["proj"].to(fdt)


def build_int8_text_encoder(model, calib_batches):
    """Calibrate and prepare; returns ``(encode, tower)``, where
    ``encode(token_ids, lengths)`` gives normalized embeddings: a drop-in
    for ``serving.RetrievalIndex``'s text encoder."""
    textual = model.textual_model
    if not isinstance(textual, TextTransformer):
        raise NotImplementedError(
            f"the int8 text encoder needs a TextTransformer tower; got "
            f"{type(textual).__name__} (the bi-GRU has no block-matmul "
            "graph to quantize: its work is in the scan)")
    amax = calibrate_text_amax(textual, calib_batches)
    tower = prepare_int8_text(textual, amax, model.dtype)

    @torch.no_grad()
    def encode(token_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        feat = int8_text_apply(textual, tower, token_ids, lengths)
        return l2_normalize(model.embed_text(feat).float(), dim=1)

    return encode, tower
