"""Int8 gallery quantization for large-scale retrieval (counterpart of
``textreid_tpu/ops/quant.py``).

Per-row symmetric int8 with one float32 scale per row: a quarter of the
float32 gallery's bytes.  Cosine ranking is scale-invariant per query, so
the order survives up to rounding: ``score = (q @ int8_g.T) * g_scale``.
:func:`quantized_scores` is the contract of the streaming int8 top-k kernel
(``ops/ranking.py:topk_similarity_quantized``).  Plain tensor math; used by
``serving.RetrievalIndex(quantize=True)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedGallery(NamedTuple):
    values: torch.Tensor  # [G, D] int8
    scales: torch.Tensor  # [G] float32 (per-row max-abs / 127)


def quantize_rows(embeddings: torch.Tensor) -> QuantizedGallery:
    """Per-row symmetric int8 quantization of (normalized) embeddings;
    ``round`` is to nearest even, as in the JAX package."""
    embeddings = embeddings.float()
    abs_max = embeddings.abs().amax(dim=1, keepdim=True)
    scale = abs_max.clamp_min(1e-8) / 127.0
    q = torch.round(embeddings / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedGallery(values=q, scales=scale[:, 0])


def dequantize_rows(gallery: QuantizedGallery) -> torch.Tensor:
    return gallery.values.float() * gallery.scales[:, None]


def quantized_scores(queries: torch.Tensor,
                     gallery: QuantizedGallery) -> torch.Tensor:
    """``[Q, D]`` x int8 ``[G, D]`` -> ``[Q, G]`` float32 similarity: the
    queries rounded to bfloat16, the int8 values as they are (exact in
    bfloat16), float32 accumulation, and the per-row scale multiplied in
    afterwards."""
    q = queries.to(torch.bfloat16).float()
    raw = q @ gallery.values.float().T
    return raw * gallery.scales[None, :]


def quantized_topk(queries: torch.Tensor, gallery: QuantizedGallery, k: int):
    """Materialising top-k of :func:`quantized_scores` (any k)."""
    return torch.topk(quantized_scores(queries, gallery), k, dim=1)
