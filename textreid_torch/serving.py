"""Retrieval serving API (counterpart of ``textreid_tpu/serving.py``).

Build a gallery index once (encode + L2-normalize), then answer tokenized
text queries, or image queries, with the top-k gallery matches.  Ranking
runs the streaming top-k kernels (``ops/ranking.py``) for k <= 64 and a
materialising ``torch.matmul`` + ``torch.topk`` beyond, as the JAX package
leaves k > 64 to XLA.  With ``quantize=True`` the gallery is ranked from its
int8 form (``ops/quant.py``: a quarter of the bytes).  The index file format
(npz with ``gallery`` and ``meta``, plus ``quant_values`` and
``quant_scales`` from a quantized index) is the JAX package's, so an index
written by either package loads in the other.  The interface (``search``,
``search_by_image``, ``load_index``, ``gallery``, ``gallery_meta``) is what
``textreid_torch.server.RetrievalService`` drives.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .models.losses import l2_normalize
from .ops.quant import QuantizedGallery, quantize_rows, quantized_topk
from .ops.ranking import K_MAX, topk_similarity, topk_similarity_quantized

QUERY_BUCKET = 256  # search pads the query count to multiples of this


class RetrievalIndex:
    """An encoded, normalized gallery plus the query towers of ``model``.

    Serving needs packing-invariant text embeddings, so the text tower runs
    with the ``"always"`` zero-participation rule
    (``models.gru.masked_max_pool``) whatever the model's own rule."""

    def __init__(self, model, query_batch: int = 64, mesh=None,
                 quantize: bool = False, int8_encode=False,
                 image_query_batch: int = 8):
        if mesh is not None:
            raise NotImplementedError(
                "a gallery sharded over devices is not ported yet (ROADMAP "
                "Queue A: parallel/mesh.py -> torch.distributed)")
        if int8_encode:
            raise NotImplementedError(
                "int8 encoders are not ported yet (ROADMAP Queue A item 6: "
                "the int8 towers; Queue B K7-K9)")
        self.model = model
        # rank from the int8 form of the gallery (ops/quant.py)
        self.quantize = quantize
        self._quant_gallery: Optional[QuantizedGallery] = None
        self.device = next(model.parameters()).device
        self.query_batch = query_batch
        self.image_query_batch = image_query_batch
        self.gallery: Optional[torch.Tensor] = None  # [G, D] f32, normalized
        self.gallery_meta: Optional[np.ndarray] = None

    # -- encoders ---------------------------------------------------------
    def _embed_images(self, pixels: torch.Tensor) -> torch.Tensor:
        model = self.model
        emb = model.embed_image(model.encode_image(pixels))
        return l2_normalize(emb.float(), dim=1)

    def _embed_texts(self, token_ids: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        model = self.model
        feat = model.encode_text(token_ids, lengths, pool_mode="always")
        return l2_normalize(model.embed_text(feat).float(), dim=1)

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    # -- gallery ----------------------------------------------------------
    @torch.inference_mode()
    def build_gallery(self, batches, meta=None, valid_rows=None) -> None:
        """Encode an iterable of pixel batches ``[B, H, W, 3]`` (uint8 or
        normalized float) into the index.  ``valid_rows`` drops trailing
        rows after encoding (a caller's padded last batch), so a pad
        duplicate never enters the index."""
        chunks = [self._embed_images(self._to_device(b)) for b in batches]
        gallery = torch.cat(chunks, dim=0)
        if valid_rows is not None:
            gallery = gallery[:valid_rows]
        self.gallery = gallery
        self.gallery_meta = (np.asarray(meta)[: gallery.shape[0]]
                             if meta is not None
                             else np.arange(gallery.shape[0]))
        if self.quantize:
            self._quant_gallery = quantize_rows(gallery)

    def save_index(self, path: str) -> None:
        """Persist the gallery, its metadata and, from a quantized index,
        the int8 form (atomic replace)."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery first")
        payload = {"gallery": self.gallery.cpu().numpy(),
                   "meta": self.gallery_meta}
        if self.quantize:
            payload["quant_values"] = self._quant_gallery.values.cpu().numpy()
            payload["quant_scales"] = self._quant_gallery.scales.cpu().numpy()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    def load_index(self, path: str) -> None:
        """Load an index written by either package's ``save_index``,
        quantized or not.  A quantized instance reuses stored int8 rows
        whose shape matches the gallery and quantizes the gallery again
        otherwise.  Every member is read before the instance changes, so a
        failed load leaves the previous gallery serving."""
        with np.load(path) as data:
            meta = data["meta"]
            gallery = data["gallery"]
            stored = None
            if (self.quantize and "quant_values" in data
                    and data["quant_values"].shape == gallery.shape):
                stored = (data["quant_values"], data["quant_scales"])
        gallery = torch.as_tensor(gallery, dtype=torch.float32).to(self.device)
        quant = None
        if stored is not None:
            quant = QuantizedGallery(
                torch.as_tensor(stored[0], dtype=torch.int8).to(self.device),
                torch.as_tensor(stored[1],
                                dtype=torch.float32).to(self.device))
        elif self.quantize:
            quant = quantize_rows(gallery)
        self.gallery_meta = meta
        self.gallery = gallery
        self._quant_gallery = quant

    # -- queries ----------------------------------------------------------
    @torch.inference_mode()
    def encode_queries(self, token_ids: np.ndarray,
                       lengths: np.ndarray) -> np.ndarray:
        """Tokenized queries -> normalized embeddings ``[N, D]`` (numpy), at
        the fixed ``[query_batch, L]`` chunk shape."""
        n = token_ids.shape[0]
        bs = self.query_batch
        out = []
        for start in range(0, n, bs):
            ids = _pad_rows(token_ids[start:start + bs], bs, 0)
            lens = _pad_rows(lengths[start:start + bs], bs, 1)
            out.append(self._embed_texts(self._to_device(ids),
                                         self._to_device(lens)).cpu().numpy())
        return np.concatenate(out, axis=0)[:n]

    @torch.inference_mode()
    def encode_image_queries(self, pixels: np.ndarray) -> np.ndarray:
        """Pixel queries ``[N, H, W, 3]`` -> normalized embeddings
        ``[N, D]`` (numpy), at the fixed ``image_query_batch`` chunk."""
        pixels = np.asarray(pixels)
        n = pixels.shape[0]
        bs = self.image_query_batch
        out = [self._embed_images(self._to_device(
                   _pad_rows(pixels[s:s + bs], bs, 0))).cpu().numpy()
               for s in range(0, n, bs)]
        return np.concatenate(out, axis=0)[:n]

    def _rank(self, queries: torch.Tensor, k: int):
        if self.quantize:
            quant = self._quant_gallery
            if k <= K_MAX:
                return topk_similarity_quantized(
                    queries, quant.values, quant.scales, k=k)
            return quantized_topk(queries, quant,
                                  min(k, quant.values.shape[0]))
        if k <= K_MAX:
            return topk_similarity(queries, self.gallery, k=k)
        sim = queries @ self.gallery.T
        vals, idx = torch.topk(sim, min(k, self.gallery.shape[0]), dim=1)
        return vals, idx

    @torch.inference_mode()
    def search(self, token_ids: np.ndarray, lengths: np.ndarray,
               k: int = 10):
        """Top-k gallery matches for tokenized text queries: ``(scores
        [Q, k], meta [Q, k])``.  Slots beyond the real gallery carry score
        ``-inf`` and meta ``-1``.  The query count is padded to
        256-row buckets on the host, so the device sees a few fixed
        shapes."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery first")
        n_q = token_ids.shape[0]
        q_pad = -(-n_q // QUERY_BUCKET) * QUERY_BUCKET
        ids = _pad_rows(np.asarray(token_ids, np.int32), q_pad, 0)
        lens = _pad_rows(np.asarray(lengths, np.int32), q_pad, 1)
        queries = self._embed_texts(self._to_device(ids),
                                    self._to_device(lens))
        vals, idx = self._rank(queries, k)
        return self._finish(vals, idx, n_q, k)

    @torch.inference_mode()
    def search_by_image(self, pixels: np.ndarray, k: int = 10):
        """Top-k gallery matches for pixel queries ``[N, H, W, 3]`` (person
        re-identification by example); same return contract as
        :meth:`search`."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery first")
        n_q = np.asarray(pixels).shape[0]
        queries = self.encode_image_queries(pixels)
        q_pad = -(-n_q // QUERY_BUCKET) * QUERY_BUCKET
        vals, idx = self._rank(self._to_device(_pad_rows(queries, q_pad, 0)), k)
        return self._finish(vals, idx, n_q, k)

    def _finish(self, vals, idx, n_q: int, k: int):
        """Trim the bucket padding, pad k out to the request, and map rows
        to metadata with the sentinel contract (-inf score, -1 meta)."""
        n_real = len(self.gallery_meta)
        vals = vals[:n_q].cpu().numpy()
        idx = idx[:n_q].cpu().numpy()
        if vals.shape[1] < k:
            pad = ((0, 0), (0, k - vals.shape[1]))
            vals = np.pad(vals, pad, constant_values=-np.inf)
            idx = np.pad(idx, pad, constant_values=-1)
        valid = (idx >= 0) & (idx < n_real)
        vals = np.where(valid, vals, -np.inf)
        meta = np.where(valid,
                        self.gallery_meta[np.clip(idx, 0, n_real - 1)], -1)
        return vals, meta


def _pad_rows(x: np.ndarray, rows: int, fill) -> np.ndarray:
    """Pad ``x`` with ``fill`` rows up to ``rows`` (no-op when full)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
