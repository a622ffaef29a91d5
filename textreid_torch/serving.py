"""Retrieval serving API (counterpart of ``textreid_tpu/serving.py``).

Build a gallery index once (encode + L2-normalize), then answer tokenized
text queries, or image queries, with the top-k gallery matches.  Ranking
runs the streaming top-k kernels (``ops/ranking.py``) for k <= 64 and a
materialising ``torch.matmul`` + ``torch.topk`` beyond, as the JAX package
leaves k > 64 to XLA.  With ``quantize=True`` the gallery is ranked from its
int8 form (``ops/quant.py``: a quarter of the bytes).  With
``int8_encode=True`` (or ``"dataflow"``) a CLIP ModifiedResNet tower encodes
the gallery (and image queries) through its int8-dataflow trunk
(``models/int8_tower.py``) and a ViT through its int8-dataflow form
(``models/int8_vit.py``), each calibrated on the first gallery batches; any
other tower (the torchvision ResNets) with ``True``, and every tower with
``"intercept"``, through the per-convolution interceptor
(``models/quant_tower.py``), as the JAX package routes them.
:meth:`RetrievalIndex.enable_int8_text` does the same for a
text-transformer query tower (``models/int8_text.py``).  The index
file format (npz with ``gallery`` and ``meta``, plus ``quant_values`` and
``quant_scales`` from a quantized index) is the JAX package's, so an index
written by either package loads in the other, the JAX package's legacy
``augmented`` files too.  The kernels rank any embedding width: a gallery
whose width is off their multiple is padded with zero columns once, when
it is built or loaded, and the queries on each call (``ops/ranking.py``).
The interface (``search``, ``search_by_image``, ``load_index``,
``gallery``, ``gallery_meta``) is what
``textreid_torch.server.RetrievalService`` drives.

With ``mesh=`` (``parallel/mesh.py:make_mesh`` over this process's cards,
a card may repeat) the gallery is ranked in shards, one a device of the
mesh's data axis, replicated over a model axis as JAX's (``evaluation/
retrieval.py``: K2 or K4 a shard, then the global merge); on a
process-group mesh each rank holds its own shard and every rank gets the
global reply; as the JAX package's mesh index: a gallery the shards do not
divide is padded with an augmented column (real rows ``[g, 0]``, pad rows
``[0, -2]``, queries ``[q, 1]``: a pad row scores -2, below any cosine),
and the int8 form quantizes the augmented matrix.  ``gallery`` and
``save_index`` keep the clean ``[G, D]`` matrix; replies equal the
unsharded index's.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

import numpy as np
import torch

from .models.losses import l2_normalize
from .ops.quant import QuantizedGallery, quantize_rows, quantized_topk
from .ops.ranking import (
    COLUMN_MULTIPLE,
    K_MAX,
    pad_columns,
    topk_similarity,
    topk_similarity_quantized,
)


class RetrievalIndex:
    """An encoded, normalized gallery plus the query towers of ``model``.

    Serving needs packing-invariant text embeddings, so the text tower runs
    with the ``"always"`` zero-participation rule
    (``models.gru.masked_max_pool``) whatever the model's own rule."""

    def __init__(self, model, query_batch: int = 64, mesh=None,
                 quantize: bool = False, int8_encode=False,
                 image_query_batch: int = 8):
        self.model = model
        self.mesh = mesh
        # the mesh's shards of the (augmented) gallery or its int8 form, and
        # whether the augmented column is there (_finalize_mesh_gallery)
        self._mesh_shards: Optional[list] = None
        self._augmented = False
        # int8_encode: True or "dataflow" runs the int8-dataflow graph of a
        # ModifiedResNet or ViT tower, calibrated on the first gallery
        # batches; "intercept", or True on any other tower, the interceptor
        self._int8_pending = False
        # (encode function, prepared tower) of each int8 encoder, once built
        self._int8_image_encoder = self._int8_image_tower = None
        self._int8_text_encoder = self._int8_text_tower = None
        if int8_encode:
            from .models.m_resnet import ModifiedResNet
            from .models.vit import VisionTransformer

            mode = "dataflow" if int8_encode is True else int8_encode
            if mode not in ("dataflow", "intercept"):
                raise ValueError(f"int8_encode must be True, 'dataflow' or "
                                 f"'intercept'; got {int8_encode!r}")
            if mode == "dataflow" and isinstance(
                    model.visual_model, (ModifiedResNet, VisionTransformer)):
                self._int8_pending = True  # calibrate in build_gallery
            else:
                from .models.quant_tower import int8_image_encoder

                self._int8_image_encoder = int8_image_encoder(model)
        # rank from the int8 form of the gallery (ops/quant.py)
        self.quantize = quantize
        self._quant_gallery: Optional[QuantizedGallery] = None
        self.device = next(model.parameters()).device
        self.query_batch = query_batch
        self.image_query_batch = image_query_batch
        self.gallery: Optional[torch.Tensor] = None  # [G, D] f32, normalized
        self.gallery_meta: Optional[np.ndarray] = None
        # (what the kernel ranks, the same padded for it)
        self._padded: tuple = (None, None)

    def _kernel_gallery(self) -> torch.Tensor:
        """What the kernel ranks, the gallery or (``quantize``) its int8
        values, padded with zero columns to the kernel's multiple of D (the
        same tensor when D is one): made once for each gallery the index
        holds."""
        source = (self._quant_gallery.values if self.quantize
                  else self.gallery)
        if self._padded[0] is not source:
            self._padded = (source, pad_columns(source, COLUMN_MULTIPLE[
                "int8" if self.quantize else "f32"]))
        return self._padded[1]

    # -- encoders ---------------------------------------------------------
    def _embed_images(self, pixels: torch.Tensor) -> torch.Tensor:
        if self._int8_image_encoder is not None:
            return self._int8_image_encoder(pixels)
        model = self.model  # also before an int8 tower's calibration
        emb = model.embed_image(model.encode_image(pixels))
        return l2_normalize(emb.float(), dim=1)

    def _embed_texts(self, token_ids: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        if self._int8_text_encoder is not None:
            return self._int8_text_encoder(token_ids, lengths)
        model = self.model
        feat = model.encode_text(token_ids, lengths, pool_mode="always")
        return l2_normalize(model.embed_text(feat).float(), dim=1)

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    @torch.inference_mode()
    def enable_int8_text(self, calib_batches) -> None:
        """Swap the query text encoder to the int8-dataflow text transformer
        (``models/int8_text.py``), calibrated on ``calib_batches``: an
        iterable of ``(token_ids [B, T], lengths [B])`` with the serving
        query distribution (e.g. dataset captions).  The textual tower must
        be a ``TextTransformer`` (``NotImplementedError`` for the
        bi-GRU)."""
        from .models.int8_text import build_int8_text_encoder

        self._int8_text_encoder, self._int8_text_tower = \
            build_int8_text_encoder(self.model, calib_batches)

    def _build_int8_encoder(self, batches):
        """Calibrate the int8-dataflow tower (the ViT's or the
        ModifiedResNet trunk's) on the first four gallery batches and swap
        it in as the image encoder; returns an iterable that replays every
        batch, the calibration ones included."""
        from .models.vit import VisionTransformer

        batches = iter(batches)
        calib = list(itertools.islice(batches, 4))
        if not calib:
            raise ValueError("build_gallery needs at least one batch")
        if isinstance(self.model.visual_model, VisionTransformer):
            from .models.int8_vit import build_int8_vit_encoder as build
        else:
            from .models.int8_tower import build_int8_encoder as build
        self._int8_image_encoder, self._int8_image_tower = build(
            self.model, calib)
        self._int8_pending = False
        return itertools.chain(calib, batches)

    # -- gallery ----------------------------------------------------------
    @torch.inference_mode()
    def build_gallery(self, batches, meta=None, valid_rows=None) -> None:
        """Encode an iterable of pixel batches ``[B, H, W, 3]`` (uint8 or
        normalized float) into the index.  ``valid_rows`` drops trailing
        rows after encoding (a caller's padded last batch), so a pad
        duplicate never enters the index."""
        if self._int8_pending:
            batches = self._build_int8_encoder(batches)
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
        self._kernel_gallery()
        self._finalize_mesh_gallery()

    def _finalize_mesh_gallery(self) -> None:
        """Pad/augment and shard the gallery over the mesh (the JAX
        package's ``_finalize_mesh_gallery``; nothing without a mesh):
        float shards, or the int8 form of the augmented matrix in shards,
        each padded with the kernel's zero columns."""
        self._mesh_shards, self._augmented = None, False
        if self.mesh is None:
            return
        from .evaluation.retrieval import shard_rows
        from .parallel.mesh import DATA_AXIS

        n = self.mesh.shape[DATA_AXIS]
        gallery = self.gallery
        g, d = gallery.shape
        if g % n:
            pad = n - g % n
            real = torch.cat([gallery, gallery.new_zeros(g, 1)], dim=1)
            pads = torch.cat([gallery.new_zeros(pad, d),
                              gallery.new_full((pad, 1), -2.0)], dim=1)
            gallery = torch.cat([real, pads])
            self._augmented = True
        if not self.quantize:
            self._mesh_shards = shard_rows(
                self.mesh, pad_columns(gallery, COLUMN_MULTIPLE["f32"]))
            return
        quant = quantize_rows(gallery)
        self._mesh_shards = [QuantizedGallery(v, s) for v, s in zip(
            shard_rows(self.mesh, pad_columns(quant.values,
                                              COLUMN_MULTIPLE["int8"])),
            shard_rows(self.mesh, quant.scales))]

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
        quantized or not.  A legacy file of the JAX package with
        ``augmented`` set holds its mesh layout, ``[G + pad, D + 1]`` (pad
        rows and a score column): both are stripped, as the JAX package
        does.  A quantized instance reuses stored int8 rows whose shape
        matches the gallery and quantizes the gallery again otherwise
        (the legacy file's quantized the augmented matrix).  Every member
        is read before the instance changes, so a failed load leaves the
        previous gallery serving."""
        with np.load(path) as data:
            meta = data["meta"]
            gallery = data["gallery"]
            if "augmented" in data.files and bool(data["augmented"]):
                gallery = gallery[:len(meta), :-1]
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
        self._kernel_gallery()
        self._finalize_mesh_gallery()

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
        if self.mesh is not None:
            return self._rank_sharded(queries, k)
        if self.quantize:
            quant = self._quant_gallery
            if k <= K_MAX:
                return topk_similarity_quantized(
                    queries, self._kernel_gallery(), quant.scales, k=k)
            return quantized_topk(queries, quant,
                                  min(k, quant.values.shape[0]))
        if k <= K_MAX:
            return topk_similarity(queries, self._kernel_gallery(), k=k)
        sim = queries @ self.gallery.T
        vals, idx = torch.topk(sim, min(k, self.gallery.shape[0]), dim=1)
        return vals, idx

    def _rank_sharded(self, queries: torch.Tensor, k: int):
        """The mesh's shards ranked and merged (``evaluation/
        retrieval.py``); k clamped to the padded row count, whose slots
        past the real gallery ``_finish`` turns into sentinels."""
        from .evaluation.retrieval import (
            sharded_topk_retrieval,
            sharded_topk_retrieval_quantized,
        )

        if self._augmented:
            queries = torch.cat([queries, queries.new_ones(
                queries.shape[0], 1)], dim=1)
        rows = sum((s.values if self.quantize else s).shape[0]
                   for s in self._mesh_shards)
        if self.mesh.distributed:  # this rank's shard alone
            from .parallel.mesh import DATA_AXIS

            rows *= self.mesh.shape[DATA_AXIS]
        rank = (sharded_topk_retrieval_quantized if self.quantize
                else sharded_topk_retrieval)
        return rank(self.mesh, queries, self._mesh_shards, k=min(k, rows))

    @torch.inference_mode()
    def search(self, token_ids: np.ndarray, lengths: np.ndarray,
               k: int = 10):
        """Top-k gallery matches for tokenized text queries: ``(scores
        [Q, k], meta [Q, k])``.  Slots beyond the real gallery carry score
        ``-inf`` and meta ``-1``.  The text tower and the ranking run at
        the Q rows given: the JAX package pads Q to 256-row buckets for
        its compile cache, which eager PyTorch has no use for, and the
        ``"always"`` pool rule makes an embedding independent of the rows
        beside it."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery first")
        n_q = token_ids.shape[0]
        queries = self._embed_texts(
            self._to_device(np.asarray(token_ids, np.int32)),
            self._to_device(np.asarray(lengths, np.int32)))
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
        vals, idx = self._rank(self._to_device(queries), k)
        return self._finish(vals, idx, n_q, k)

    def _finish(self, vals, idx, n_q: int, k: int):
        """Keep the first ``n_q`` rows, pad k out to the request, and map
        rows to metadata with the sentinel contract (-inf score, -1
        meta)."""
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
