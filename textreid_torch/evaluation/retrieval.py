"""Sharded large-gallery retrieval (counterpart of
``textreid_tpu/evaluation/retrieval.py``).

The (deduped, L2-normalized) gallery is split row-wise into the mesh's
``data`` shards, one a device of the mesh (``parallel/mesh.py:make_mesh``
outside a process group: the cards of this process, a card may hold
several shards).  The queries are copied to each shard's device, each
shard is ranked there by the streaming top-k kernel (``ops/ranking.py``:
K2 over float rows, K4 over int8 rows with their scales), its local rows
made global (``+ shard * shard_rows``), and the shards' candidates are
merged on the first device: laid out shard-major, ``[Q, n * k_local]``,
and reduced to the global top-k by a stable sort, so that equal scores
keep the candidates' order, as JAX's ``lax.top_k`` over the same layout
keeps it (the lower shard first; inside a shard the kernel's order, ties to
the larger row).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..ops.quant import QuantizedGallery
from ..ops.ranking import (
    K_MAX,
    topk_similarity,
    topk_similarity_plain,
    topk_similarity_quantized,
    topk_similarity_quantized_plain,
)
from ..parallel.mesh import DATA_AXIS


def _plan_shards(n_shards: int, g_count: int, k: int):
    """Validate divisibility and size the per-shard candidate count."""
    if g_count % n_shards != 0:
        raise ValueError(
            f"gallery rows {g_count} must divide over {n_shards} shards "
            f"(pad the gallery with zero rows and mask downstream)"
        )
    shard_rows = g_count // n_shards
    # Each shard only needs min(k, rows) local candidates; the global merge
    # pools n * k_local of them (must still cover k).
    k_local = min(k, shard_rows)
    if n_shards * k_local < k:
        raise ValueError(
            f"top-{k} infeasible: {n_shards} shards x {k_local} local "
            f"candidates"
        )
    return shard_rows, k_local


def shard_rows(mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x [G, ...]`` in ``mesh``'s data shards: contiguous blocks of
    ``G / n`` rows, shard s on ``mesh.devices[s]``, each in an allocation
    of its own (the kernels take 16-byte-aligned rows and scales: a view
    into ``x`` would start wherever its first row lies)."""
    if mesh.distributed:
        raise ValueError(
            "a process-group mesh holds one card a process: shard a "
            "gallery over this process's cards, make_mesh(devices=...)")
    n = mesh.shape[DATA_AXIS]
    _plan_shards(n, x.shape[0], 1)
    return [torch.empty_like(part, device=device).copy_(part)
            for part, device in zip(x.chunk(n), mesh.devices)]


def _global_merge(vals: Sequence[torch.Tensor], idx: Sequence[torch.Tensor],
                  shard_rows: int, k: int):
    """Globalize each shard's local rows and reduce all shards' candidates
    to the global top-k on the first shard's device."""
    device = vals[0].device
    all_vals = torch.cat([v.to(device) for v in vals], dim=1)
    all_idx = torch.cat([(i.to(device) + s * shard_rows).to(torch.int32)
                         for s, i in enumerate(idx)], dim=1)
    top = torch.sort(all_vals, dim=1, descending=True, stable=True)
    pos = top.indices[:, :k]
    return top.values[:, :k], torch.gather(all_idx, 1, pos)


Shards = Union[torch.Tensor, Sequence[torch.Tensor]]


def _to_width(queries: torch.Tensor, width: int) -> torch.Tensor:
    """``queries`` with zero columns up to a shard's (padded) width, for
    the plain versions (the kernels' wrappers pad them themselves)."""
    extra = width - queries.shape[1]
    return queries if extra <= 0 else torch.cat(
        [queries, queries.new_zeros(queries.shape[0], extra)], dim=1)


def _shards(mesh, gallery: Shards) -> List[torch.Tensor]:
    if isinstance(gallery, torch.Tensor):
        return shard_rows(mesh, gallery)
    if len(gallery) != mesh.shape[DATA_AXIS]:
        raise ValueError(f"{len(gallery)} shards for a mesh of "
                         f"{mesh.shape[DATA_AXIS]}")
    return list(gallery)


def sharded_topk_retrieval(mesh, queries: torch.Tensor, gallery: Shards,
                           k: int = 10):
    """Global top-k gallery matches per query over a gallery sharded across
    ``mesh``: ``gallery`` is ``[G, D]`` (split here) or its shards (as
    :func:`shard_rows` gives them, each possibly with the kernel's zero
    columns).  Each shard is ranked by K2 (``ops/ranking.py:
    topk_similarity``), or, past its ``k <= 64``, by the materialising
    plain version, as the unsharded index ranks.  Returns ``([Q, k]
    scores, [Q, k] int32 global gallery indices)`` on the first shard's
    device."""
    shards = _shards(mesh, gallery)
    rows, k_local = _plan_shards(len(shards),
                                 sum(s.shape[0] for s in shards), k)
    if k_local <= K_MAX:
        out = [topk_similarity(queries.to(s.device), s, k_local)
               for s in shards]
    else:
        out = [topk_similarity_plain(_to_width(queries.to(s.device),
                                               s.shape[1]), s, k_local)
               for s in shards]
    return _global_merge([o[0] for o in out], [o[1] for o in out], rows, k)


def sharded_topk_retrieval_quantized(mesh, queries: torch.Tensor, gallery,
                                     k: int = 10):
    """int8 composition of :func:`sharded_topk_retrieval`: ``gallery`` is
    a ``QuantizedGallery`` ``[G, D]`` (split here) or a sequence of its
    shards.  Each shard holds its int8 rows and their scales and is ranked
    by K4 (``ops/ranking.py:topk_similarity_quantized``; the plain version
    past ``k <= 64``).  The scores are the unsharded int8 path's, so the
    composition is index-exact against it outside ties."""
    if isinstance(gallery, QuantizedGallery):
        gallery = [QuantizedGallery(v, s) for v, s in zip(
            shard_rows(mesh, gallery.values),
            shard_rows(mesh, gallery.scales))]
    shards = _shards(mesh, gallery)
    rows, k_local = _plan_shards(
        len(shards), sum(s.values.shape[0] for s in shards), k)
    if k_local <= K_MAX:
        out = [topk_similarity_quantized(queries.to(s.values.device),
                                         s.values, s.scales, k_local)
               for s in shards]
    else:
        out = [topk_similarity_quantized_plain(
            _to_width(queries.to(s.values.device), s.values.shape[1]),
            s.values, s.scales, k_local) for s in shards]
    return _global_merge([o[0] for o in out], [o[1] for o in out], rows, k)
