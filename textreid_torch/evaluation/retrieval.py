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
the larger row).  A mesh with a model axis (or slices) shards over
``data`` and holds each shard once, on the device of its model index 0
(``Mesh.shard_devices``), as JAX's ``shard_map`` with ``P(DATA_AXIS)``
replicates over the other axes.

On a process-group mesh (``make_mesh`` inside ``torch.distributed``, one
rank a card) each rank holds only its own ``G / n`` block of the data
axis: the queries are broadcast from the data group's first rank, each
rank ranks its block with K2 or K4, the ``[Q, k_local]`` values and global
row ids are all-gathered over the data group and merged as above, and
every rank returns the global top-k (JAX's ``shard_map`` over ``data``
across processes).
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
from ..parallel.mesh import DATA_AXIS, all_gather_along, axis


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
    ``G / n`` rows, shard s on ``mesh.shard_devices[s]``, each in an
    allocation of its own (the kernels take 16-byte-aligned rows and
    scales: a view into ``x`` would start wherever its first row lies).
    On a process-group mesh, this rank's block alone (a list of one), on
    its card."""
    n = mesh.shape[DATA_AXIS]
    _plan_shards(n, x.shape[0], 1)
    if mesh.distributed:
        part = x.chunk(n)[axis(DATA_AXIS).index]
        return [torch.empty_like(part, device=mesh.devices[0]).copy_(part)]
    return [torch.empty_like(part, device=device).copy_(part)
            for part, device in zip(x.chunk(n), mesh.shard_devices)]


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
    want = 1 if mesh.distributed else mesh.shape[DATA_AXIS]
    if len(gallery) != want:
        raise ValueError(f"{len(gallery)} shards for a mesh of "
                         f"{mesh.shape[DATA_AXIS]}"
                         + (" (one a rank)" if mesh.distributed else ""))
    return list(gallery)


def _rank_shards(mesh, queries: torch.Tensor, shards: list, rows: int,
                 k: int, rank_one):
    """``rank_one(queries, shard, k_local)`` on each shard (``rows`` of
    them a shard), merged to the global top-k; on a process-group mesh
    this rank's one shard, the queries broadcast from the data group's
    first rank and the candidates all-gathered over the data group."""
    n = mesh.shape[DATA_AXIS]
    per_shard, k_local = _plan_shards(n, rows * n, k)
    if not mesh.distributed:
        out = [rank_one(queries, s, k_local) for s in shards]
        return _global_merge([o[0] for o in out], [o[1] for o in out],
                             per_shard, k)
    ax = axis(DATA_AXIS)
    queries = queries.to(mesh.devices[0]).contiguous().clone()
    if ax.size > 1:
        torch.distributed.broadcast(queries, ax.ranks[0], group=ax.group)
    vals, idx = rank_one(queries, shards[0], k_local)
    return _global_merge(all_gather_along(vals.contiguous(), ax),
                         all_gather_along(idx.to(torch.int32), ax),
                         per_shard, k)


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

    def rank_one(q, s, k_local):
        q = q.to(s.device)
        if k_local <= K_MAX:
            return topk_similarity(q, s, k_local)
        return topk_similarity_plain(_to_width(q, s.shape[1]), s, k_local)

    return _rank_shards(mesh, queries, shards, shards[0].shape[0], k,
                        rank_one)


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

    def rank_one(q, s, k_local):
        q = q.to(s.values.device)
        if k_local <= K_MAX:
            return topk_similarity_quantized(q, s.values, s.scales, k_local)
        return topk_similarity_quantized_plain(
            _to_width(q, s.values.shape[1]), s.values, s.scales, k_local)

    return _rank_shards(mesh, queries, shards, shards[0].values.shape[0], k,
                        rank_one)
