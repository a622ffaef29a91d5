"""Streaming similarity top-k for retrieval ranking.

Counterpart of ``textreid_tpu/ops/ranking_pallas.py:topk_similarity`` and
its pad-and-trim wrapper ``topk_similarity_padded``: the CUDA kernel
``csrc/topk_similarity.cu`` masks ragged query and gallery edges itself, so
one function takes any Q and G.  On a CUDA tensor :func:`topk_similarity`
launches the kernel; on a CPU tensor it runs :func:`topk_similarity_plain`,
the kernel's contract.  Nothing falls back from one to the other.

Order is (score desc, gallery row desc): on an exact tie the larger row
wins.  Slots past the valid rows hold ``NEG_INF`` and row ``-1``.

:func:`topk_similarity_quantized` is the same over an int8 gallery with
per-row scales, the counterpart of ``ranking_pallas.py:
topk_similarity_quantized`` and its ``_padded`` wrapper; its plain version
is ``ops/quant.py:quantized_scores`` followed by the same stable sort.
"""

from __future__ import annotations

import torch

from . import _build
from .quant import QuantizedGallery, quantized_scores

NEG_INF = -3.0e38
K_MAX = 64  # the kernel keeps at most 64 entries per query (2 per lane)
D_MAX = 768  # queries + one padded gallery tile in 227 KB of shared memory


def _stable_topk(scores: torch.Tensor, k: int):
    """The k best of each row of ``scores [Q, valid]`` under (score desc,
    column desc): a stable sort of the column-reversed scores, so that ties
    go to the larger column (``torch.topk`` promises no tie order).
    Returns ``([Q, k] f32, [Q, k] int32)``, sentinel slots past ``valid``."""
    n_q, valid = scores.shape
    order = torch.sort(scores.flip(1), dim=1, descending=True, stable=True)
    take = min(k, valid)
    vals = scores.new_full((n_q, k), NEG_INF, dtype=torch.float32)
    idx = torch.full((n_q, k), -1, dtype=torch.int32, device=scores.device)
    vals[:, :take] = order.values[:, :take]
    idx[:, :take] = (valid - 1 - order.indices[:, :take]).to(torch.int32)
    return vals, idx


def topk_similarity_plain(queries: torch.Tensor, gallery: torch.Tensor,
                          k: int, valid_gallery: int = 0):
    """float32 ``queries @ gallery.T``, then the stable top-k.  Rows
    ``>= valid_gallery`` (0 = all) never rank.  Returns ``([Q, k] f32,
    [Q, k] int32)``."""
    n_g = gallery.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    return _stable_topk(queries.float() @ gallery[:valid].float().T, k)


def topk_similarity_quantized_plain(queries: torch.Tensor,
                                    values: torch.Tensor,
                                    scales: torch.Tensor, k: int,
                                    valid_gallery: int = 0):
    """``ops.quant.quantized_scores`` over the rows ``< valid_gallery``
    (0 = all), then the stable top-k with the float kernel's tie rule."""
    n_g = values.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    gallery = QuantizedGallery(values[:valid], scales[:valid].float())
    return _stable_topk(quantized_scores(queries.float(), gallery), k)


def _check_inputs(queries, gallery, k) -> None:
    if queries.dim() != 2 or gallery.dim() != 2 or (
            queries.shape[1] != gallery.shape[1]):
        raise ValueError(f"need queries [Q, D] and gallery [G, D]; got "
                         f"{tuple(queries.shape)}, {tuple(gallery.shape)}")
    dim = queries.shape[1]
    if dim % 4 or dim > D_MAX:
        raise ValueError(f"topk_similarity_f32 needs D % 4 == 0 and "
                         f"D <= {D_MAX}; got D={dim}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_similarity_f32 takes 1 <= k <= {K_MAX}; "
                         f"got {k}")
    for name, t in (("queries", queries), ("gallery", gallery)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if not t.is_cuda or t.device != queries.device:
            raise ValueError(f"{name} must be on {queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gallery_splits(n_q: int, n_rows: int, sm_count: int,
                   tile_rows: int = 64) -> int:
    """How many blocks share one query tile's gallery: enough for about two
    blocks per SM, and at least 4 tiles of ``tile_rows`` rows per split."""
    q_tiles = -(-n_q // 8)
    return max(1, min(2 * sm_count // q_tiles,
                      -(-n_rows // tile_rows) // 4))


def _topk_cuda(queries, gallery, k, valid_gallery):
    _check_inputs(queries, gallery, k)
    n_q, dim = queries.shape
    n_g = gallery.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    dev = queries.device
    vals = torch.empty(n_q, k, dtype=torch.float32, device=dev)
    idx = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    if n_q == 0:
        return vals, idx
    splits = gallery_splits(
        n_q, valid, torch.cuda.get_device_properties(dev).multi_processor_count)
    # per-split sorted lists, merged by a second kernel (unused at 1 split)
    part_vals = torch.empty(n_q, splits, k, dtype=torch.float32, device=dev)
    part_idx = torch.empty(n_q, splits, k, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_similarity_f32(
            queries.data_ptr(), gallery.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), part_vals.data_ptr(), part_idx.data_ptr(), n_q,
            n_g, dim, k, valid, splits, stream)
    _build.check(err, "topk_similarity_f32")
    topk_similarity.launches += 1
    return vals, idx


def topk_similarity(queries: torch.Tensor, gallery: torch.Tensor,
                    k: int = 10, valid_gallery: int = 0):
    """Top-k of ``queries @ gallery.T`` without materialising it on CUDA.

    ``valid_gallery`` (0 = all rows) masks trailing gallery rows.  Returns
    ``([Q, k] f32 scores, [Q, k] int32 rows)``, rows sorted descending.  A
    CUDA tensor launches ``topk_similarity_f32`` (counted in
    ``topk_similarity.launches``); a CPU tensor runs the plain version."""
    if queries.is_cuda:
        return _topk_cuda(queries, gallery, k, valid_gallery)
    return topk_similarity_plain(queries, gallery, k, valid_gallery)


topk_similarity.launches = 0


QUANT_TILE_ROWS = 128  # the int8 kernel's gallery tile (kRowsTileQ)


def _check_quantized_inputs(queries, values, scales, k) -> None:
    if queries.dim() != 2 or values.dim() != 2 or (
            queries.shape[1] != values.shape[1]):
        raise ValueError(f"need queries [Q, D] and values [G, D]; got "
                         f"{tuple(queries.shape)}, {tuple(values.shape)}")
    dim = queries.shape[1]
    if dim % 16 or dim > D_MAX:
        raise ValueError(f"topk_similarity_int8 needs D % 16 == 0 and "
                         f"D <= {D_MAX}; got D={dim}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_similarity_int8 takes 1 <= k <= {K_MAX}; "
                         f"got {k}")
    if tuple(scales.shape) != (values.shape[0],):
        raise ValueError(f"scales must be [{values.shape[0]}]; got "
                         f"{tuple(scales.shape)}")
    tensors = (("queries", queries, torch.float32),
               ("values", values, torch.int8),
               ("scales", scales, torch.float32))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    for name, t, _ in tensors:
        if not t.is_cuda or t.device != queries.device:
            raise ValueError(f"{name} must be on {queries.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _topk_quantized_cuda(queries, values, scales, k, valid_gallery):
    _check_quantized_inputs(queries, values, scales, k)
    n_q, dim = queries.shape
    n_g = values.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    dev = queries.device
    vals = torch.empty(n_q, k, dtype=torch.float32, device=dev)
    idx = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    if n_q == 0:
        return vals, idx
    splits = gallery_splits(
        n_q, valid, torch.cuda.get_device_properties(dev).multi_processor_count,
        QUANT_TILE_ROWS)
    part_vals = torch.empty(n_q, splits, k, dtype=torch.float32, device=dev)
    part_idx = torch.empty(n_q, splits, k, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_similarity_int8(
            queries.data_ptr(), values.data_ptr(), scales.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), part_vals.data_ptr(),
            part_idx.data_ptr(), n_q, n_g, dim, k, valid, splits, stream)
    _build.check(err, "topk_similarity_int8")
    topk_similarity_quantized.launches += 1
    return vals, idx


def topk_similarity_quantized(queries: torch.Tensor, values: torch.Tensor,
                              scales: torch.Tensor, k: int = 10,
                              valid_gallery: int = 0):
    """Top-k of ``(bf16(queries) @ values.T) * scales`` over an int8
    gallery without materialising the scores on CUDA.

    ``values [G, D]`` int8 and ``scales [G]`` float32 are
    ``ops.quant.quantize_rows``'s; ``valid_gallery`` (0 = all rows) masks
    trailing rows.  Returns ``([Q, k] f32 scores, [Q, k] int32 rows)``,
    sorted descending with the float kernel's tie rule.  A CUDA tensor
    launches ``topk_similarity_int8`` (counted in
    ``topk_similarity_quantized.launches``); a CPU tensor runs the plain
    version."""
    if queries.is_cuda:
        return _topk_quantized_cuda(queries, values, scales, k, valid_gallery)
    return topk_similarity_quantized_plain(queries, values, scales, k,
                                           valid_gallery)


topk_similarity_quantized.launches = 0
