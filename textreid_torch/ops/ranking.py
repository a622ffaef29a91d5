"""Streaming similarity top-k for retrieval ranking.

Counterpart of ``textreid_tpu/ops/ranking_pallas.py:topk_similarity`` and
its pad-and-trim wrapper ``topk_similarity_padded``: the CUDA kernel
``csrc/topk_similarity.cu`` masks ragged query and gallery edges itself, so
one function takes any Q and G.  On a CUDA tensor :func:`topk_similarity`
launches the kernel; on a CPU tensor it runs :func:`topk_similarity_plain`,
the kernel's contract.  Nothing falls back from one to the other.

Order is (score desc, gallery row desc): on an exact tie the larger row
wins.  Slots past the valid rows hold ``NEG_INF`` and row ``-1``.

Any embedding width D ranks, as in the JAX package.  The kernels read a
row whose bytes are a multiple of 16 (D % 4 == 0 in f32, D % 16 == 0 in
int8): the wrappers pad D with zero columns, which leave every score
unchanged, up to that multiple (:func:`pad_columns`).  A gallery may come
already padded (``serving.RetrievalIndex`` pads its gallery once, when it is
built or loaded); then only the queries are padded, on each call.  Past
``SLICE_COLS`` columns the kernels stage their query tiles a slice at a
time, and still sum each score over the whole of D before the selection.

:func:`topk_similarity_quantized` is the same over an int8 gallery with
per-row scales, the counterpart of ``ranking_pallas.py:
topk_similarity_quantized`` and its ``_padded`` wrapper; its plain version
is ``ops/quant.py:quantized_scores`` followed by the same stable sort.

:func:`topk_plan` is both kernels' launch plan (the library's
``topk_similarity_plan`` mirrors it), and :func:`topk_by_plan` their split
and merge in plain PyTorch, the CPU witness of the decomposition.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .quant import QuantizedGallery, quantized_scores

NEG_INF = -3.0e38
K_MAX = 64  # the kernel keeps at most 64 entries a query
SLICE_COLS = 768  # query columns the kernel stages at once (csrc: kSliceCols)
COLUMN_MULTIPLE = {"f32": 4, "int8": 16}  # D's multiple: 16-byte rows


def pad_columns(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x [N, D]`` with zero columns appended up to a multiple of
    ``multiple`` (``x`` itself when D is one)."""
    extra = -x.shape[1] % multiple
    if not extra:
        return x
    return torch.cat([x, x.new_zeros(x.shape[0], extra)], dim=1)


def _aligned(queries: torch.Tensor, gallery: torch.Tensor, multiple: int):
    """``(queries, gallery)`` padded with zero columns to the gallery's
    width rounded up to ``multiple``; a gallery already padded that way
    (wider than the queries by less than ``multiple``, to a multiple of
    it) is not copied again.  Other widths are left for the checks."""
    d_q, d_g = queries.shape[-1], gallery.shape[-1]
    if queries.dim() != 2 or gallery.dim() != 2 or not (
            d_q == d_g or (d_g % multiple == 0 and d_q < d_g
                           and d_g - d_q < multiple)):
        return queries, gallery
    gallery = pad_columns(gallery, multiple)
    if d_q < gallery.shape[1]:
        queries = torch.cat([queries, queries.new_zeros(
            queries.shape[0], gallery.shape[1] - d_q)], dim=1)
    return queries, gallery


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


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be torch.float32 or "
                        f"torch.bfloat16, not {compute_dtype}")


def topk_similarity_plain(queries: torch.Tensor, gallery: torch.Tensor,
                          k: int, valid_gallery: int = 0,
                          compute_dtype: torch.dtype = torch.float32):
    """float32 ``queries @ gallery.T``, then the stable top-k.  Rows
    ``>= valid_gallery`` (0 = all) never rank.  With
    ``compute_dtype=torch.bfloat16`` both operands are rounded to bf16
    first; the products (exact in f32) are still summed in f32.  Returns
    ``([Q, k] f32, [Q, k] int32)``."""
    _check_compute_dtype(compute_dtype)
    n_g = gallery.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    q = queries.to(compute_dtype).float()
    g = gallery[:valid].to(compute_dtype).float()
    return _stable_topk(q @ g.T, k)


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
    if dim % 4:
        raise ValueError(f"topk_similarity_f32 needs D % 4 == 0; got "
                         f"D={dim}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_similarity_f32 takes 1 <= k <= {K_MAX}; "
                         f"got {k}")
    for name, t in (("queries", queries), ("gallery", gallery)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if not t.is_cuda or t.device != queries.device:
            raise ValueError(f"{name} must be on {queries.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


# The kernel's plan (csrc/topk_similarity.cu:make_plan, Layout): its
# constants, mirrored here so the wrapper can size the scratch
TILE_ROWS = 128            # gallery rows a ring stage holds
CHUNK_BYTES = 256          # bytes of a row a ring stage holds
Q_TILES = (64, 32, 16, 8)  # queries a block, in order of preference
MIN_STAGES, MAX_STAGES = 3, 6
SMEM_MAX = 232448          # a block's shared memory on the H100
SPLITS_MAX = 192           # a query's lists fit 3 ring stages at k = 64
CAND_CAP = 64              # candidates a query holds between folds
KINDS = ("f32", "bf16", "int8")


class TopkPlan(NamedTuple):
    q_tile: int          # queries a block
    splits: int          # blocks sharing a query tile's gallery
    stages: int          # ring stages in flight
    smem_bytes: int
    tile_rows: int = TILE_ROWS


def _query_stride(kind: str, dim: int) -> int:
    if kind == "f32":
        return dim * 4
    return -(-(-(-dim // 32) * 64) // 128) * 128 + 32


def _shared_bytes(kind: str, q_tile: int, dim: int, stages: int) -> int:
    """A block's shared memory (``Layout`` in the ``.cu``): the ring, the
    query tile (at most ``SLICE_COLS`` columns of it), the lists (64
    entries a query), the candidate buffers, the thresholds, counts and
    list lengths, the mbarriers, 16 spare bytes and 1 KB of slack to align
    the ring to the swizzle's atom."""
    dim = min(dim, SLICE_COLS)
    return (stages * TILE_ROWS * CHUNK_BYTES + 1024
            + q_tile * _query_stride(kind, dim)
            + q_tile * K_MAX * 8 + q_tile * CAND_CAP * 8
            + q_tile * (8 + 4 + 4) + 2 * stages * 8 + 16)


@functools.lru_cache(maxsize=1024)
def topk_plan(n_q: int, n_rows: int, dim: int, sm_count: int,
              kind: str = "f32") -> TopkPlan:
    """The launch plan of K2 (``kind`` "f32", or "bf16" for its
    ``compute_dtype=bfloat16``) or K4 ("int8") for ``n_q`` queries over
    ``n_rows`` valid rows: the largest query tile (at most the next power of
    two of ``n_q``, at least 8; at most 32 but for "f32" at 256 queries or
    more, since the last block of a query tile merges all its queries'
    lists) whose block fits 3 ring stages and whose grid fills three
    quarters of the SMs with splits of at least 256 rows (16 at an 8-query
    tile: one query is bound by bytes, so every SM streams); failing that,
    the tile with the most blocks.  Split ``s`` holds rows ``[s n_rows //
    splits, (s + 1) n_rows // splits)``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    top = 64 if kind == "f32" and n_q >= 256 else 32
    cap = 8
    while cap < n_q and cap < top:
        cap *= 2
    best, best_blocks = None, -1
    for q_tile in Q_TILES:
        if q_tile > cap:
            continue
        stages = next((s for s in range(MAX_STAGES, MIN_STAGES - 1, -1)
                       if _shared_bytes(kind, q_tile, dim, s) <= SMEM_MAX), 0)
        if not stages:
            continue
        q_tiles = -(-n_q // q_tile)
        min_rows = 16 if q_tile == 8 else 256
        splits = max(1, min(sm_count // q_tiles, SPLITS_MAX,
                            -(-n_rows // min_rows)))
        plan = TopkPlan(q_tile, splits, stages,
                        _shared_bytes(kind, q_tile, dim, stages))
        blocks = q_tiles * splits
        if 4 * blocks >= 3 * sm_count:
            return plan
        if blocks > best_blocks:
            best, best_blocks = plan, blocks
    return best


def _rank_top(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """The k best of each row of ``(vals, rows) [Q, n]`` under (value desc,
    row desc), padded with sentinels to k."""
    n_q, n = vals.shape
    if n < k:
        vals = torch.cat([vals, vals.new_full((n_q, k - n), NEG_INF)], 1)
        rows = torch.cat([rows, rows.new_full((n_q, k - n), -1)], 1)
    by_row = torch.sort(rows, dim=1, descending=True, stable=True).indices
    vals, rows = vals.gather(1, by_row), rows.gather(1, by_row)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order[:, :k]), rows.gather(1, order[:, :k])


def _above(v, r, tv, tr):
    """(v, r) ranks above (tv, tr): the kernel's ``ranks_above``."""
    return (v > tv) | ((v == tv) & (r > tr))


def topk_by_plan(scores: torch.Tensor, k: int, plan: TopkPlan):
    """The kernel's decomposition in plain PyTorch, for ``scores [Q, n_rows]``
    (the kernel's scores of the valid rows): each split of ``plan`` streams
    its rows in tiles of ``plan.tile_rows``, keeps the rows that beat its
    running k-th entry as of the tile's start and folds them into its
    top-k; then the splits' sorted lists are merged (the kernel's
    tournament takes the best head of the lists k times).  Returns ``(vals
    [Q, k], idx [Q, k] int32, entered)``: the same top-k as a stable sort of
    the scores, and the mean count of rows a query that beat their split's
    k-th entry as of their tile's start (the kernel, which folds only when a
    query's buffer fills, appends at least these)."""
    n_q, n_rows = scores.shape
    rows_all = torch.arange(n_rows, device=scores.device).expand(n_q, -1)
    lists_v, lists_r, entered = [], [], 0
    for s in range(plan.splits):
        begin = s * n_rows // plan.splits
        end = (s + 1) * n_rows // plan.splits
        lv = scores.new_full((n_q, k), NEG_INF)
        lr = torch.full((n_q, k), -1, dtype=torch.long, device=scores.device)
        for t in range(begin, end, plan.tile_rows):
            tv = scores[:, t:min(t + plan.tile_rows, end)]
            tr = rows_all[:, t:min(t + plan.tile_rows, end)]
            enter = _above(tv, tr, lv[:, -1:], lr[:, -1:])
            entered += int(enter.sum())
            lv, lr = _rank_top(torch.cat([lv, tv.masked_fill(~enter, NEG_INF)],
                                         1),
                               torch.cat([lr, tr.masked_fill(~enter, -1)], 1),
                               k)
        lists_v.append(lv)
        lists_r.append(lr)
    vals, idx = _rank_top(torch.cat(lists_v, 1), torch.cat(lists_r, 1), k)
    return vals, idx.to(torch.int32), entered / max(1, n_q * plan.splits)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACE: dict = {}


def _workspace(device: torch.device, n_q: int, plan: TopkPlan, k: int):
    """Device addresses ``(tickets, part_vals, part_idx)`` in the device's
    workspace, kept and grown as needed: the ticket counters, one a query
    tile, zeroed once (each launch's last block resets its own), and the
    [n_q, splits, k rounded up to 4] lists that the last block of a query
    tile merges.  Two launches running at once on two streams must not
    share them (serving uses one stream)."""
    q_tiles = -(-n_q // plan.q_tile)
    lists = n_q * plan.splits * -(-k // 4) * 4 if plan.splits > 1 else 0
    have = _WORKSPACE.get(device.index)
    if have is None or have[0] < q_tiles or have[1] < lists:
        tiles = max(q_tiles, 1024)
        room = max(lists, 1 << 18)
        have = (tiles, room, torch.zeros(tiles + 2 * room, dtype=torch.int32,
                                         device=device))
        _WORKSPACE[device.index] = have
    tiles, room, buf = have
    base = buf.data_ptr()
    return base, base + 4 * tiles, base + 4 * (tiles + room)


def _launch(dev: torch.device, entry, *args) -> int:
    """``entry(*args, stream)`` on ``dev``'s current stream, with ``dev``
    the current device (switched only if it is not); its cudaError_t."""
    if dev.index == torch.cuda.current_device():
        return entry(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return entry(*args, torch.cuda.current_stream().cuda_stream)


def _topk_cuda(queries, gallery, k, valid_gallery,
               compute_dtype=torch.float32):
    _check_compute_dtype(compute_dtype)
    _check_inputs(queries, gallery, k)
    n_q, dim = queries.shape
    n_g = gallery.shape[0]
    valid = min(valid_gallery or n_g, n_g)
    dev = queries.device
    vals = torch.empty(n_q, k, dtype=torch.float32, device=dev)
    idx = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    if n_q == 0 or valid == 0:
        return vals.fill_(NEG_INF), idx.fill_(-1)
    kind = "bf16" if compute_dtype == torch.bfloat16 else "f32"
    plan = topk_plan(n_q, valid, dim, _sm_count(dev.index), kind)
    tickets, part_vals, part_idx = _workspace(dev, n_q, plan, k)
    err = _launch(dev, _build.library().topk_similarity_f32,
                  queries.data_ptr(), gallery.data_ptr(), vals.data_ptr(),
                  idx.data_ptr(), part_vals, part_idx, tickets, n_q, n_g, dim,
                  k, valid, plan.q_tile, plan.splits, int(kind == "bf16"))
    _build.check(err, "topk_similarity_f32")
    topk_similarity.launches += 1
    return vals, idx


def topk_similarity(queries: torch.Tensor, gallery: torch.Tensor,
                    k: int = 10, valid_gallery: int = 0,
                    compute_dtype: torch.dtype = torch.float32):
    """Top-k of ``queries @ gallery.T`` without materialising it on CUDA.

    ``valid_gallery`` (0 = all rows) masks trailing gallery rows.
    ``compute_dtype=torch.bfloat16`` rounds both (float32) operands to bf16
    before the products, which are still summed in f32; scores then match a
    bf16-inputs / f32-accumulate product, not the f32 one.  Any D: both
    are padded with zero columns to a multiple of 4, and a gallery so
    padded already takes queries of its unpadded width.  Returns ``([Q, k]
    f32 scores, [Q, k] int32 rows)``, rows sorted descending.  A CUDA
    tensor launches ``topk_similarity_f32`` (counted in
    ``topk_similarity.launches``); a CPU tensor runs the plain version."""
    queries, gallery = _aligned(queries, gallery, COLUMN_MULTIPLE["f32"])
    if queries.is_cuda:
        return _topk_cuda(queries, gallery, k, valid_gallery, compute_dtype)
    return topk_similarity_plain(queries, gallery, k, valid_gallery,
                                 compute_dtype)


topk_similarity.launches = 0


def _check_quantized_inputs(queries, values, scales, k) -> None:
    if queries.dim() != 2 or values.dim() != 2 or (
            queries.shape[1] != values.shape[1]):
        raise ValueError(f"need queries [Q, D] and values [G, D]; got "
                         f"{tuple(queries.shape)}, {tuple(values.shape)}")
    dim = queries.shape[1]
    if dim % 16:
        raise ValueError(f"topk_similarity_int8 needs D % 16 == 0; got "
                         f"D={dim}")
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
    if n_q == 0 or valid == 0:
        return vals.fill_(NEG_INF), idx.fill_(-1)
    plan = topk_plan(n_q, valid, dim, _sm_count(dev.index), "int8")
    tickets, part_vals, part_idx = _workspace(dev, n_q, plan, k)
    err = _launch(dev, _build.library().topk_similarity_int8,
                  queries.data_ptr(), values.data_ptr(), scales.data_ptr(),
                  vals.data_ptr(), idx.data_ptr(), part_vals, part_idx,
                  tickets, n_q, n_g, dim, k, valid, plan.q_tile, plan.splits)
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
    trailing rows.  Any D: as :func:`topk_similarity`, to a multiple of 16
    (zero columns leave the row scales unchanged).  Returns ``([Q, k] f32
    scores, [Q, k] int32 rows)``, sorted descending with the float kernel's
    tie rule.  A CUDA tensor launches ``topk_similarity_int8`` (counted in
    ``topk_similarity_quantized.launches``); a CPU tensor runs the plain
    version."""
    queries, values = _aligned(queries, values, COLUMN_MULTIPLE["int8"])
    if queries.is_cuda:
        return _topk_quantized_cuda(queries, values, scales, k, valid_gallery)
    return topk_similarity_quantized_plain(queries, values, scales, k,
                                           valid_gallery)


topk_similarity_quantized.launches = 0
