"""The port's int8 gallery math (``ops/quant.py``) and the plain version of
the int8 streaming top-k (K4's contract) against the JAX package, on the CPU.

``quantize_rows``: scales within one float32 ulp, int8 values within one
quantization step (a division that lands on a rounding boundary may round
the other way: ROADMAP Queue C "Int8 rounding"), and exactly equal on a
seeded case built away from the boundaries.  ``quantized_scores``: rtol
1e-6 (exact bf16 x int8 products, float32 sums in another order; atol 1e-6
where a cosine is near zero).  The plain top-k against the JAX Pallas kernel
in interpret mode and against ``quantized_topk``: scores rtol 1e-5, indices
equal outside exact ties, with G not a multiple of the kernel's tile and a
gallery with duplicated rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.ops import quant as jax_quant
from textreid_tpu.ops.ranking_pallas import topk_similarity_quantized_padded
from textreid_torch.ops import quant, ranking

torch.set_num_threads(2)


def _unit(rng, n, dim):
    x = rng.randn(n, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_quantize_rows_matches_jax():
    emb = _unit(np.random.RandomState(0), 300, 64)
    emb[7] = 0.0  # an all-zero row: the scale floor
    want = jax_quant.quantize_rows(jnp.asarray(emb))
    got = quant.quantize_rows(torch.from_numpy(emb))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    scales, want_scales = got.scales.numpy(), np.asarray(want.scales)
    assert (np.abs(scales - want_scales) <= np.spacing(want_scales)).all()
    step = np.abs(got.values.numpy().astype(np.int32)
                  - np.asarray(want.values).astype(np.int32))
    assert step.max() <= 1
    assert (got.values[7] == 0).all()
    np.testing.assert_allclose(quant.dequantize_rows(got).numpy(),
                               np.asarray(jax_quant.dequantize_rows(want)),
                               atol=float(want_scales.max()) * 1.001)


def test_quantize_rows_is_exact_away_from_rounding_boundaries():
    """Rows built from integers q in [-127, 127] with |q|max = 127 and a
    power-of-two scale: value / scale is the integer itself."""
    rng = np.random.RandomState(1)
    q = rng.randint(-127, 128, (50, 32)).astype(np.float32)
    q[:, 0] = 127.0
    emb = q * np.float32(2.0 ** -9)
    want = jax_quant.quantize_rows(jnp.asarray(emb))
    got = quant.quantize_rows(torch.from_numpy(emb))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.values.numpy(), q.astype(np.int8))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.fixture(scope="module")
def gallery():
    """(queries, jax QuantizedGallery, port QuantizedGallery) over one set
    of int8 rows: 300 rows (not a multiple of the JAX tile of 128), rows
    150..159 duplicates of rows 0..9 (exact ties)."""
    rng = np.random.RandomState(2)
    emb = _unit(rng, 300, 64)
    emb[150:160] = emb[:10]
    queries = _unit(rng, 12, 64)
    queries[:4] = emb[:4]
    jq = jax_quant.quantize_rows(jnp.asarray(emb))
    pq = quant.QuantizedGallery(torch.from_numpy(np.array(jq.values)),
                                torch.from_numpy(np.array(jq.scales)))
    return queries, jq, pq


def test_quantized_scores_match_jax(gallery):
    queries, jq, pq = gallery
    want = np.asarray(jax_quant.quantized_scores(jnp.asarray(queries), jq))
    got = quant.quantized_scores(torch.from_numpy(queries), pq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _same_outside_ties(idx, want_idx, scores):
    """Indices equal, or both rows' scores exactly equal."""
    for r, j in zip(*np.nonzero(idx != want_idx)):
        assert scores[r, idx[r, j]] == scores[r, want_idx[r, j]], (r, j)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_plain_quantized_topk_matches_pallas_interpret(gallery, k):
    queries, jq, pq = gallery
    want_v, want_i = topk_similarity_quantized_padded(
        jnp.asarray(queries), jq, k=k, query_tile=8, gallery_tile=128,
        interpret=True)
    got_v, got_i = ranking.topk_similarity_quantized(
        torch.from_numpy(queries), pq.values, pq.scales, k=k)
    assert got_v.shape == (12, k) and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5,
                               atol=1e-6)
    # the same tie rule on both sides (the larger row first), so the
    # duplicated rows come back in the same order
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i[0, 0] == 150  # query 0 = rows 0 and 150: the larger first
    if k > 1:
        assert got_i[0, 1] == 0


def test_plain_quantized_topk_matches_quantized_topk(gallery):
    queries, jq, pq = gallery
    want_v, want_i = jax_quant.quantized_topk(jnp.asarray(queries), jq, 10)
    got_v, got_i = ranking.topk_similarity_quantized_plain(
        torch.from_numpy(queries), pq.values, pq.scales, 10)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5,
                               atol=1e-6)
    scores = quant.quantized_scores(torch.from_numpy(queries), pq).numpy()
    _same_outside_ties(got_i.numpy(), np.asarray(want_i), scores)
    port_v, port_i = quant.quantized_topk(torch.from_numpy(queries), pq, 10)
    np.testing.assert_allclose(port_v.numpy(), np.asarray(want_v), rtol=1e-5,
                               atol=1e-6)
    _same_outside_ties(port_i.numpy(), np.asarray(want_i), scores)


def test_valid_gallery_masks_the_tail_and_k_past_it_gives_sentinels(gallery):
    queries, _, pq = gallery
    vals, idx = ranking.topk_similarity_quantized(
        torch.from_numpy(queries), pq.values, pq.scales, k=40,
        valid_gallery=30)
    assert (idx[:, :30] < 30).all() and (idx[:, :30] >= 0).all()
    assert (idx[:, 30:] == -1).all()
    assert (vals[:, 30:] == ranking.NEG_INF).all()


def test_cuda_entry_refuses_what_it_cannot_launch(gallery):
    queries, _, pq = gallery
    q = torch.from_numpy(queries)
    with pytest.raises(ValueError, match="must be on"):
        ranking._topk_quantized_cuda(q, pq.values, pq.scales, 5, 0)
    with pytest.raises(ValueError, match="k <= 64"):
        ranking._topk_quantized_cuda(q, pq.values, pq.scales, 65, 0)
    with pytest.raises(ValueError, match="D % 16"):
        ranking._topk_quantized_cuda(q[:, :40], pq.values[:, :40], pq.scales,
                                     5, 0)
    with pytest.raises(TypeError, match="int8"):
        ranking._topk_quantized_cuda(q, pq.values.float(), pq.scales, 5, 0)


@pytest.mark.parametrize("dim", [100, 1024])
def test_any_width_matches_pallas_interpret(dim):
    """D off the int8 kernel's multiple of 16 (100) and past the 768
    columns it stages at once (1,024): the wrapper pads the int8 rows and
    the queries with zero columns, which change neither the row scales nor
    a score; the plain version equals the JAX kernel's top-k in interpret
    mode (scores rtol 1e-5, indices equal outside exact ties)."""
    rng = np.random.RandomState(dim)
    emb = _unit(rng, 200, dim)
    emb[120] = emb[3]
    queries = _unit(rng, 9, dim)
    queries[0] = emb[3]
    jq = jax_quant.quantize_rows(jnp.asarray(emb))
    values = torch.from_numpy(np.array(jq.values))
    scales = torch.from_numpy(np.array(jq.scales))
    want_v, want_i = topk_similarity_quantized_padded(
        jnp.asarray(queries), jq, k=10, query_tile=8, gallery_tile=128,
        interpret=True)
    padded = ranking.pad_columns(values, 16)
    assert padded.shape[1] % 16 == 0
    assert torch.equal(quant.quantize_rows(ranking.pad_columns(
        torch.from_numpy(emb), 16)).scales,
        quant.quantize_rows(torch.from_numpy(emb)).scales)
    for gal in (values, padded):
        got_v, got_i = ranking.topk_similarity_quantized(
            torch.from_numpy(queries), gal, scales, k=10)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-5, atol=1e-6)
        scores = quant.quantized_scores(
            torch.from_numpy(queries), quant.QuantizedGallery(
                values, scales)).numpy()
        _same_outside_ties(got_i.numpy(), np.asarray(want_i), scores)
        assert got_i[0, :2].tolist() == [120, 3]
