"""The port's streaming top-k (plain version, the CUDA kernel's contract)
against the JAX Pallas kernel in interpret mode, on the CPU.

Scores agree to atol 1e-6 (float32 dot products of length 16 in another
order); indices are exact, including on exact ties from duplicated gallery
rows, where the larger row must come first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.ops.ranking_pallas import NEG_INF as JAX_NEG_INF
from textreid_tpu.ops.ranking_pallas import topk_similarity_padded
from textreid_torch.ops.ranking import (
    NEG_INF,
    topk_similarity,
    topk_similarity_plain,
)

torch.set_num_threads(2)


def _both(q, g, k, valid_gallery=0):
    """(port, jax) results for the same inputs; the JAX call masks rows
    past ``valid_gallery`` by trimming the gallery it is given."""
    jg = g[:valid_gallery] if valid_gallery else g
    jv, ji = topk_similarity_padded(jnp.asarray(q), jnp.asarray(jg), k=k,
                                    query_tile=8, gallery_tile=8,
                                    interpret=True)
    pv, pi = topk_similarity(torch.from_numpy(q), torch.from_numpy(g), k=k,
                             valid_gallery=valid_gallery)
    return (pv.numpy(), pi.numpy()), (np.asarray(jv), np.asarray(ji))


def _check(port, jax_out):
    (pv, pi), (jv, ji) = port, jax_out
    np.testing.assert_allclose(pv, jv, atol=1e-6)
    np.testing.assert_array_equal(pi, ji)
    assert pi.dtype == np.int32 and pv.dtype == np.float32


def _unit(rng, n, d=16):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n_q,n_g,k", [
    (5, 21, 4),    # G not a multiple of the tile, ragged Q
    (8, 24, 1),    # k = 1
    (3, 6, 10),    # k > G: sentinel slots
    (16, 40, 8),   # several tiles on both axes
])
def test_matches_pallas_kernel(n_q, n_g, k):
    rng = np.random.RandomState(n_q * 100 + n_g)
    _check(*_both(_unit(rng, n_q), _unit(rng, n_g), k))


def test_ties_prefer_the_larger_row():
    rng = np.random.RandomState(1)
    g = _unit(rng, 12)
    g[7] = g[2]
    g[11] = g[2]  # three identical rows: exact score ties
    q = np.concatenate([g[2:3], _unit(rng, 4)])
    port, jax_out = _both(q, g, 5)
    _check(port, jax_out)
    np.testing.assert_array_equal(port[1][0, :3], [11, 7, 2])


def test_sentinels_past_the_gallery():
    rng = np.random.RandomState(2)
    (pv, pi), _ = _both(_unit(rng, 3), _unit(rng, 6), 10)
    assert (pv[:, 6:] == NEG_INF).all() and (pi[:, 6:] == -1).all()
    assert NEG_INF == JAX_NEG_INF


def test_valid_gallery_masks_trailing_rows():
    rng = np.random.RandomState(3)
    q, g = _unit(rng, 4), _unit(rng, 20)
    g[15:] = q[0]  # masked rows that would otherwise win
    _check(*_both(q, g, 6, valid_gallery=15))


def test_plain_matches_a_full_sort():
    rng = np.random.RandomState(4)
    q, g = _unit(rng, 6, 32), _unit(rng, 50, 32)
    vals, idx = topk_similarity_plain(torch.from_numpy(q),
                                      torch.from_numpy(g), 7)
    sim = q @ g.T
    want = np.argsort(-sim, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_allclose(vals.numpy(),
                               np.take_along_axis(sim, want, 1), atol=1e-6)


def _bf16_both(q, g, k, valid_gallery=0):
    """(port plain version, JAX kernel in interpret mode), both with the
    bf16 compute option on the same float32 inputs."""
    from textreid_tpu.ops.ranking_pallas import topk_similarity as jax_topk

    jv, ji = jax_topk(jnp.asarray(q), jnp.asarray(g), k=k, query_tile=8,
                      gallery_tile=8, valid_gallery=valid_gallery,
                      interpret=True, compute_dtype=jnp.bfloat16)
    pv, pi = topk_similarity(torch.from_numpy(q), torch.from_numpy(g), k=k,
                             valid_gallery=valid_gallery,
                             compute_dtype=torch.bfloat16)
    return (pv.numpy(), pi.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("n_q,n_g,k,valid,seed", [
    (8, 32, 4, 0, 6), (16, 64, 10, 0, 7), (8, 40, 1, 0, 8),
    (8, 48, 6, 37, 9), (24, 24, 24, 0, 10)])
def test_bf16_compute_matches_the_pallas_kernel(n_q, n_g, k, valid, seed):
    """``compute_dtype=bfloat16``: both operands rounded to bf16, products
    summed in f32.  Scores within 1e-5 of the JAX kernel's; indices equal
    outside exact ties (two rows whose bf16 scores are the same float)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n_q, 16).astype(np.float32)
    g = rng.randn(n_g, 16).astype(np.float32)
    (pv, pi), (jv, ji) = _bf16_both(q, g, k, valid)
    np.testing.assert_allclose(pv, jv, atol=1e-5)
    assert pi.dtype == np.int32 and pv.dtype == np.float32
    differ = pi != ji
    assert np.all(np.abs(pv[differ] - jv[differ]) <= 1e-5)
    # the rounding is real: the f32 scores differ from the bf16 ones
    fv, _ = topk_similarity(torch.from_numpy(q), torch.from_numpy(g), k=k,
                            valid_gallery=valid)
    assert np.abs(fv.numpy() - pv).max() > 1e-4
    if valid:
        assert pi.max() < valid


def test_bf16_compute_keeps_the_tie_rule_and_the_mask():
    """Duplicated gallery rows tie exactly after the rounding too: the
    larger row comes first; rows past ``valid_gallery`` never rank."""
    rng = np.random.RandomState(11)
    q = rng.randn(4, 16).astype(np.float32)
    g = rng.randn(20, 16).astype(np.float32)
    g[17] = g[2]
    g[19] = g[5]  # masked below
    vals, idx = topk_similarity_plain(torch.from_numpy(q),
                                      torch.from_numpy(g), 18, 18,
                                      torch.bfloat16)
    for row in idx.tolist():
        assert row.index(17) < row.index(2) and 19 not in row
    want = (torch.from_numpy(q).bfloat16().float()
            @ torch.from_numpy(g[:18]).bfloat16().float().T)
    assert torch.equal(vals, want.sort(dim=1, descending=True).values)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_compute_dtype_must_be_f32_or_bf16(dtype):
    q = torch.zeros(3, 8)
    with pytest.raises(TypeError, match="compute_dtype"):
        topk_similarity(q, q, k=2, compute_dtype=dtype)
    with pytest.raises(TypeError, match="compute_dtype"):
        topk_similarity_plain(q, q, 2, compute_dtype=dtype)
