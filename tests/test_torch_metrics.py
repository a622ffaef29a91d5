"""The port's retrieval metrics against the JAX package on seeded
embeddings, on the CPU: CMC and mAP within 1e-6 as fractions (1e-4 of a
percent point: both are float32 means scaled to percent, where one ulp at
90 is 8e-6), the similarity and re-ranking matrices atol 1e-5, rank orders
equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.evaluation import metrics as jax_metrics
from textreid_torch.evaluation import metrics

torch.set_num_threads(2)

PCT_ATOL = 1e-4


def _toy(seed=0, n=48, d=16, ids=8, noise=0.8):
    """Clustered embeddings; every image id appears twice (two captions)."""
    rng = np.random.RandomState(seed)
    pids = np.repeat(np.arange(ids), n // ids)
    image_ids = np.arange(n) // 2
    centers = rng.randn(ids, d).astype(np.float32)
    img = centers[pids] + rng.randn(n, d).astype(np.float32) * noise
    img = img[image_ids * 2]  # the two samples of an image share its pixels
    txt = centers[pids] + rng.randn(n, d).astype(np.float32) * noise
    return img, txt, pids.astype(np.int32), image_ids.astype(np.int32)


@pytest.mark.parametrize("get_map", [True, False])
def test_rank_matches_jax(get_map):
    rng = np.random.RandomState(1)
    sim = rng.randn(20, 30).astype(np.float32)
    sim[:, 7] = sim[:, 3]  # exact ties: the lower index ranks first
    q_pids = rng.randint(0, 6, 20)
    g_pids = rng.randint(0, 6, 30)
    g_pids[g_pids == 5] = 4  # queries with pid 5 have no match: AP = 0
    want = jax_metrics.rank(jnp.asarray(sim), jnp.asarray(q_pids),
                            jnp.asarray(g_pids), get_map=get_map)
    got = metrics.rank(torch.from_numpy(sim), torch.from_numpy(q_pids),
                       torch.from_numpy(g_pids), get_map=get_map)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=PCT_ATOL)
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    if get_map:
        assert abs(float(got[1]) - float(want[1])) < PCT_ATOL


@pytest.mark.parametrize("neighbor_num", [5, 100])  # 100 > G: clamped
def test_k_reciprocal_matches_jax(neighbor_num):
    img, txt, _, _ = _toy(2)
    img = img / np.linalg.norm(img, axis=1, keepdims=True)
    txt = txt / np.linalg.norm(txt, axis=1, keepdims=True)
    want = jax_metrics.k_reciprocal(jnp.asarray(txt), jnp.asarray(img[:30]),
                                    neighbor_num)
    got = metrics.k_reciprocal(torch.from_numpy(txt),
                               torch.from_numpy(img[:30]), neighbor_num)
    assert got.shape == (48, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got.max() <= 0.05 + 1e-7


@pytest.mark.parametrize("rerank", [True, False])
def test_evaluation_matches_jax(rerank):
    img, txt, pids, image_ids = _toy(3)
    want = jax_metrics.evaluation(img, txt, pids, pids, image_ids,
                                  rerank=rerank)
    got = metrics.evaluation(img, txt, pids, pids, image_ids, rerank=rerank)
    assert set(got) == set(want)
    assert got["similarity"].shape == (48, 24)  # gallery deduped by image id
    cols = ("t2i", "i2t") + (("re_t2i", "re_i2t") if rerank else ())
    for col in cols:
        assert got[col]["topk"] == [1, 5, 10]
        np.testing.assert_allclose(got[col]["cmc"], want[col]["cmc"],
                                   atol=PCT_ATOL)
        assert abs(got[col]["mAP"] - want[col]["mAP"]) < PCT_ATOL
    assert 0 < got["t2i"]["cmc"][0] < 100  # a grid with something to get wrong
    mats = ("similarity",) + (("rvn_mat", "rtn_mat") if rerank else ())
    for name in mats:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5)
    for name in ("image_pid", "text_pid"):
        np.testing.assert_array_equal(got[name], want[name])
    assert (metrics.format_results_table(got)
            == jax_metrics.format_results_table(want))


def test_evaluation_takes_tensors_and_keeps_their_device():
    img, txt, pids, image_ids = _toy(4)
    from_numpy = metrics.evaluation(img, txt, pids, pids, image_ids)
    from_tensors = metrics.evaluation(torch.from_numpy(img),
                                      torch.from_numpy(txt), pids, pids,
                                      image_ids)
    np.testing.assert_array_equal(from_numpy["similarity"],
                                  from_tensors["similarity"])
    assert from_numpy["re_t2i"] == from_tensors["re_t2i"]


def test_get_unique_indices_keeps_first_occurrences_in_order():
    ids = np.array([5, 3, 5, 9, 3, 1])
    np.testing.assert_array_equal(metrics.get_unique_indices(ids),
                                  jax_metrics.get_unique_indices(ids))
    np.testing.assert_array_equal(metrics.get_unique_indices(ids),
                                  [0, 1, 3, 5])
