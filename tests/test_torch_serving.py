"""The serving slice as a whole: the JAX ``RetrievalIndex`` (with its Pallas
top-k in interpret mode) against the port's ``RetrievalIndex`` on weights
carried over by ``state_dict_from_jax``, on the CPU in float32.

A narrow ModifiedResNet (width 8) and a bi-GRU with H=16 over a frozen
table; 24 gallery images (the last dropped as a pad row through
``valid_rows``), 6 text queries.  Gallery embeddings and scores
agree to atol 1e-4 (convolutions sum in another order), meta exactly.
Index files cross between the packages both ways, and one HTTP round trip
runs through the shared ``textreid_tpu.server`` front.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.engine.state import TrainState
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxTextReIDModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.server import RetrievalService, make_server
from textreid_tpu.serving import RetrievalIndex as JaxRetrievalIndex
from textreid_torch.models import BiGRUEncoder, TextReIDModel
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.serving import RetrievalIndex
from textreid_torch.utils.weight_convert import (
    load_reference_state_dict,
    state_dict_from_jax,
)

torch.set_num_threads(2)

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
VISUAL = dict(layers=(1, 1, 1, 1), output_dim=16, heads=2, last_stride=1,
              input_resolution=(64, 32), width=8)
TEXT = dict(hidden_dim=16, vocab_size=30, embed_size=8, use_onehot="clip_vit",
            allow_random_table=True)


def _randomized(tree, rng):
    """Seeded values for every leaf.  Biases are zero so that the embedding
    follows the image, not a shared offset (with one, random-noise images
    embed to near-identical vectors and every ranking is a near-tie)."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        if "bias" in name or "mean" in name:
            return np.zeros(x.shape, np.float32)
        return (rng.randn(*x.shape) * 0.3).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def indexes():
    """(jax index, port index), both holding the same 23-row gallery."""
    jax_model = JaxTextReIDModel(
        visual=JaxModifiedResNet(**VISUAL), textual=JaxBiGRU(**TEXT),
        feature_size=12, num_classes=5, pixel_mean=MEAN, pixel_std=STD)
    variables = jax.jit(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3), jnp.uint8),
        jnp.ones((1, 6), jnp.int32), jnp.ones((1,), jnp.int32),
        method="init_all"))()
    rng = np.random.RandomState(0)
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params=_randomized(variables["params"], rng),
        batch_stats=_randomized(variables["batch_stats"], rng),
        constants=variables["constants"], opt_state=None)
    jax_index = JaxRetrievalIndex(jax_model, state, query_batch=4,
                                  use_pallas=True)

    model = TextReIDModel(ModifiedResNet(**VISUAL), BiGRUEncoder(**TEXT), 12,
                          pixel_mean=MEAN, pixel_std=STD).eval()
    load_reference_state_dict(model, state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats,
         "constants": state.constants}))
    port_index = RetrievalIndex(model, query_batch=4)

    batches = [rng.randint(0, 255, (8, 64, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    meta = np.arange(500, 524)
    jax_index.build_gallery(batches, meta=meta, valid_rows=23)
    port_index.build_gallery(batches, meta=meta, valid_rows=23)
    return jax_index, port_index


def _queries(n=6, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 30, (n, 10)).astype(np.int32)
    lens = np.array([10, 4, 1, 7, 10, 2][:n], np.int32)
    return ids, lens


def test_gallery_embeddings_match(indexes):
    jax_index, port_index = indexes
    assert port_index.gallery.shape == (23, 12)
    np.testing.assert_allclose(port_index.gallery.numpy(),
                               np.asarray(jax_index.gallery), atol=1e-4)
    np.testing.assert_array_equal(port_index.gallery_meta,
                                  jax_index.gallery_meta)


@pytest.mark.parametrize("k", [1, 5, 30, 100])  # 30: k > G, 100: k > 64
def test_search_matches_jax(indexes, k):
    jax_index, port_index = indexes
    ids, lens = _queries()
    want_s, want_m = jax_index.search(ids, lens, k=k)
    got_s, got_m = port_index.search(ids, lens, k=k)
    assert got_s.shape == (6, k) and got_m.shape == (6, k)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4)
    np.testing.assert_array_equal(got_m, want_m)
    if k > 23:  # the sentinel contract past the gallery
        assert np.isneginf(got_s[:, 23:]).all() and (got_m[:, 23:] == -1).all()


def test_encode_queries_match_jax(indexes):
    jax_index, port_index = indexes
    ids, lens = _queries()
    np.testing.assert_allclose(port_index.encode_queries(ids, lens),
                               jax_index.encode_queries(ids, lens), atol=1e-4)


def test_search_by_image_matches_jax(indexes):
    jax_index, port_index = indexes
    pixels = np.random.RandomState(4).randint(0, 255, (3, 64, 32, 3),
                                              dtype=np.uint8)
    want_s, want_m = jax_index.search_by_image(pixels, k=5)
    got_s, got_m = port_index.search_by_image(pixels, k=5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4)
    np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_files_cross_packages(indexes, tmp_path, writer):
    jax_index, port_index = indexes
    path = str(tmp_path / "gallery.idx")
    src, dst = ((jax_index, port_index) if writer == "jax"
                else (port_index, jax_index))
    before = np.array(np.asarray(dst.gallery))
    src.save_index(path)
    dst.load_index(path)
    np.testing.assert_array_equal(np.asarray(dst.gallery),
                                  np.asarray(src.gallery))
    np.testing.assert_array_equal(dst.gallery_meta, src.gallery_meta)
    ids, lens = _queries()
    np.testing.assert_array_equal(dst.search(ids, lens, k=5)[1],
                                  src.search(ids, lens, k=5)[1])
    np.testing.assert_allclose(np.asarray(dst.gallery), before, atol=1e-4)


def test_http_round_trip(indexes):
    _, port_index = indexes
    service = RetrievalService(port_index, max_text_length=10,
                               image_shape=(64, 32))
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ids, lens = _queries(2)
        body = json.dumps({"token_ids": ids.tolist(),
                           "lengths": lens.tolist(), "k": 3}).encode()
        url = "http://127.0.0.1:%d/search" % server.server_address[1]
        with urllib.request.urlopen(url, data=body, timeout=30) as resp:
            reply = json.loads(resp.read())
        want_s, want_m = port_index.search(ids, lens, k=3)
        assert reply["meta"] == want_m.tolist()
        np.testing.assert_allclose(reply["scores"], want_s, atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_unported_options_raise(indexes):
    _, port_index = indexes
    for kwargs in ({"mesh": object()}, {"quantize": True},
                   {"int8_encode": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RetrievalIndex(port_index.model, **kwargs)
