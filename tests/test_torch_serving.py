"""The serving slice as a whole: the JAX ``RetrievalIndex`` (with its Pallas
top-k in interpret mode) against the port's ``RetrievalIndex`` on weights
carried over by ``state_dict_from_jax``, on the CPU in float32.

A narrow ModifiedResNet (width 8) and a bi-GRU with H=16 over a frozen
table; 24 gallery images (the last dropped as a pad row through
``valid_rows``), 6 text queries.  Gallery embeddings and scores
agree to atol 1e-4 (convolutions sum in another order), meta exactly.
Index files cross between the packages both ways, and one HTTP round trip
runs through the port's own ``textreid_torch.server`` front.

With ``quantize=True`` both indexes rank from the int8 form of the gallery
(JAX through its plain path, ``use_pallas=False``; the port through the
plain version of its int8 kernel): the same top-k outside ties of exactly
equal scores, scores rtol 1e-5 once both sides hold the same int8 rows;
quantized index files cross both ways, and stored int8 rows of the wrong
shape are derived again.
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
from textreid_tpu.serving import RetrievalIndex as JaxRetrievalIndex
from textreid_torch.models import BiGRUEncoder, TextReIDModel
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.server import RetrievalService, make_server
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
def indexes(_built):
    """(jax index, port index), both holding the same 23-row gallery."""
    return _built[0], _built[1]


@pytest.fixture(scope="module")
def quantized(_built):
    """(jax index, port index) with ``quantize=True``, same gallery; the
    port's int8 rows are derived from its own float gallery."""
    return _built[2], _built[3]


@pytest.fixture(scope="module")
def _built():
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

    jax_quant = JaxRetrievalIndex(jax_model, state, query_batch=4,
                                  use_pallas=False, quantize=True)
    port_quant = RetrievalIndex(model, query_batch=4, quantize=True)

    batches = [rng.randint(0, 255, (8, 64, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    meta = np.arange(500, 524)
    built = (jax_index, port_index, jax_quant, port_quant)
    for index in built:
        index.build_gallery(batches, meta=meta, valid_rows=23)
    return built


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
    """Every option of the JAX index is ported.  A gallery sharded over
    devices (``mesh=``, see ``tests/test_torch_retrieval.py``), also on a
    mesh with a tensor-parallel model axis: sharded over ``data``,
    replicated over ``model``, as JAX's ``shard_map`` with ``P(DATA_AXIS)``
    (its 23 rows: the augmented pad rows), answering as JAX's index on a
    ``data 2 x model 2`` mesh does.  The int8 encoders of this
    ModifiedResNet tower: the int8-dataflow trunk (``True``,
    ``"dataflow"``), calibrated when the gallery is built, and the
    interceptor (``"intercept"``)."""
    from textreid_tpu.parallel import make_mesh as jax_make_mesh
    from textreid_torch.parallel import make_mesh

    jax_index, port_index = indexes
    cpus = [torch.device("cpu", i) for i in range(4)]
    batches = [np.random.RandomState(0).randint(0, 255, (8, 64, 32, 3),
                                                dtype=np.uint8)
               for _ in range(3)]
    got = RetrievalIndex(port_index.model, query_batch=4,
                         mesh=make_mesh(2, 2, devices=cpus))
    want = JaxRetrievalIndex(jax_index.model, jax_index.state,
                             query_batch=4, mesh=jax_make_mesh(2, 2),
                             use_pallas=True)
    for index in (got, want):
        index.build_gallery(batches, meta=np.arange(24), valid_rows=23)
    assert got.mesh.shape == {"data": 2, "model": 2}
    assert [d.index for d in got.mesh.shard_devices] == [0, 2]
    assert len(got._mesh_shards) == 2
    assert got._augmented and want._augmented
    ids, lens = _queries()
    got_s, got_m = got.search(ids, lens, k=5)
    want_s, want_m = want.search(ids, lens, k=5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4)
    np.testing.assert_array_equal(got_m, want_m)
    sharded = RetrievalIndex(port_index.model, mesh=make_mesh(2, devices=cpus))
    assert sharded.mesh.shape["data"] == 2
    for kwargs in ({"int8_encode": True},
                   {"quantize": True, "int8_encode": "dataflow"}):
        assert RetrievalIndex(port_index.model, **kwargs)._int8_pending
    index = RetrievalIndex(port_index.model, int8_encode="intercept")
    assert index._int8_image_encoder is not None


def _share_int8_rows(jax_index, port_index):
    """Give the port the JAX index's int8 rows, so that scores compare at
    rtol 1e-5 (a float gallery that differs by 1e-5 may round a value to
    the next int8 step)."""
    from textreid_torch.ops.quant import QuantizedGallery

    port_index._quant_gallery = QuantizedGallery(
        torch.from_numpy(np.array(jax_index._quant_gallery.values)),
        torch.from_numpy(np.array(jax_index._quant_gallery.scales)))


def _assert_same_topk(got, want, scores_of):
    """Scores rtol 1e-5; meta equal, or a swap within exactly equal
    scores."""
    (got_s, got_m), (want_s, want_m) = got, want
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=1e-5,
                               atol=1e-6)
    for r, j in zip(*np.nonzero(got_m != want_m)):
        assert scores_of(r, got_m[r, j]) == scores_of(r, want_m[r, j])


def test_quantized_gallery_is_within_one_step_of_jax(quantized):
    jax_index, port_index = quantized
    got, want = port_index._quant_gallery, jax_index._quant_gallery
    assert got.values.dtype == torch.int8 and got.values.shape == (23, 12)
    step = np.abs(got.values.numpy().astype(np.int32)
                  - np.asarray(want.values).astype(np.int32))
    assert step.max() <= 1
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales),
                               rtol=1e-4)


@pytest.mark.parametrize("k", [1, 5, 30, 100])  # 30: k > G, 100: k > 64
def test_quantized_search_matches_jax(quantized, k):
    jax_index, port_index = quantized
    kept = port_index._quant_gallery
    _share_int8_rows(jax_index, port_index)
    try:
        ids, lens = _queries()
        want = jax_index.search(ids, lens, k=k)
        got = port_index.search(ids, lens, k=k)
        from textreid_torch.ops.quant import quantized_scores
        scores = quantized_scores(
            torch.from_numpy(port_index.encode_queries(ids, lens)),
            port_index._quant_gallery).numpy()
        row_of = {m: r for r, m in enumerate(port_index.gallery_meta)}
        assert got[0].shape == (6, k) and got[1].shape == (6, k)
        _assert_same_topk(got, want,
                          lambda r, m: scores[r, row_of[int(m)]])
        if k > 23:
            assert np.isneginf(got[0][:, 23:]).all()
            assert (got[1][:, 23:] == -1).all()
        pixels = np.random.RandomState(4).randint(0, 255, (3, 64, 32, 3),
                                                  dtype=np.uint8)
        img_scores = quantized_scores(
            torch.from_numpy(port_index.encode_image_queries(pixels)),
            port_index._quant_gallery).numpy()
        _assert_same_topk(port_index.search_by_image(pixels, k=k),
                          jax_index.search_by_image(pixels, k=k),
                          lambda r, m: img_scores[r, row_of[int(m)]])
    finally:
        port_index._quant_gallery = kept


def test_quantized_scores_stay_within_the_int8_error(indexes, quantized):
    """Each id the int8 gallery returns scores, in float, within the int8
    rounding error of its quantized score."""
    _, port_float = indexes
    _, port_index = quantized
    ids, lens = _queries()
    scores, meta = port_index.search(ids, lens, k=5)
    full = port_float.encode_queries(ids, lens) @ port_float.gallery.numpy().T
    row_of = {m: r for r, m in enumerate(port_index.gallery_meta)}
    # |q . (g - dequant(g))| <= ||q||_1 scale / 2, and the query's bf16
    # rounding adds 2^-9 relative
    bound = 0.5 * float(port_index._quant_gallery.scales.max()) * np.sqrt(12)
    for r in range(6):
        for j in range(5):
            exact = full[r, row_of[int(meta[r, j])]]
            assert abs(exact - scores[r, j]) <= bound + 2.0 ** -8


@pytest.mark.parametrize("gallery", ["float", "int8"])
@pytest.mark.parametrize("n_q", [1, 3, 300])
def test_search_runs_the_text_tower_at_the_query_count(indexes, quantized,
                                                       monkeypatch, n_q,
                                                       gallery):
    """The port's search encodes exactly the ``n_q`` rows it was given (the
    JAX index pads them to 256-row buckets) and still returns the JAX
    index's top-k: the ``"always"`` pool rule makes each query's embedding
    independent of the rows beside it."""
    jax_index, port_index = indexes if gallery == "float" else quantized
    rng = np.random.RandomState(n_q)
    ids = rng.randint(1, 30, (n_q, 10)).astype(np.int32)
    lens = rng.randint(1, 11, n_q).astype(np.int32)
    rows = []
    encode_text = port_index.model.encode_text

    def counted(token_ids, lengths, **kwargs):
        rows.append((token_ids.shape[0], lengths.shape[0]))
        return encode_text(token_ids, lengths, **kwargs)

    monkeypatch.setattr(port_index.model, "encode_text", counted)
    kept = port_index._quant_gallery
    if gallery == "int8":
        _share_int8_rows(jax_index, port_index)
    try:
        got = port_index.search(ids, lens, k=5)
    finally:
        port_index._quant_gallery = kept
        monkeypatch.undo()
    assert rows == [(n_q, n_q)]
    want = jax_index.search(ids, lens, k=5)
    assert got[0].shape == (n_q, 5) and got[1].shape == (n_q, 5)
    if gallery == "float":
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        np.testing.assert_array_equal(got[1], want[1])
    else:
        from textreid_torch.ops.quant import QuantizedGallery, quantized_scores

        shared = QuantizedGallery(
            torch.from_numpy(np.array(jax_index._quant_gallery.values)),
            torch.from_numpy(np.array(jax_index._quant_gallery.scales)))
        scores = quantized_scores(
            torch.from_numpy(port_index.encode_queries(ids, lens)),
            shared).numpy()
        row_of = {m: r for r, m in enumerate(port_index.gallery_meta)}
        _assert_same_topk(got, want, lambda r, m: scores[r, row_of[int(m)]])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quantized_index_files_cross_packages(quantized, tmp_path, writer):
    jax_index, port_index = quantized
    path = str(tmp_path / "gallery.idx")
    src = jax_index if writer == "jax" else port_index
    src.save_index(path)
    with np.load(path) as data:
        assert set(data.files) == {"gallery", "meta", "quant_values",
                                   "quant_scales"}
        stored = data["quant_values"], data["quant_scales"]
        assert stored[0].dtype == np.int8 and stored[1].dtype == np.float32
    if writer == "jax":
        dst = RetrievalIndex(port_index.model, query_batch=4, quantize=True)
    else:
        dst = JaxRetrievalIndex(jax_index.model, jax_index.state,
                                query_batch=4, use_pallas=False,
                                quantize=True)
    dst.load_index(path)
    # the stored int8 rows are reused as they are
    np.testing.assert_array_equal(np.asarray(dst._quant_gallery.values),
                                  stored[0])
    np.testing.assert_array_equal(np.asarray(dst._quant_gallery.scales),
                                  stored[1])
    np.testing.assert_array_equal(dst.gallery_meta, src.gallery_meta)
    ids, lens = _queries()
    got, want = dst.search(ids, lens, k=5), src.search(ids, lens, k=5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    # a float-gallery index loads the quantized file too, and the other way
    plain = RetrievalIndex(port_index.model, query_batch=4)
    plain.load_index(path)
    assert plain._quant_gallery is None and plain.gallery.shape == (23, 12)


def test_float_index_file_is_quantized_at_load(indexes, quantized, tmp_path):
    _, port_float = indexes
    _, port_index = quantized
    path = str(tmp_path / "float.idx")
    port_float.save_index(path)
    with np.load(path) as data:
        assert set(data.files) == {"gallery", "meta"}
    dst = RetrievalIndex(port_index.model, query_batch=4, quantize=True)
    dst.load_index(path)
    np.testing.assert_array_equal(dst._quant_gallery.values.numpy(),
                                  port_index._quant_gallery.values.numpy())


def test_stored_int8_rows_of_the_wrong_shape_are_derived_again(quantized,
                                                               tmp_path):
    _, port_index = quantized
    path = str(tmp_path / "legacy.idx")
    with open(path, "wb") as f:  # int8 rows of a padded, augmented matrix
        np.savez(f, gallery=port_index.gallery.numpy(),
                 meta=port_index.gallery_meta,
                 quant_values=np.ones((24, 13), np.int8),
                 quant_scales=np.ones(24, np.float32))
    dst = RetrievalIndex(port_index.model, query_batch=4, quantize=True)
    dst.load_index(path)
    np.testing.assert_array_equal(dst._quant_gallery.values.numpy(),
                                  port_index._quant_gallery.values.numpy())


def test_a_failed_load_leaves_the_quantized_index_serving(quantized, tmp_path):
    _, port_index = quantized
    path = str(tmp_path / "broken.idx")
    with open(path, "wb") as f:
        np.savez(f, gallery=port_index.gallery.numpy())  # no meta
    before = port_index._quant_gallery
    with pytest.raises(KeyError):
        port_index.load_index(path)
    assert port_index._quant_gallery is before
    assert port_index.gallery.shape == (23, 12)


@pytest.mark.parametrize("quantize", [False, True])
def test_a_legacy_augmented_index_loads_to_the_jax_gallery(
        quantized, tmp_path, quantize):
    """A JAX index file of the legacy mesh layout (``augmented`` set: the
    gallery as ``[G + pad, D + 1]`` with pad rows and a score column, its
    int8 rows quantized from that matrix): both packages strip it back to
    the same ``[G, D]`` gallery, and a quantized index quantizes the clean
    gallery again instead of taking the stored rows."""
    jax_index, port_index = quantized
    clean = np.array(jax_index.gallery)
    rng = np.random.RandomState(12)
    aug = np.zeros((clean.shape[0] + 9, clean.shape[1] + 1), np.float32)
    aug[:clean.shape[0], :-1] = clean
    aug[:, -1] = rng.randn(len(aug))
    path = str(tmp_path / "augmented.idx")
    with open(path, "wb") as f:
        np.savez(f, gallery=aug, meta=np.asarray(jax_index.gallery_meta),
                 augmented=np.asarray(True),
                 quant_values=np.ones(aug.shape, np.int8),
                 quant_scales=np.ones(len(aug), np.float32))
    jax_dst = JaxRetrievalIndex(jax_index.model, jax_index.state,
                                query_batch=4, use_pallas=False,
                                quantize=quantize)
    jax_dst.load_index(path)
    dst = RetrievalIndex(port_index.model, query_batch=4, quantize=quantize)
    dst.load_index(path)
    want = np.asarray(jax_dst.gallery)
    assert dst.gallery.shape == want.shape == clean.shape
    np.testing.assert_array_equal(dst.gallery.numpy(), want)
    np.testing.assert_array_equal(dst.gallery_meta, jax_dst.gallery_meta)
    if quantize:
        from textreid_torch.ops.quant import quantize_rows

        again = quantize_rows(torch.from_numpy(clean))
        assert torch.equal(dst._quant_gallery.values, again.values)
        assert torch.equal(dst._quant_gallery.scales, again.scales)
    ids, lens = _queries()
    got = dst.search(ids, lens, k=5)
    assert got[1].shape == (6, 5) and np.isin(got[1], dst.gallery_meta).all()


@pytest.mark.parametrize("dim", [100, 1024])
@pytest.mark.parametrize("quantize", [False, True])
def test_search_answers_at_a_width_off_the_kernels_multiple(quantize, dim):
    """``FEATURE_SIZE`` 100 (off the int8 kernel's multiple of 16) and
    1,024 (past the 768 columns the kernels stage at once): the index pads
    its gallery once where it must, and the queries on each call;
    ``search`` answers with the top-k of the unpadded scores (for the int8
    gallery, ``quantized_scores`` of the unpadded rows), and the index
    keeps the unpadded gallery."""
    from textreid_torch.ops.quant import quantized_scores

    torch.manual_seed(0)
    model = TextReIDModel(ModifiedResNet(**VISUAL), BiGRUEncoder(**TEXT),
                          dim, pixel_mean=MEAN, pixel_std=STD).eval()
    index = RetrievalIndex(model, query_batch=4, quantize=quantize)
    rng = np.random.RandomState(4)
    index.build_gallery([rng.randint(0, 255, (8, 64, 32, 3), dtype=np.uint8)
                         for _ in range(2)], meta=np.arange(100, 116))
    assert index.gallery.shape == (16, dim)
    ids, lens = _queries()
    scores, meta = index.search(ids, lens, k=5)
    queries = torch.from_numpy(index.encode_queries(ids, lens))
    if quantize:
        sim = quantized_scores(queries, index._quant_gallery)
        assert index._kernel_gallery().shape == (16, -(-dim // 16) * 16)
    else:
        sim = queries @ index.gallery.T
        assert index._kernel_gallery() is index.gallery  # dim % 4 == 0
    want = torch.sort(sim.flip(1), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(meta, 100 + 15 - want.indices[:, :5].numpy())
    np.testing.assert_allclose(scores, want.values[:, :5].numpy(), rtol=1e-6,
                               atol=1e-6)
