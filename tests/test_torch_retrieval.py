"""The port's sharded gallery (``textreid_torch/evaluation/retrieval.py``,
``RetrievalIndex(mesh=)``) against the JAX package's on the CPU.

``sharded_topk_retrieval`` and its int8 composition at 2 and 4 shards on
the same queries and gallery as JAX's on a CPU mesh of the same size
(JAX's Pallas top-k in interpret mode, whose ties go to the larger row as
the port's kernel's do): scores within 1e-6, indices equal.  The shards
of the port's mesh are all on the CPU (a device may hold several shards).
Then the mirror of ``tests/test_retrieval.py``'s cases (winners planted in
different shards, the uneven gallery and the infeasible k refused), and
``RetrievalIndex(mesh=)`` float and int8 at a gallery of 23 rows (2 and 4
shards: the augmented pad rows) against JAX's mesh index (embeddings of
two packages: atol 1e-4, meta equal, as ``test_torch_serving.py``) and
against the port's unsharded index (scores within 1e-6, meta equal), and
its ``save_index`` / ``load_index`` round trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.evaluation.retrieval import (
    sharded_topk_retrieval as jax_sharded,
    sharded_topk_retrieval_quantized as jax_sharded_quantized,
)
from textreid_tpu.ops.quant import quantize_rows as jax_quantize_rows
from textreid_tpu.parallel import make_mesh as jax_make_mesh
from textreid_tpu.serving import RetrievalIndex as JaxRetrievalIndex
from textreid_torch.evaluation.retrieval import (
    _plan_shards,
    shard_rows,
    sharded_topk_retrieval,
    sharded_topk_retrieval_quantized,
)
from textreid_torch.ops.quant import quantize_rows, quantized_topk
from textreid_torch.parallel import make_mesh
from textreid_torch.serving import RetrievalIndex

from test_torch_serving import _built, _queries  # noqa: F401 (fixture)

torch.set_num_threads(2)

CPU = torch.device("cpu")


def cpu_mesh(n):
    return make_mesh(n, devices=[CPU] * n)


def normalized(rng, rows, dim):
    x = rng.randn(rows, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_sharded_topk_matches_jax(shards, k):
    rng = np.random.RandomState(shards * 10 + k)
    q, g = normalized(rng, 12, 16), normalized(rng, 64, 16)
    want_v, want_i = jax_sharded(jax_make_mesh(shards), jnp.asarray(q),
                                 jnp.asarray(g), k=k, use_pallas=True,
                                 interpret=True)
    got_v, got_i = sharded_topk_retrieval(cpu_mesh(shards),
                                          torch.from_numpy(q),
                                          torch.from_numpy(g), k=k)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_topk_quantized_matches_jax(shards):
    rng = np.random.RandomState(shards)
    q, g = normalized(rng, 12, 16), normalized(rng, 64, 16)
    want_v, want_i = jax_sharded_quantized(
        jax_make_mesh(shards), jnp.asarray(q),
        jax_quantize_rows(jnp.asarray(g)), k=5, use_pallas=True,
        interpret=True)
    quant = quantize_rows(torch.from_numpy(g))
    got_v, got_i = sharded_topk_retrieval_quantized(
        cpu_mesh(shards), torch.from_numpy(q), quant, k=5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # and the unsharded int8 path's scores (its own tie order aside)
    plain_v, _ = quantized_topk(torch.from_numpy(q), quant, 5)
    np.testing.assert_allclose(got_v.numpy(), plain_v.numpy(), atol=1e-6,
                               rtol=0)


def test_ties_resolve_as_jax_merge():
    """Rows duplicated within a shard and across shards: the merge keeps
    the shard-major candidate order (the lower shard first), the kernel's
    order inside a shard (the larger row first)."""
    rng = np.random.RandomState(7)
    g = normalized(rng, 16, 8)
    g[[1, 3, 9, 14]] = g[5]  # shards of 4: rows 1, 3 | 5 | 9 | 14
    q = np.concatenate([g[5:6], normalized(rng, 3, 8)])
    want_v, want_i = jax_sharded(jax_make_mesh(4), jnp.asarray(q),
                                 jnp.asarray(g), k=6, use_pallas=True,
                                 interpret=True)
    got_v, got_i = sharded_topk_retrieval(cpu_mesh(4), torch.from_numpy(q),
                                          torch.from_numpy(g), k=6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6,
                               rtol=0)
    assert got_i[0, :5].tolist() == [3, 1, 5, 9, 14]


@pytest.mark.parametrize("quantized", [False, True])
def test_winners_cross_shard_boundaries(quantized):
    """Plant the global best matches in different shards."""
    rng = np.random.RandomState(1)
    d = 16
    g = rng.randn(64, d).astype(np.float32) * 0.01
    q = np.zeros((4, d), np.float32)
    planted = {0: 3, 1: 13, 2: 29, 3: 63}  # shards of 16 rows: 0, 0, 1, 3
    for qi, row in planted.items():
        q[qi, qi * 2] = 1.0
        g[row, qi * 2] = 5.0
    gallery = torch.from_numpy(g)
    if quantized:
        _, idx = sharded_topk_retrieval_quantized(
            cpu_mesh(4), torch.from_numpy(q), quantize_rows(gallery), k=1)
    else:
        _, idx = sharded_topk_retrieval(cpu_mesh(4), torch.from_numpy(q),
                                        gallery, k=1)
    assert [int(idx[qi, 0]) for qi in planted] == list(planted.values())


def test_uneven_gallery_and_infeasible_k_rejected():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="must divide"):
        sharded_topk_retrieval(cpu_mesh(4), q, torch.zeros(30, 8), k=2)
    with pytest.raises(ValueError, match="must divide"):
        sharded_topk_retrieval_quantized(
            cpu_mesh(4), q, quantize_rows(torch.randn(30, 8)), k=2)
    with pytest.raises(ValueError, match="infeasible"):
        sharded_topk_retrieval(cpu_mesh(4), q, torch.zeros(8, 8), k=9)
    assert _plan_shards(4, 64, 10) == (16, 10)
    assert _plan_shards(8, 64, 20) == (8, 8)


def test_shards_are_placed_on_the_mesh_devices():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(12, 2)
    parts = shard_rows(mesh, x)
    assert [p.shape[0] for p in parts] == [3] * 4
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)
    assert all(p.device == CPU for p in parts)
    # each shard its own allocation, so aligned as the kernels need even
    # where a shard's first row is not (3 scales of 4 bytes)
    for p in shard_rows(mesh, torch.ones(12)):
        assert p.untyped_storage().data_ptr() == p.data_ptr()


@pytest.fixture(scope="module")
def mesh_indexes(_built):  # noqa: F811
    """{(shards, quantize): (jax mesh index, port mesh index)} over the
    23-row gallery of test_torch_serving.py, and the port's unsharded
    indexes {quantize: index}."""
    jax_index, port_index = _built[:2]
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 255, (8, 64, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    meta = np.arange(500, 524)
    out = {}
    for shards in (2, 4):
        for quantize in (False, True):
            pair = (
                JaxRetrievalIndex(jax_index.model, jax_index.state,
                                  query_batch=4, mesh=jax_make_mesh(shards),
                                  use_pallas=True, quantize=quantize),
                RetrievalIndex(port_index.model, query_batch=4,
                               mesh=cpu_mesh(shards), quantize=quantize))
            for index in pair:
                index.build_gallery(batches, meta=meta, valid_rows=23)
            out[shards, quantize] = pair
    unsharded = {}
    for quantize in (False, True):
        unsharded[quantize] = RetrievalIndex(port_index.model, query_batch=4,
                                             quantize=quantize)
        unsharded[quantize].build_gallery(batches, meta=meta, valid_rows=23)
    return out, unsharded


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("k", [3, 23, 30, 100])
def test_mesh_index_matches_jax_and_the_unsharded_index(mesh_indexes, shards,
                                                        quantize, k):
    pairs, unsharded = mesh_indexes
    jax_index, port_index = pairs[shards, quantize]
    assert port_index._augmented and jax_index._augmented  # 23 rows
    assert port_index.gallery.shape == (23, 12)
    ids, lens = _queries()
    got_s, got_m = port_index.search(ids, lens, k=k)
    want_s, want_m = jax_index.search(ids, lens, k=k)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4 if not quantize
                               else 2e-3)
    np.testing.assert_array_equal(got_m, want_m)
    plain_s, plain_m = unsharded[quantize].search(ids, lens, k=k)
    np.testing.assert_allclose(got_s, plain_s, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_m, plain_m)
    if k > 23:
        assert np.isneginf(got_s[:, 23:]).all() and (got_m[:, 23:] == -1).all()


def test_mesh_image_search_matches_the_unsharded_index(mesh_indexes):
    pairs, unsharded = mesh_indexes
    pixels = np.random.RandomState(4).randint(0, 255, (3, 64, 32, 3),
                                              dtype=np.uint8)
    for quantize in (False, True):
        got = pairs[4, quantize][1].search_by_image(pixels, k=5)
        want = unsharded[quantize].search_by_image(pixels, k=5)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("quantize", [False, True])
def test_mesh_index_round_trip(mesh_indexes, tmp_path, quantize):
    """``save_index`` writes the clean [G, D] matrix; a mesh index and an
    unsharded one load it back to the same replies."""
    built = mesh_indexes[0][4, quantize][1]
    path = str(tmp_path / "gallery.idx")
    built.save_index(path)
    with np.load(path) as data:
        assert data["gallery"].shape == (23, 12)
        np.testing.assert_array_equal(data["gallery"], built.gallery.numpy())
    booted = RetrievalIndex(built.model, query_batch=4, mesh=cpu_mesh(2),
                            quantize=quantize)
    booted.load_index(path)
    assert booted._augmented
    ids, lens = _queries()
    unsharded_boot = RetrievalIndex(built.model, query_batch=4,
                                    quantize=quantize)
    unsharded_boot.load_index(path)
    for index in (booted, unsharded_boot):
        s, m = index.search(ids, lens, k=5)
        want_s, want_m = built.search(ids, lens, k=5)
        np.testing.assert_allclose(s, want_s, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(m, want_m)
