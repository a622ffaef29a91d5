"""A gallery sharded across processes (``textreid_torch/evaluation/
retrieval.py`` on a process-group mesh) against the JAX package's sharded
retrieval on the CPU.

Two gloo ranks (``tests/torch_dp_worker.py``, one launch), each holding
its own ``G / 2`` block of a 64-row gallery (float, and int8 with its
per-row scales), the queries given to data rank 0 alone: every rank's
reply against JAX's ``sharded_topk_retrieval`` and
``sharded_topk_retrieval_quantized`` on a 2-device mesh (its Pallas top-k
in interpret mode): scores within rtol 1e-5, rows equal outside ties (the
gallery has none).
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

from torch_dp_worker import launch

torch.set_num_threads(2)

KS = (1, 5, 32, 40)  # 40: more than a shard's 32 rows


def normalized(rng, rows, dim):
    x = rng.randn(rows, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def replies(tmp_path_factory):
    rng = np.random.RandomState(3)
    payload = {"queries": normalized(rng, 12, 16),
               "gallery": normalized(rng, 64, 16), "ks": KS}
    out = launch("gallery", payload, tmp_path_factory.mktemp("gallery"),
                 world=2)
    return payload, out


def test_each_rank_holds_its_block(replies):
    payload, out = replies
    for rank, got in enumerate(out):
        np.testing.assert_array_equal(got["shard"].numpy(),
                                      payload["gallery"][32 * rank:
                                                         32 * (rank + 1)])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("k", KS)
def test_replies_across_processes_match_jax(replies, quantize, k):
    payload, out = replies
    q, g = jnp.asarray(payload["queries"]), jnp.asarray(payload["gallery"])
    if quantize:
        want_v, want_i = jax_sharded_quantized(
            jax_make_mesh(2), q, jax_quantize_rows(g), k=k, use_pallas=True,
            interpret=True)
    else:
        want_v, want_i = jax_sharded(jax_make_mesh(2), q, g, k=k,
                                     use_pallas=True, interpret=True)
    for got_v, got_i in (rank[quantize, k] for rank in out):
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_i.dtype == torch.int32
