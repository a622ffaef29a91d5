"""The port's losses against the JAX package's, on the same numpy inputs in
f32 on the CPU (rtol 1e-5: the same arithmetic in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.engine.steps import moco_loss_tail as jax_moco_loss_tail
from textreid_tpu.models import losses as jl
from textreid_torch.engine.steps import moco_loss_tail
from textreid_torch.models import losses as tl

N, D, C, K = 8, 16, 11, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return {
        "v": rng.randn(N, D).astype(np.float32),
        "t": rng.randn(N, D).astype(np.float32),
        "proj": rng.randn(D, C).astype(np.float32),
        "labels": np.array([0, 1, 1, 2, 3, 3, 3, 9], np.int32),
        "logits": (rng.randn(N, C) * 3).astype(np.float32),
        "queue_v": rng.randn(K, D).astype(np.float32),
        "queue_t": rng.randn(K, D).astype(np.float32),
        "id_queue": rng.randint(-1, 12, K).astype(np.int32),
    }


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_cross_entropy(data):
    _close(tl.cross_entropy(_t(data["logits"]), _t(data["labels"])),
           jl.cross_entropy(jnp.asarray(data["logits"]), data["labels"]))


@pytest.mark.parametrize("epsilon", [0.1, 0.3])
def test_cross_entropy_label_smooth(data, epsilon):
    _close(tl.cross_entropy_label_smooth(_t(data["logits"]),
                                         _t(data["labels"]), epsilon),
           jl.cross_entropy_label_smooth(jnp.asarray(data["logits"]),
                                         data["labels"], epsilon))


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
@pytest.mark.parametrize("norm", [False, True])
def test_instance_loss(data, epsilon, norm):
    args = (data["proj"], data["v"], data["t"], data["labels"])
    _close(tl.instance_loss(*map(_t, args), scale=2.0, norm=norm,
                            epsilon=epsilon),
           jl.instance_loss(*map(jnp.asarray, args), scale=2.0, norm=norm,
                            epsilon=epsilon))


def test_global_align_loss(data):
    _close(tl.global_align_loss(_t(data["v"]), _t(data["t"]),
                                _t(data["labels"])),
           jl.global_align_loss(jnp.asarray(data["v"]), jnp.asarray(data["t"]),
                                jnp.asarray(data["labels"])))


def test_global_align_loss_from_sim(data):
    sim = np.tanh(data["logits"][:, :N])
    _close(tl.global_align_loss_from_sim(_t(sim), _t(data["labels"]),
                                         0.5, 0.3, 5.0, 30.0),
           jl.global_align_loss_from_sim(jnp.asarray(sim),
                                         jnp.asarray(data["labels"]),
                                         0.5, 0.3, 5.0, 30.0))


def test_infonce_with_masked_negatives(data):
    rng = np.random.RandomState(1)
    pos = rng.randn(N, 1).astype(np.float32)
    neg = rng.randn(N, K).astype(np.float32)
    neg[:, [2, 5, 11]] = -np.inf  # same-identity slots
    pos2, neg2 = pos[::-1].copy(), neg[:, ::-1].copy()
    got = tl.infonce_loss(_t(pos), _t(neg), _t(pos2), _t(neg2), 0.07)
    want = jl.infonce_loss(*map(jnp.asarray, (pos, neg, pos2, neg2)), 0.07)
    assert np.isfinite(float(got))
    _close(got, want)


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_moco_loss_tail_masks_same_ids(data, epsilon):
    """The whole MoCo loss dict, the -inf same-id queue mask included (the
    fixture's id_queue shares ids with the batch)."""
    assert np.isin(data["id_queue"], data["labels"]).any()
    rng = np.random.RandomState(2)

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    v_q, t_q, v_k, t_k = (unit(rng.randn(N, D).astype(np.float32))
                          for _ in range(4))
    args = (data["proj"], data["v"], data["t"], v_q, t_q, v_k, t_k,
            data["labels"], data["id_queue"], unit(data["queue_v"]),
            unit(data["queue_t"]))
    got = moco_loss_tail(*map(_t, args[:7]), _t(args[7]).long(),
                         _t(args[8]).long(), _t(args[9]), _t(args[10]),
                         epsilon, 0.07)
    want = jax_moco_loss_tail(*map(jnp.asarray, args), epsilon, 0.07)
    assert list(got) == list(want)
    for name in want:
        _close(got[name], want[name])
