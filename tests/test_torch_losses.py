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


# identities repeated once, twice and three times, so that the label mask's
# row norms differ between rows (1, sqrt 2, sqrt 3)
CMP_LABELS = {"1-2-3": np.array([0, 1, 1, 2, 2, 2, 5, 7], np.int32),
              "3-3-2": np.array([4, 4, 4, 1, 1, 1, 6, 6], np.int32)}


def _cmp_inputs(data, labels, scale):
    return {"proj": data["proj"], "v": data["v"] * scale,
            "t": data["t"] * scale, "labels": CMP_LABELS[labels]}


def _cmp_pair(name):
    """(port function, JAX function, float argument names) of a CMP loss."""
    if name == "cmpc":
        return ((lambda a: tl.cmpc_loss(a["proj"], a["v"], a["t"],
                                        a["labels"].long())),
                (lambda a: jl.cmpc_loss(a["proj"], a["v"], a["t"],
                                        a["labels"])),
                ("proj", "v", "t"))
    return ((lambda a: tl.cmpm_loss(a["v"], a["t"], a["labels"])),
            (lambda a: jl.cmpm_loss(a["v"], a["t"], a["labels"])),
            ("v", "t"))


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("labels", sorted(CMP_LABELS))
@pytest.mark.parametrize("name", ["cmpc", "cmpm"])
def test_cross_modal_projection_loss(data, name, labels, scale):
    port, ref, _ = _cmp_pair(name)
    args = _cmp_inputs(data, labels, scale)
    got = port({k: _t(v) for k, v in args.items()})
    want = ref({k: jnp.asarray(v) for k, v in args.items()})
    assert np.isfinite(float(got))
    _close(got, want)


@pytest.mark.parametrize("labels", sorted(CMP_LABELS))
@pytest.mark.parametrize("name", ["cmpc", "cmpm"])
def test_cross_modal_projection_loss_gradient(data, name, labels):
    """Every float input's gradient against ``jax.grad`` (rtol 1e-5; atol
    1e-6 of the largest entry, for entries that cancel to near zero)."""
    import jax

    port, ref, wrt = _cmp_pair(name)
    args = _cmp_inputs(data, labels, 1.0)
    tensors = {k: _t(v).clone().requires_grad_(k in wrt)
               for k, v in args.items()}
    port(tensors).backward()
    grads = jax.grad(lambda fl: ref({**args, **fl}))(
        {k: jnp.asarray(args[k]) for k in wrt})
    for k in wrt:
        want = np.asarray(grads[k])
        np.testing.assert_allclose(tensors[k].grad.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_cmpm_mask_divide_is_the_row_wise_one():
    """The broadcast divide by row norms equals a row-wise divide when
    each identity's rows share their norm, as they always do."""
    labels = torch.from_numpy(CMP_LABELS["1-2-3"])
    mask = (labels[:, None] == labels[None, :]).float()
    norms = torch.linalg.vector_norm(mask, dim=1)
    torch.testing.assert_close(mask / norms, mask / norms[:, None],
                               rtol=0, atol=0)
    assert len(set(norms.tolist())) == 3
