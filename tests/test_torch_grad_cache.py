"""The gradient-cache step (``engine/grad_cache.py``, ``SOLVER.
GRAD_ACCUM_STEPS > 1``) and the AdamW and SGD optimizers, against the JAX
package on the CPU in f32 (the BatchNorm tower and ``TPU.REMAT``:
``tests/test_torch_grad_cache_bn.py``).

Models are those of the JAX package's own ``tests/test_grad_cache.py``:
the LayerNorm-only ViT + CLIP text transformer (``tiny_fullclip_model``)
and the BatchNorm ModifiedResNet + bi-GRU (``tiny_bn_model``), batch 8,
SGD (linear in the gradient, so reduction-order noise stays noise) at lr
1 (so that an update dwarfs the f32 rounding of the parameter it is added
to), carried into the port with ``train_state_from_jax``.  Updates are
held relative to their size: ``||u_port - u_jax|| <= UPDATE_RTOL
||u_jax||`` per parameter, where ``u`` is the change a step made.

* ``make_grad_cache_step`` against the port's, one step, on
  ``test_grad_cache.py``'s cases (MoCo accum 2 and 4, simple accum 2, MoCo
  accum 2 with ``MOCO.FC``): loss dicts (rtol 1e-5), updates, key
  parameters (atol 1e-6), queues (atol 1e-5), ids and pointer.
* The port's accum M against its own single pass on the same cases:
  loss dicts rtol 1e-5, updates UPDATE_RTOL (the LayerNorm towers compute
  the same objective; only summation orders differ).
* AdamW, SGD (momentum and none) and Adam against the optax chains of
  JAX's ``make_optimizer`` over three steps on the same gradients.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from textreid_tpu.engine import make_train_step as jax_make_train_step
from textreid_tpu.solver import make_optimizer as jax_make_optimizer
from textreid_tpu.solver.build import set_learning_rate as jax_set_lr
from textreid_torch.config import get_default_cfg
from textreid_torch.engine import create_train_state, make_train_step
from textreid_torch.engine.grad_cache import split_micro
from textreid_torch.models import build_model
from textreid_torch.solver import make_optimizer, set_learning_rate
from textreid_torch.utils.weight_convert import train_state_from_jax

from test_grad_cache import build as jax_build
from test_grad_cache import make_batch, tiny_bn_model, tiny_fullclip_model
from test_grad_cache import tiny_cfg as jax_tiny_cfg
from test_torch_train_step_bn import _pieces, _split

torch.set_num_threads(2)

LR = 1.0
UPDATE_RTOL = 1e-5
CASES = [("moco", 2, False), ("moco", 4, False), ("simple", 2, False),
         ("moco", 2, True)]


def port_cfg(head="moco", accum=1, fc=False, bn=False):
    """``test_grad_cache.tiny_cfg`` in the port's config, with the towers
    of ``tiny_fullclip_model`` (or, ``bn``, ``tiny_bn_model``)."""
    cfg = get_default_cfg()
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 32, 16
    cfg.MODEL.NUM_CLASSES = 8
    cfg.MODEL.EMBEDDING.EMBED_HEAD = head
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.EMBEDDING.EPSILON = 0.1
    cfg.MODEL.MOCO.K = 16
    cfg.MODEL.MOCO.FC = fc
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    cfg.SOLVER.OPTIMIZER = "SGD"
    if bn:
        # built narrow (tests/test_torch_grad_cache_bn.py:bn_tower)
        cfg.MODEL.VISUAL_MODEL = "m_resnet50"
        cfg.MODEL.TEXTUAL_MODEL = "bigru"
        cfg.MODEL.GRU.ONEHOT = "yes"
        cfg.MODEL.GRU.VOCABULARY_SIZE = 50
        cfg.MODEL.GRU.EMBEDDING_SIZE = cfg.MODEL.GRU.NUM_UNITS = 16
    else:
        cfg.MODEL.VISUAL_MODEL = "vit"
        cfg.MODEL.VIT.PATCH_SIZE, cfg.MODEL.VIT.WIDTH = 8, 32
        cfg.MODEL.VIT.LAYERS, cfg.MODEL.VIT.HEADS = 2, 4
        cfg.MODEL.VIT.OUTPUT_DIM = 32
        cfg.MODEL.TEXTUAL_MODEL = "transformer"
        t = cfg.MODEL.TRANSFORMER
        t.ARCH, t.WIDTH, t.LAYERS, t.HEADS, t.OUTPUT_DIM = "", 32, 2, 4, 32
        t.VOCAB_SIZE, t.CONTEXT_LENGTH = 50, 10
    return cfg


def jax_case(head, accum, fc, bn=False):
    """JAX (cfg, state, jitted step) of ``test_grad_cache.py``."""
    batch = make_batch(8)
    cfg = jax_tiny_cfg(head=head, accum=accum)
    cfg.MODEL.MOCO.FC = fc
    model, tx, state = jax_build(cfg, tiny_bn_model if bn
                                 else tiny_fullclip_model, batch)
    state = state.replace(opt_state=jax_set_lr(state.opt_state, LR))
    return state, jax.jit(jax_make_train_step(model, tx, cfg)), batch


def port_state(cfg, jstate):
    model = build_model(cfg, "cpu", train=True)
    optimizer = make_optimizer(cfg, model)
    set_learning_rate(optimizer, LR)
    state = create_train_state(cfg, model, optimizer, 8)
    state.load(train_state_from_jax(_pieces(jstate)))
    return state


def torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["pids"] = out["pids"].long()
    return out


def assert_updates(got, want, start, what, trunk_rtol=UPDATE_RTOL):
    """Per parameter, ``||u_got - u_want|| <= UPDATE_RTOL ||u_want||``
    (``trunk_rtol`` for the visual tower's).  A parameter whose update is
    under 1e-6 of the largest update norm has an exactly zero gradient (the
    attention pool's key bias: softmax ignores a constant added to a row)
    plus rounding noise: both packages' updates stay under that floor."""
    assert set(got) == set(want), what
    updates = {k: np.asarray(w) - np.asarray(start[k])
               for k, w in want.items()}
    floor = 1e-6 * max(np.linalg.norm(u) for u in updates.values())
    for name, u_want in updates.items():
        u_got = np.asarray(got[name]) - np.asarray(start[name])
        if np.linalg.norm(u_want) < floor:
            assert np.linalg.norm(u_got) < floor, (what, name)
            continue
        err = np.linalg.norm(u_got - u_want)
        rtol = (trunk_rtol if name.startswith("visual_model.")
                else UPDATE_RTOL)
        assert err <= rtol * np.linalg.norm(u_want), (
            what, name, err / np.linalg.norm(u_want))


def _params(sd):
    """The trainable entries of a state dict (no buffers, statistics)."""
    params, _ = _split(sd)
    return {k: v for k, v in params.items()
            if not k.endswith(("num_batches_tracked", "frozen_token_table"))}


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_moco_state(got, want, what):
    rest, _ = _split(_numpy(got["key_model"]))
    want_rest, _ = _split(want["key_model"])
    for name, v in want_rest.items():
        np.testing.assert_allclose(rest[name], v, atol=1e-6, rtol=0,
                                   err_msg=f"{what}: key {name}")
    for name in ("v_queue", "t_queue"):
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-5,
                                   err_msg=what)
    np.testing.assert_array_equal(got["id_queue"].numpy(), want["id_queue"])
    assert got["queue_ptr"] == want["queue_ptr"] == 8


@pytest.mark.parametrize("head,accum,fc", CASES)
def test_grad_cache_step_matches_jax_and_the_single_pass(head, accum, fc):
    jstate, jstep, batch = jax_case(head, accum, fc)
    start = _params(train_state_from_jax(_pieces(jstate))["model"])
    tstate = port_state(port_cfg(head, accum, fc), jstate)
    single = port_state(port_cfg(head, 1, fc), jstate)
    jstate, jmetrics = jstep(jstate, batch)
    tmetrics = make_train_step(port_cfg(head, accum, fc))(
        tstate, torch_batch(batch))
    smetrics = make_train_step(port_cfg(head, 1, fc))(single,
                                                      torch_batch(batch))
    assert set(tmetrics) == set(jmetrics) == set(smetrics)
    for name, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[name]), float(v),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(tmetrics[name]),
                                   float(smetrics[name]), rtol=1e-5,
                                   err_msg=f"single pass {name}")
    want = train_state_from_jax(_pieces(jstate))
    got = tstate.state_dict()
    assert_updates(_params(_numpy(got["model"])), _params(want["model"]),
                   start, "against JAX")
    assert_updates(_params(_numpy(got["model"])),
                   _params(_numpy(single.state_dict()["model"])), start,
                   "against the single pass")
    if head == "moco":
        _assert_moco_state(got, want, "against JAX")
        _assert_moco_state(got, _pieces_of(single), "single pass")
    else:
        assert tstate.key_model is None


def _pieces_of(state):
    """A port state's own pieces in ``train_state_from_jax``'s output
    layout (numpy), for :func:`_assert_moco_state`."""
    sd = state.state_dict()
    return {"model": _numpy(sd["model"]), "key_model": _numpy(
        sd["key_model"]), **{k: sd[k].numpy() for k in (
            "v_queue", "t_queue", "id_queue")}, "queue_ptr": sd["queue_ptr"]}


def test_a_batch_the_microbatches_do_not_divide_raises():
    batch = torch_batch(make_batch(8))
    assert [m["pids"].shape[0] for m in split_micro(batch, 4)] == [2] * 4
    with pytest.raises(ValueError, match="GRAD_ACCUM_STEPS"):
        split_micro(batch, 3)


class _Towers(nn.Module):
    """Parameters named as the model's: a visual and a textual tower, each
    a weight and a bias."""

    def __init__(self):
        super().__init__()
        self.visual_model = nn.Linear(3, 4)
        self.textual_model = nn.Linear(4, 2)


@pytest.mark.parametrize("name,momentum", [("AdamW", 0.0), ("SGD", 0.9),
                                           ("SGD", 0.0), ("Adam", 0.0)])
def test_optimizers_match_optax(name, momentum):
    """Three steps on the same gradients from the same start: the
    optimizer's parameters against the optax chain of JAX's
    ``make_optimizer`` (weight decay, bias decay, bias and visual lr
    factors all on), within 1e-5 of the tensor's largest change (torch
    and optax normalise Adam's moments in another order: a few ulp of a
    step)."""
    cfg = get_default_cfg()
    cfg.SOLVER.OPTIMIZER = name
    cfg.SOLVER.SGD_MOMENTUM = momentum
    cfg.SOLVER.WEIGHT_DECAY, cfg.SOLVER.WEIGHT_DECAY_BIAS = 1e-2, 1e-3
    cfg.SOLVER.BIAS_LR_FACTOR, cfg.SOLVER.VISUAL_LR_FACTOR = 2.0, 0.5
    torch.manual_seed(0)
    towers = _Towers()
    names = {"visual_model": "visual", "textual_model": "textual",
             "weight": "kernel", "bias": "bias"}

    def to_jax(named):
        tree = {}
        for key, value in named.items():
            top, leaf = key.split(".")
            tree.setdefault(names[top], {})[names[leaf]] = jnp.asarray(
                value.detach().numpy())
        return tree

    params = to_jax(dict(towers.named_parameters()))
    tx = jax_make_optimizer(cfg, params)
    opt_state = jax_set_lr(tx.init(params), 0.01)
    optimizer = make_optimizer(cfg, towers)
    set_learning_rate(optimizer, 0.01)
    start = {k: p.detach().clone().numpy()
             for k, p in towers.named_parameters()}
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for k, p in towers.named_parameters()}
        updates, opt_state = tx.update(to_jax(grads), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for k, p in towers.named_parameters():
            p.grad = grads[k]
        optimizer.step()
    for key, p in towers.named_parameters():
        top, leaf = key.split(".")
        want = np.asarray(params[names[top]][names[leaf]])
        change = np.abs(want - start[key]).max()
        assert change > 0, key
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * change, err_msg=key)
