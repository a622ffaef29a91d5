"""The 2-layer frozen model's MoCo train step against the JAX package's, on
the CPU in f32.

``moco_gru2l_freeze_cliprn50_ls_bs128_2048.yaml`` at a narrow width: the
narrow ModifiedResNet of ``tests/test_torch_train_step_bn.py`` (one
bottleneck a stage, width 8, 64x32, res5 stride 1) and a 2-layer bi-GRU
(H=16) over the frozen table, ``DROPOUT_KEEP_PROB: 0.7``, ``MODEL.FREEZE``:
the whole text tower and the trunk's stem and layers 1-3 frozen (JAX:
``freeze_mask``; the port: ``requires_grad`` off).  Both start from one JAX
init carried across with ``train_state_from_jax``, BatchNorm parameters
and statistics moved off their initial values; two MoCo steps on the same
two batches.  JAX's step never applies the inter-layer dropout (its
``encode_text`` leaves ``deterministic`` True), nor does the port's.

Held, with the rules of ``test_torch_train_step_bn.py``
(:func:`assert_two_steps`): the loss dicts (LOSS_RTOL), after step 2 the
trunk's trainable parameters by their update (TRUNK_UPDATE_RTOL), the
others at atol 1e-6 (entries under the gradient floor: within two Adam
steps), both models' BatchNorm statistics (STATS_RTOL), the key model,
queues (1e-5), ids and pointer.  Every frozen parameter is bit-identical
to its start, in both packages, and gets no gradient in the port.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.engine import create_train_state as jax_create_train_state
from textreid_tpu.engine import make_train_step as jax_make_train_step
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.solver import make_optimizer as jax_make_optimizer
from textreid_tpu.solver.build import freeze_mask
from textreid_tpu.solver.build import set_learning_rate as jax_set_lr
from textreid_torch.engine import create_train_state, make_train_step
from textreid_torch.models import build_model
from textreid_torch.solver import make_optimizer, set_learning_rate
from textreid_torch.solver.build import apply_freeze
from textreid_torch.utils.weight_convert import train_state_from_jax

from test_torch_train_step import (
    BATCH,
    CLASSES,
    LR,
    NOISE_FLOOR,
    VOCAB,
    _assert_state_dicts,
    _torch_batch,
    frozen_table,
    perturb_biases,
)
from test_torch_train_step_bn import (
    LOSS_RTOL,
    RN_SPEC,
    STATS_RTOL,
    TRUNK_UPDATE_RTOL,
    _pieces,
    _split,
    make_batch,
    perturb_bn,
    tiny_cfg,
    tiny_resnet,  # noqa: F401
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU2L_YAML = os.path.join(
    REPO, "configs/cuhkpedes/moco_gru2l_freeze_cliprn50_ls_bs128_2048.yaml")
FROZEN_TRUNK = tuple(f"visual_model.{p}" for p in (
    "conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "layer1", "layer2",
    "layer3"))


def jax_start(cfg, jax_model, batches, trainable_mask_fn=None, seed=5):
    """The JAX state both packages start from, its optimizer and its
    jitted step: biases and BatchNorm off their initial values, the key
    encoders' statistics apart from the query's, lr ``LR``."""
    params0 = jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["pixels"]),
        jnp.asarray(batches[0]["token_ids"]),
        jnp.asarray(batches[0]["lengths"]), method="init_all")["params"]
    mask = trainable_mask_fn(params0) if trainable_mask_fn else None
    tx = jax_make_optimizer(cfg, params0, mask)
    jstate = jax_create_train_state(cfg, jax_model, tx,
                                    jax.random.PRNGKey(0), batches[0])
    params, stats = perturb_bn(perturb_biases(jstate.params),
                               jstate.batch_stats, seed=seed)
    jstate = jstate.replace(params=params, batch_stats=stats,
                            opt_state=jax_set_lr(jstate.opt_state, LR))
    if jstate.key_params is not None:
        _, key_stats = perturb_bn(params, stats, seed=seed + 1)
        jstate = jstate.replace(key_params=jax.tree.map(jnp.copy, params),
                                key_batch_stats=key_stats)
    return jstate, jax.jit(jax_make_train_step(jax_model, tx, cfg))


def port_start(cfg, jstate):
    """The port's state from ``jstate`` and its step."""
    model = build_model(cfg, "cpu", torch.float32, torch.float32, train=True)
    if cfg.MODEL.FREEZE:
        apply_freeze(model)
    optimizer = make_optimizer(cfg, model)
    set_learning_rate(optimizer, LR)
    state = create_train_state(cfg, model, optimizer, BATCH)
    state.load(train_state_from_jax(_pieces(jstate)))
    return state, make_train_step(cfg)


# A parameter fed by the trunk's features (``downstream``), held by its
# update after two steps: its step-2 gradient follows the trunk's step-1
# update, which the two packages' f32 agree on only to TRUNK_UPDATE_RTOL
# (a full-width torchvision trunk's visual embed layer: measured 3.5e-4)
DOWNSTREAM_UPDATE_RTOL = 1e-3


def assert_two_steps(jstate, jstep, tstate, tstep, batches,
                     trunk="visual_model.", downstream=()):
    """Two steps of each package on ``batches``, held as the module's
    docstring says (parameters named by a ``downstream`` prefix by their
    update, at DOWNSTREAM_UPDATE_RTOL); returns ``(jstate, the port's
    state dict after)``."""
    optimizer, tmodel = tstate.optimizer, tstate.model
    decay = {id(p): g["weight_decay"] for g in optimizer.param_groups
             for p in g["params"]}
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, batch)
        tmetrics = tstep(tstate, _torch_batch(batch))
        assert set(tmetrics) == set(jmetrics)
        for name in jmetrics:
            np.testing.assert_allclose(float(tmetrics[name]),
                                       float(jmetrics[name]),
                                       rtol=LOSS_RTOL[i],
                                       err_msg=f"step {i + 1} {name}")
        if i == 0:
            # |g + wd p| < NOISE_FLOOR where the loss gradient g is not
            # exactly 0: a token or position no caption of the batch
            # reaches, or a padding row, gets none, and its step (from wd p
            # alone) is the same arithmetic on both sides
            noisy = {}
            for n, p in tmodel.named_parameters():
                if p.requires_grad:
                    g = (p.grad + decay[id(p)] * before[n]).abs()
                    noisy[n] = ((p.grad != 0) & (g < NOISE_FLOOR)).numpy()

    want = train_state_from_jax(_pieces(jstate))
    got = tstate.state_dict()
    got_model = {k: v.numpy() for k, v in got["model"].items()}
    head = {n: m for n, m in noisy.items() if not n.startswith(trunk)}
    assert sum(int(m.sum()) for m in head.values()) < 1e-3 * sum(
        m.size for m in head.values())
    for name, mask in noisy.items():
        a, b = got_model[name], want["model"][name]
        rtol = (TRUNK_UPDATE_RTOL if name.startswith(trunk) else
                DOWNSTREAM_UPDATE_RTOL if name.startswith(downstream) else 0)
        if rtol:
            start_v = before[name].numpy()
            err = np.linalg.norm((a - start_v) - (b - start_v))
            assert err <= rtol * np.linalg.norm(b - start_v), name
            mask = np.ones_like(mask)
        np.testing.assert_allclose(a[~mask], b[~mask], atol=1e-6, rtol=0,
                                   err_msg=f"model after 2 steps: {name}")
        # two Adam steps at the largest group lr bound the rest
        assert np.abs(a[mask] - b[mask]).max(initial=0) <= 4 * 2 * LR, name
    whichs = ("model", "key_model") if "key_model" in want else ("model",)
    for which in whichs:
        rest, got_stats = _split({k: v.numpy()
                                  for k, v in got[which].items()})
        want_rest, want_stats = _split(want[which])
        assert set(got_stats) == set(want_stats)
        for name, v in want_stats.items():
            tol = STATS_RTOL[which]
            np.testing.assert_allclose(
                got_stats[name], v, rtol=tol, atol=tol * np.abs(v).max(),
                err_msg=f"{which} BatchNorm running statistics: {name}")
        if which == "key_model":
            _assert_state_dicts(rest, want_rest, 1e-6, 0,
                                "key model after 2 steps")
        else:  # frozen parameters and buffers: exact
            _assert_state_dicts(
                {k: v for k, v in rest.items() if k not in noisy},
                {k: v for k, v in want_rest.items() if k not in noisy}, 0,
                0, "model: frozen parameters and buffers")
    if "key_model" in want:
        for name in ("v_queue", "t_queue"):
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       atol=1e-5)
        np.testing.assert_array_equal(got["id_queue"].numpy(),
                                      want["id_queue"])
        assert got["queue_ptr"] == want["queue_ptr"] == 0  # K=16 wraps
    assert tstate.step == 2
    return jstate, got


def test_two_moco_steps_of_the_2_layer_frozen_model_match_jax(
        tmp_path, tiny_resnet):  # noqa: F811
    cfg = tiny_cfg(tmp_path)
    cfg.merge_from_file(GRU2L_YAML)
    cfg.MODEL.GRU.VOCABULARY_SIZE = VOCAB
    cfg.MODEL.GRU.EMBEDDING_SIZE = cfg.MODEL.GRU.NUM_UNITS = 16
    cfg.MODEL.NUM_CLASSES = CLASSES
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.MOCO.K = 16
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = RN_SPEC["input_resolution"]
    assert cfg.MODEL.FREEZE and cfg.MODEL.GRU.NUM_LAYER == 2
    assert cfg.MODEL.GRU.DROPOUT_KEEP_PROB == 0.7
    table = frozen_table(tmp_path)
    batches = [make_batch(1), make_batch(2)]

    jax_model = JaxModel(
        visual=JaxModifiedResNet(**RN_SPEC),
        textual=JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                         num_layers=2, dropout_rate=0.3,
                         use_onehot="clip_vit",
                         frozen_table_init=lambda: table),
        feature_size=32, num_classes=CLASSES, embed_head="moco",
        moco_fc=False, pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD))
    jstate, jstep = jax_start(cfg, jax_model, batches, freeze_mask)
    jstart = train_state_from_jax(_pieces(jstate))
    tstate, tstep = port_start(cfg, jstate)
    frozen = {n for n, p in tstate.model.named_parameters()
              if not p.requires_grad}
    assert frozen == {n for n in jstart["model"] if (
        n.startswith("textual_model.") or n.startswith(FROZEN_TRUNK))
        and not n.endswith(("running_mean", "running_var",
                            "num_batches_tracked", "frozen_token_table"))}
    assert "textual_model.gru.weight_hh_l1_reverse" in frozen

    jstate, got = assert_two_steps(jstate, jstep, tstate, tstep, batches)
    jend = train_state_from_jax(_pieces(jstate))
    for name in frozen:
        start = jstart["model"][name]
        np.testing.assert_array_equal(got["model"][name].numpy(), start,
                                      err_msg=name)
        np.testing.assert_array_equal(jend["model"][name], start,
                                      err_msg=name)
    assert not any(p.grad is not None for n, p in
                   tstate.model.named_parameters() if n in frozen)
