"""The flagship's MoCo train step (CLIP ModifiedResNet with BatchNorm in
training + bi-GRU) against the JAX package's, on the CPU in f32.

The flagship configuration (``moco_gru_cliprn50_ls_bs128_2048.yaml``) at a
narrow width: the ModifiedResNet built directly on both sides with one
bottleneck a stage, width 8, 4 heads, input 64x32, res5 stride 1; bi-GRU
H=16; batch 8, K=16 (the queue wraps).  Both start from one JAX init
carried across with ``train_state_from_jax``, with every BatchNorm's scale,
bias, running mean and variance moved off their initial values, and the
key encoders' running statistics apart from the query's.  Two MoCo steps
on the same two batches; compared: the loss dicts (rtol 1e-5 at step 1,
5e-5 at step 2, see LOSS_RTOL), step 1's
gradients (rtol 1e-4 and 5e-5 of each tensor's largest entry, see
GRAD_RTOL_OF_MAX), after step 2 the trunk's updates (TRUNK_UPDATE_RTOL),
the other parameters and the key parameters (atol 1e-6, as
``test_torch_train_step.py``, whose noise-floor rule this shares), both
models' BatchNorm running means and variances (STATS_RTOL), the queues
(atol 1e-5), the ids and the pointer.

Also here: the running-variance convention alone (flax moves it towards the
biased batch variance, ``torch.nn.BatchNorm2d`` towards the unbiased one),
the key encoders' BatchNorm in batch-statistics mode under ``no_grad``, and
``build_model`` on the flagship's full configuration in train mode.
"""

import copy
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from textreid_tpu.engine import create_train_state as jax_create_train_state
from textreid_tpu.engine.steps import moco_train_step as jax_moco_train_step
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.solver import make_optimizer as jax_make_optimizer
from textreid_tpu.solver.build import set_learning_rate as jax_set_lr
from textreid_torch.config import get_default_cfg
from textreid_torch.config.flagship import flagship_cfg
from textreid_torch.engine import create_train_state, make_train_step
from textreid_torch.models import build_model
from textreid_torch.models import model as model_module
from textreid_torch.models.common import batch_norm
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.solver import make_optimizer, set_learning_rate
from textreid_torch.utils.weight_convert import (
    state_dict_from_jax,
    train_state_from_jax,
)

from test_torch_train_step import (
    BATCH,
    CLASSES,
    K,
    LR,
    NOISE_FLOOR,
    TOKENS,
    VOCAB,
    _assert_state_dicts,
    _torch_batch,
    frozen_table,
    jax_grads,
    perturb_biases,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = "configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml"
HEIGHT, WIDTH = 64, 32
RN_SPEC = dict(layers=(1, 1, 1, 1), output_dim=32, heads=4, last_stride=1,
               input_resolution=(HEIGHT, WIDTH), width=8)
STAT_KEYS = ("running_mean", "running_var")
# step-1 gradients, |torch - jax| <= 1e-4 |jax| + max(GRAD_ATOL,
# GRAD_RTOL_OF_MAX * the tensor's largest |jax| entry): the batch
# statistics' backward carries f32 rounding (~1e-7 of an activation)
# through every BatchNorm of the trunk, and it lands at up to 2.6e-5 of a
# tensor's largest gradient
GRAD_RTOL_OF_MAX = 5e-5
GRAD_ATOL = 1e-6
# loss dicts at step 1 and step 2: step 2 starts from parameters whose
# step-1 update followed rounding noise where the gradient was within it
# (Adam moves such an entry by up to lr either way; see NOISE_FLOOR)
LOSS_RTOL = (1e-5, 5e-5)
# After two steps the trunk's parameters are held by their updates:
# ||update_torch - update_jax|| <= TRUNK_UPDATE_RTOL ||update_jax|| per
# tensor, every entry within two Adam steps.  Adam's first step is
# lr * sign(g), so an entry whose step-1 gradient lies within the two
# packages' agreement (GRAD_RTOL_OF_MAX) may step 2 lr the other way, and
# the second step's ratio m / sqrt(v) is as sensitive where g1 and g2 near
# cancel: measured up to 0.067 of a tensor's update.  The other parameters
# keep the 1e-6 rule of test_torch_train_step.py.
TRUNK = "visual_model."
TRUNK_UPDATE_RTOL = 0.1
# running statistics after two steps, within this share of each entry and
# of the tensor's largest: the key encoders' come from key parameters that
# agree to 1e-6 (measured 1.2e-6 of the largest); the query model's second
# batch statistics come from trunk parameters held only as above (measured
# 2.8e-5 of the largest)
STATS_RTOL = {"model": 1e-4, "key_model": 1e-5}
# BatchNorms of the narrow trunk: 3 in the stem, 3 a bottleneck and one in
# each stage's projection shortcut
N_BN = 3 + 4 * (3 + 1)


def tiny_cfg(root):
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, FLAGSHIP_YAML))
    cfg.ROOT = str(root)
    cfg.MODEL.GRU.VOCABULARY_SIZE = VOCAB
    cfg.MODEL.GRU.EMBEDDING_SIZE = cfg.MODEL.GRU.NUM_UNITS = 16
    cfg.MODEL.NUM_CLASSES = CLASSES
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.MOCO.K = K
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = HEIGHT, WIDTH
    # every parameter a gradient well above f32 noise (the attention
    # pool's key bias has an exactly zero loss gradient; see
    # test_torch_train_step.tiny_cfg)
    cfg.SOLVER.WEIGHT_DECAY_BIAS = 1e-2
    return cfg


def make_batch(seed):
    rng = np.random.RandomState(seed)
    erase = np.zeros((BATCH, 5), np.int32)
    erase[::3] = [1, 8, 4, 18, 14]  # RandomErasing on every third sample
    lengths = rng.randint(2, TOKENS + 1, BATCH).astype(np.int32)
    lengths[0] = TOKENS
    return {
        "pixels": rng.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3)).astype(
            np.uint8),
        "erase": erase,
        "token_ids": rng.randint(1, VOCAB, (BATCH, TOKENS)).astype(np.int32),
        "lengths": lengths,
        "pids": np.array([0, 0, 1, 2, 2, 3, 5, 6], np.int32) + seed % 2,
    }


def jax_model(cfg, table):
    return JaxModel(
        visual=JaxModifiedResNet(**RN_SPEC),
        textual=JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                         use_onehot="clip_vit",
                         frozen_table_init=lambda: table),
        feature_size=32, num_classes=CLASSES, embed_head="moco",
        moco_fc=cfg.MODEL.MOCO.FC, pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD))


def perturb_bn(params, stats, seed):
    """BatchNorm scales in [0.5, 1.5) and biases of +-0.1 in ``params``;
    running means of +-0.1 and variances in [0.5, 1.5) in ``stats``."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "bn" not in name:
            return x
        if "scale" in name or "'var'" in name:
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, stats))


def _pieces(state):
    return jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "constants": state.constants, "key_params": state.key_params,
        "key_batch_stats": state.key_batch_stats, "v_queue": state.v_queue,
        "t_queue": state.t_queue, "id_queue": state.id_queue,
        "queue_ptr": state.queue_ptr})


def _split(sd):
    """(parameters and other entries, BatchNorm running statistics)."""
    stats = {k: v for k, v in sd.items() if k.endswith(STAT_KEYS)}
    return {k: v for k, v in sd.items() if k not in stats}, stats


@pytest.fixture
def tiny_resnet(monkeypatch):
    """``build_model`` builds the narrow ModifiedResNet for m_resnet50."""
    monkeypatch.setattr(model_module, "build_m_resnet",
                        lambda cfg: ModifiedResNet(**RN_SPEC))


def test_two_flagship_moco_steps_match_jax(tmp_path, tiny_resnet):
    cfg = tiny_cfg(tmp_path)
    table = frozen_table(tmp_path)
    batches = [make_batch(1), make_batch(2)]

    model = jax_model(cfg, table)
    tx = jax_make_optimizer(cfg, model.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["pixels"]),
        jnp.asarray(batches[0]["token_ids"]),
        jnp.asarray(batches[0]["lengths"]), method="init_all")["params"])
    jstate = jax_create_train_state(cfg, model, tx, jax.random.PRNGKey(0),
                                    batches[0])
    params, stats = perturb_bn(perturb_biases(jstate.params),
                               jstate.batch_stats, seed=5)
    _, key_stats = perturb_bn(params, stats, seed=6)
    jstate = jstate.replace(
        params=params, batch_stats=stats, key_batch_stats=key_stats,
        key_params=jax.tree.map(jnp.copy, params),
        opt_state=jax_set_lr(jstate.opt_state, LR))
    jstep = jax.jit(jax_moco_train_step(model, tx, cfg))

    tmodel = build_model(cfg, "cpu", torch.float32, torch.float32,
                         train=True)
    optimizer = make_optimizer(cfg, tmodel)
    set_learning_rate(optimizer, LR)
    tstate = create_train_state(cfg, tmodel, optimizer, BATCH)
    tstate.load(train_state_from_jax(_pieces(jstate)))
    assert tstate.key_model.training  # batch statistics in the key tower
    tstep = make_train_step(cfg)

    want_grads = state_dict_from_jax({
        "params": jax.tree.map(np.asarray, jax_grads(
            model, cfg, jstate, jax.tree.map(jnp.asarray, batches[0]))),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    want_grads = _split(want_grads)[0]
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
            got_grads = {n: p.grad.numpy()
                         for n, p in tmodel.named_parameters()}
            assert set(got_grads) == {
                k for k in want_grads if not k.endswith("num_batches_tracked")}
            for name, g in got_grads.items():
                top = np.abs(want_grads[name]).max()
                np.testing.assert_allclose(
                    g, want_grads[name], rtol=1e-4,
                    atol=max(GRAD_ATOL, GRAD_RTOL_OF_MAX * top),
                    err_msg=f"step-1 gradients: {name}")
            noisy = {n: (p.grad + decay[id(p)] * before[n]).abs().numpy()
                     < NOISE_FLOOR for n, p in tmodel.named_parameters()}

    want = train_state_from_jax(_pieces(jstate))
    got = tstate.state_dict()
    got_model = {k: v.numpy() for k, v in got["model"].items()}
    head = {n: m for n, m in noisy.items() if not n.startswith(TRUNK)}
    n_noisy = sum(int(m.sum()) for m in head.values())
    assert n_noisy < 1e-3 * sum(m.size for m in head.values())
    for name, mask in noisy.items():
        a, b = got_model[name], want["model"][name]
        # two Adam steps at the largest group lr bound every entry
        if name.startswith(TRUNK):
            start = before[name].numpy()
            err = np.linalg.norm((a - start) - (b - start))
            assert err <= TRUNK_UPDATE_RTOL * np.linalg.norm(b - start), name
            mask = np.ones_like(mask)
        np.testing.assert_allclose(a[~mask], b[~mask], atol=1e-6, rtol=0,
                                   err_msg=f"model after 2 steps: {name}")
        assert np.abs(a[mask] - b[mask]).max(initial=0) <= 4 * 2 * LR, name
    for which in ("model", "key_model"):
        rest, got_stats = _split({k: v.numpy()
                                  for k, v in got[which].items()})
        want_rest, want_stats = _split(want[which])
        assert len(got_stats) == 2 * N_BN  # every BatchNorm of the trunk
        assert set(got_stats) == set(want_stats)
        for name, v in want_stats.items():
            tol = STATS_RTOL[which]
            np.testing.assert_allclose(
                got_stats[name], v, rtol=tol, atol=tol * np.abs(v).max(),
                err_msg=f"{which} BatchNorm running statistics: {name}")
        if which == "key_model":
            _assert_state_dicts(rest, want_rest, 1e-6, 0,
                                "key model after 2 steps")
        else:  # buffers: the frozen table, num_batches_tracked
            _assert_state_dicts(
                {k: v for k, v in rest.items() if k not in noisy},
                {k: v for k, v in want_rest.items() if k not in noisy}, 0, 0,
                "model buffers")
    # the statistics moved, and the two models' apart
    start = train_state_from_jax(_pieces(jstate.replace(
        batch_stats=stats, key_batch_stats=key_stats)))
    name = "visual_model.layer2.0.bn2.running_var"
    assert not np.allclose(got["model"][name].numpy(), start["model"][name])
    assert not np.allclose(got["key_model"][name].numpy(),
                           got["model"][name].numpy())
    for name in ("v_queue", "t_queue"):
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-5)
    np.testing.assert_array_equal(got["id_queue"].numpy(), want["id_queue"])
    assert got["queue_ptr"] == want["queue_ptr"] == 0  # 2 x 8 wraps K=16
    assert tstate.step == 2


def test_running_variance_moves_towards_the_biased_batch_variance():
    """flax's ``BatchNorm(momentum=0.9)`` and the port's ``batch_norm`` in
    train mode: the same output and running statistics from the same
    start; ``torch.nn.BatchNorm2d``'s own update (unbiased variance, here
    8 / 7 of the biased one) does not match."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 2, 2).astype(np.float32) * 2 + 0.5  # n = 8
    scale, bias = rng.rand(3).astype(np.float32) + 0.5, rng.randn(3) * 0.1
    mean0, var0 = rng.randn(3) * 0.1, rng.rand(3) + 0.5

    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias.astype(np.float32)},
                 "batch_stats": {"mean": mean0.astype(np.float32),
                                 "var": var0.astype(np.float32)}}
    want, updates = flax_bn.apply(variables, jnp.asarray(
        x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])

    def torch_bn():
        bn = torch.nn.BatchNorm2d(3).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        return bn

    bn = torch_bn()
    got = batch_norm(torch.from_numpy(x), bn)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-6)
    flax_mean = np.asarray(updates["batch_stats"]["mean"])
    flax_var = np.asarray(updates["batch_stats"]["var"])
    # f32 sums in another order: within a few ulp
    np.testing.assert_allclose(bn.running_mean.numpy(), flax_mean,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), flax_var, rtol=1e-5)
    biased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1)
    np.testing.assert_allclose(flax_var, 0.9 * var0 + 0.1 * biased,
                               rtol=1e-6)

    module = torch_bn()
    module(torch.from_numpy(x))  # torch's own update
    assert not np.allclose(module.running_var.numpy(), flax_var, rtol=1e-4)
    np.testing.assert_allclose(module.running_mean.numpy(), flax_mean,
                               rtol=1e-5, atol=1e-7)


def test_key_tower_batch_norm_runs_on_batch_statistics(tmp_path,
                                                       tiny_resnet):
    """The key encoders (a deep copy of the query model in train mode)
    normalise with the batch's statistics under ``no_grad`` and move their
    running statistics; the query model's stay where they were."""
    cfg = tiny_cfg(tmp_path)
    frozen_table(tmp_path)
    model = build_model(cfg, "cpu", train=True)
    state = create_train_state(cfg, model, make_optimizer(cfg, model),
                               BATCH)
    key = state.key_model
    assert key.training and key is not model
    pixels = torch.from_numpy(make_batch(3)["pixels"])
    before = copy.deepcopy(key.state_dict())
    with torch.no_grad():
        feat = key.encode_image(pixels)
        key.eval()
        from_running = key.encode_image(pixels)
        key.train()
    assert not torch.allclose(feat, from_running)
    moved = [k for k, v in key.state_dict().items()
             if k.endswith(STAT_KEYS) and not torch.equal(v, before[k])]
    assert len(moved) == 2 * N_BN
    for k, v in model.state_dict().items():
        if k.endswith(STAT_KEYS):
            assert torch.equal(v, before[k]), k


def test_flagship_builds_in_train_mode():
    """``build_model(flagship_cfg(""), train=True)``: the full-width CLIP
    RN50 + bi-GRU, in train mode, f32 masters running a bf16 tower."""
    cfg = flagship_cfg("")
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    model = build_model(cfg, "cpu", torch.float32, torch.bfloat16,
                        train=True)
    assert model.training and model.visual_model.layer4[0].bn3.training
    assert model.visual_model.conv1.weight.dtype == torch.float32
    assert model.dtype == torch.bfloat16
