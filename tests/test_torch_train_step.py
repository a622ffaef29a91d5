"""The port's MoCo train step against the JAX package's, on the CPU in f32.

A tiny ViT + bi-GRU model (the flagship ViT configuration's structure at
narrow widths) starts from one JAX init carried across with
``train_state_from_jax``; both packages take two MoCo steps on the same
two batches (batch 8, K=16, so the queue wraps), with the MoCo projectors
off and on.  The JAX side runs its fused-attention Pallas kernels in
interpret mode.  Tolerances: loss dicts rtol 1e-5; step-1 gradients
rtol 1e-4, atol 1e-6; after step 2, params and key params atol 1e-6 (1%
of one Adam step at lr 1e-4), queues 1e-5; queue pointer and ids equal.
The parameter check leaves out the few entries (under 0.1%) whose step-1
gradient, weight decay included, is below 1e-6: Adam divides it by its
own size, so there the step follows rounding noise; those entries are held
to the bound of two Adam steps instead.

Also here: the learning-rate schedule against JAX's, and the fault that
K1's CUDA wrapper had no gradient, shown and fixed on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.engine import create_train_state as jax_create_train_state
from textreid_tpu.engine.steps import _apply, moco_key_forward, moco_loss_tail
from textreid_tpu.engine.steps import moco_train_step as jax_moco_train_step
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models import losses as jax_losses
from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_tpu.solver import make_lr_schedule as jax_make_lr_schedule
from textreid_tpu.solver import make_optimizer as jax_make_optimizer
from textreid_tpu.solver.build import set_learning_rate as jax_set_lr
from textreid_torch.config import get_default_cfg
from textreid_torch.engine import create_train_state, make_train_step
from textreid_torch.models import build_model
from textreid_torch.ops import gru
from textreid_torch.solver import (
    make_lr_schedule,
    make_optimizer,
    set_learning_rate,
)
from textreid_torch.utils.weight_convert import (
    state_dict_from_jax,
    train_state_from_jax,
)

torch.set_num_threads(2)

BATCH, K, VOCAB, TABLE_W, TOKENS, CLASSES = 8, 16, 50, 24, 10, 8
LR = 1e-4
# |loss gradient + weight decay| below this at step 1: Adam's normalised
# step there follows rounding noise, not the gradient
NOISE_FLOOR = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(root, fc):
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(
        REPO, "configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_2048.yaml"))
    cfg.ROOT = str(root)
    cfg.MODEL.VISUAL_MODEL = "vit"
    cfg.MODEL.VIT.PATCH_SIZE, cfg.MODEL.VIT.WIDTH = 8, 64
    cfg.MODEL.VIT.LAYERS, cfg.MODEL.VIT.HEADS = 2, 2
    cfg.MODEL.VIT.OUTPUT_DIM = 32
    cfg.MODEL.GRU.VOCABULARY_SIZE = VOCAB
    cfg.MODEL.GRU.EMBEDDING_SIZE = cfg.MODEL.GRU.NUM_UNITS = 16
    cfg.MODEL.NUM_CLASSES = CLASSES
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.MOCO.K = K
    cfg.MODEL.MOCO.FC = fc
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 32, 16
    # The attention's key bias has an exactly zero loss gradient (softmax
    # is invariant to a constant added to a row), so under Adam the two
    # packages' f32 rounding noise alone would set its step.  A bias
    # weight decay (with nonzero biases, see ``perturb_biases``) gives every
    # parameter a gradient well above that noise.
    cfg.SOLVER.WEIGHT_DECAY_BIAS = 1e-2
    return cfg


def perturb_biases(params, seed=3):
    """Nonzero biases (flax initialises them to zero)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + (rng.randn(*x.shape) * 0.05).astype(x.dtype)
        if "bias" in jax.tree_util.keystr(path) else x, params)


def frozen_table(root):
    """The frozen token table on disk, wider than the embedding, so the
    embed adapter is in the path."""
    table = np.random.RandomState(7).randn(VOCAB, TABLE_W).astype(np.float32)
    path = os.path.join(root, "datasets", "cuhkpedes")
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "clip_vocab_vit.npy"), table)
    return table


def jax_model(cfg, table):
    return JaxModel(
        visual=JaxViT(input_resolution=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH),
                      patch_size=8, width=64, layers=2, heads=2,
                      output_dim=32, fused_attention=True,
                      attn_interpret=True),
        textual=JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                         use_onehot="clip_vit",
                         frozen_table_init=lambda: table),
        feature_size=32, num_classes=CLASSES, embed_head="moco",
        moco_fc=cfg.MODEL.MOCO.FC, pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD))


def make_batch(seed):
    rng = np.random.RandomState(seed)
    erase = np.zeros((BATCH, 5), np.int32)
    erase[::3] = [1, 4, 2, 9, 7]  # RandomErasing on every third sample
    lengths = rng.randint(2, TOKENS + 1, BATCH).astype(np.int32)
    lengths[0] = TOKENS
    return {
        "pixels": rng.randint(0, 256, (BATCH, 32, 16, 3)).astype(np.uint8),
        "erase": erase,
        "token_ids": rng.randint(1, VOCAB, (BATCH, TOKENS)).astype(np.int32),
        "lengths": lengths,
        "pids": np.array([0, 0, 1, 2, 2, 3, 5, 6], np.int32) + seed % 2,
    }


def jax_grads(model, cfg, state, batch):
    """Step 1's gradient, assembled from the JAX step's own pieces in its
    order: EMA, key forward, gradient of the loss."""
    m = cfg.MODEL.MOCO.M
    key_params = jax.tree.map(lambda k, q: k * m + q * (1.0 - m),
                              state.key_params, state.params)
    v_k, t_k, _ = moco_key_forward(model, cfg.MODEL.MOCO.FC, key_params,
                                   state.key_batch_stats, state.params,
                                   state.constants, batch)

    def loss(params):
        v_feat, _ = _apply(model, params, state.batch_stats, state.constants,
                           "encode_image", batch["pixels"], train=True,
                           erase=batch["erase"])
        t_feat = model.apply({"params": params, "constants": state.constants},
                             batch["token_ids"], batch["lengths"],
                             method="encode_text")
        v_e = model.apply({"params": params}, v_feat, method="embed_image")
        t_e = model.apply({"params": params}, t_feat, method="embed_text")
        if cfg.MODEL.MOCO.FC:
            v_q = model.apply({"params": params}, v_feat,
                              method="project_image")
            t_q = model.apply({"params": params}, t_feat,
                              method="project_text")
        else:
            v_q, t_q = v_e, t_e
        d = moco_loss_tail(params["projection"], v_e, t_e,
                           jax_losses.l2_normalize(v_q, axis=1),
                           jax_losses.l2_normalize(t_q, axis=1), v_k, t_k,
                           batch["pids"], state.id_queue, state.v_queue,
                           state.t_queue, cfg.MODEL.EMBEDDING.EPSILON, 0.07)
        return sum(d.values())

    return jax.grad(loss)(state.params)


def _pieces(state):
    return jax.tree.map(np.asarray, {
        "params": state.params, "constants": state.constants,
        "key_params": state.key_params, "v_queue": state.v_queue,
        "t_queue": state.t_queue, "id_queue": state.id_queue,
        "queue_ptr": state.queue_ptr})


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["pids"] = out["pids"].long()
    return out


def _assert_state_dicts(got, want, atol, rtol, what):
    assert set(got) == set(want), what
    for name in sorted(want):
        np.testing.assert_allclose(
            np.asarray(got[name]), np.asarray(want[name]), atol=atol,
            rtol=rtol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("fc", [False, True])
def test_two_moco_steps_match_jax(tmp_path, fc):
    cfg = tiny_cfg(tmp_path, fc)
    table = frozen_table(tmp_path)
    batches = [make_batch(1), make_batch(2)]

    model = jax_model(cfg, table)
    tx = jax_make_optimizer(cfg, model.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["pixels"]),
        jnp.asarray(batches[0]["token_ids"]),
        jnp.asarray(batches[0]["lengths"]), method="init_all")["params"])
    jstate = jax_create_train_state(cfg, model, tx, jax.random.PRNGKey(0),
                                    batches[0])
    params = perturb_biases(jstate.params)
    jstate = jstate.replace(
        params=params, key_params=jax.tree.map(jnp.copy, params),
        opt_state=jax_set_lr(jstate.opt_state, LR))
    jstep = jax.jit(jax_moco_train_step(model, tx, cfg))

    tmodel = build_model(cfg, "cpu", torch.float32, torch.float32,
                         train=True)
    optimizer = make_optimizer(cfg, tmodel)
    set_learning_rate(optimizer, LR)
    tstate = create_train_state(cfg, tmodel, optimizer, BATCH)
    tstate.load(train_state_from_jax(_pieces(jstate)))
    tstep = make_train_step(cfg)

    want_grads = state_dict_from_jax({"params": jax.tree.map(
        np.asarray, jax_grads(model, cfg, jstate,
                              jax.tree.map(jnp.asarray, batches[0])))})
    decay = {id(p): g["weight_decay"] for g in optimizer.param_groups
             for p in g["params"]}
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, batch)
        tmetrics = tstep(tstate, _torch_batch(batch))
        assert set(tmetrics) == set(jmetrics)
        for name in jmetrics:
            np.testing.assert_allclose(float(tmetrics[name]),
                                       float(jmetrics[name]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {name}")
        if i == 0:
            got_grads = {n: p.grad.numpy()
                         for n, p in tmodel.named_parameters()}
            _assert_state_dicts(got_grads, want_grads, 1e-6, 1e-4,
                                "step-1 gradients")
            # Adam's first step is g / (|g| + 1e-8): where the loss gradient
            # and the weight decay all but cancel, f32 rounding noise
            # (~1e-9) moves it by a visible fraction of a step
            noisy = {n: (p.grad + decay[id(p)] * before[n]).abs().numpy()
                     < NOISE_FLOOR for n, p in tmodel.named_parameters()}

    want = train_state_from_jax(_pieces(jstate))
    got = tstate.state_dict()
    n_noisy = sum(int(m.sum()) for m in noisy.values())
    assert n_noisy < 1e-3 * sum(m.size for m in noisy.values())
    got_model = {k: v.numpy() for k, v in got["model"].items()}
    for name, mask in noisy.items():
        a, b = got_model[name], want["model"][name]
        np.testing.assert_allclose(a[~mask], b[~mask], atol=1e-6, rtol=0,
                                   err_msg=f"model after 2 steps: {name}")
        # two Adam steps at the largest group lr bound the rest
        assert np.abs(a[mask] - b[mask]).max(initial=0) <= 4 * 2 * LR, name
    _assert_state_dicts(
        {k: v.numpy() for k, v in got["model"].items() if k not in noisy},
        {k: v for k, v in want["model"].items() if k not in noisy}, 0, 0,
        "model buffers")
    _assert_state_dicts(
        {k: v.numpy() for k, v in got["key_model"].items()},
        want["key_model"], 1e-6, 0, "key model after 2 steps")
    for name in ("v_queue", "t_queue"):
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-5)
    np.testing.assert_array_equal(got["id_queue"].numpy(), want["id_queue"])
    assert got["queue_ptr"] == want["queue_ptr"] == 0  # 2 x 8 wraps K=16
    assert tstate.step == 2


def test_lr_schedule_matches_jax_at_every_epoch(tmp_path):
    cfg = tiny_cfg(tmp_path, False)
    ours, theirs = make_lr_schedule(cfg), jax_make_lr_schedule(cfg)
    lrs = [ours(e) for e in range(cfg.SOLVER.NUM_EPOCHS)]
    assert lrs == [theirs(e) for e in range(cfg.SOLVER.NUM_EPOCHS)]
    # warmup from 0.1x over 5 epochs, then x0.1 at epochs 40 and 70
    assert lrs[0] == pytest.approx(1e-5) and lrs[5] == pytest.approx(1e-4)
    assert lrs[40] == pytest.approx(1e-5) and lrs[79] == pytest.approx(1e-6)


def test_queue_size_must_divide_by_the_batch(tmp_path):
    cfg = tiny_cfg(tmp_path, False)
    frozen_table(tmp_path)
    model = build_model(cfg, "cpu", train=True)
    with pytest.raises(ValueError, match="divisible"):
        create_train_state(cfg, model, make_optimizer(cfg, model), 6)


def _k1_inputs(seed=0, batch=3, seq=6, hidden=8, embed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, seq, embed).astype(np.float32)
    w_ih = (rng.randn(3 * hidden, embed) * 0.4).astype(np.float32)
    w_ih_r = (rng.randn(3 * hidden, embed) * 0.4).astype(np.float32)
    w_f = (rng.randn(hidden, 3 * hidden) * 0.4).astype(np.float32)
    w_b = (rng.randn(hidden, 3 * hidden) * 0.4).astype(np.float32)
    g = rng.randn(batch, 2 * hidden).astype(np.float32)
    lengths = np.array([seq, 2, 4][:batch], np.int32)
    return x, w_ih, w_ih_r, w_f, w_b, g, lengths


def _counting_launchers(monkeypatch):
    """Stand-ins for the CUDA launchers of K1's training forward and its
    backward: each counts as the real one does and returns the plain
    version's result (which carries no graph, like a ctypes-filled
    tensor).  The wrappers' counters stay where they were."""
    launched = []
    real_bwd = gru.bigru_pooled_bwd

    def fwd_train(*args):
        gru.bigru_pooled_scan.launches += 1
        out = gru.bigru_pooled_fwd_train_plain(*args)
        launched.append(("fwd", out[0].grad_fn))
        return out

    def bwd(*args):
        real_bwd.launches += 1
        launched.append(("bwd", None))
        return gru.bigru_pooled_bwd_plain(*args)

    monkeypatch.setattr(gru, "bigru_pooled_fwd_train", fwd_train)
    monkeypatch.setattr(gru, "bigru_pooled_bwd", bwd)
    return launched, real_bwd


def test_k1_function_has_the_plain_gradient(monkeypatch):
    """The fault: K1's CUDA wrapper filled a ``torch.empty`` output through
    ctypes, which carries no ``grad_fn``, so nothing upstream of the text
    tower's scan got a gradient.  The fix, an autograd Function whose
    forward and backward are launchers, runs here on the CPU with both
    launchers swapped for their plain versions: every GRU weight, the input
    gates and the projection that makes them get the gradients of autograd
    through the plain scan."""
    launched, _ = _counting_launchers(monkeypatch)
    x, w_ih, w_ih_r, w_f, w_b, g, lengths = _k1_inputs()
    lens = torch.from_numpy(lengths)

    def run(scan):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (x, w_ih, w_ih_r, w_f, w_b)]
        xt, wi, wir, wf, wb = leaves
        xf = xt @ wi.T
        xb = torch.flip(xt, dims=[1]) @ wir.T
        out = scan(xf, xb, wf, wb, lens)
        grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                    leaves)
        return out, grads

    out, got = run(lambda *a: gru._BigruPooled.apply(*a, True))
    # what the launchers hand back has no graph; the Function's output has
    assert launched == [("fwd", None), ("bwd", None)]
    assert out.grad_fn is not None
    ref_out, want = run(gru.bigru_pooled_scan_plain)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for name, a, b in zip(("x", "w_ih", "w_ih_reverse", "w_hh", "w_hh_reverse"),
                          got, want):
        assert a.abs().sum() > 0, name
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)


def test_k1_function_counts_forward_launches_only(monkeypatch):
    """``bigru_pooled_scan.launches`` counts the forward's launches only:
    one training forward under autograd; the backward's launch is counted
    apart, in ``bigru_pooled_bwd.launches``.  Under ``no_grad`` the
    training forward is not called and nothing is kept for a backward."""
    launched, bwd = _counting_launchers(monkeypatch)
    x, w_ih, _, w_f, w_b, _, lengths = _k1_inputs(seed=1)
    xf = torch.from_numpy(x @ w_ih.T).requires_grad_(True)
    args = (xf, xf.detach(), torch.from_numpy(w_f), torch.from_numpy(w_b),
            torch.from_numpy(lengths))
    before = (gru.bigru_pooled_scan.launches, bwd.launches)
    out = gru.bigru_pooled_scan(*args)
    assert (gru.bigru_pooled_scan.launches, bwd.launches) == (
        before[0] + 1, before[1])
    out.sum().backward()
    assert (gru.bigru_pooled_scan.launches, bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert xf.grad is not None and xf.grad.abs().sum() > 0
    with torch.no_grad():
        keyed = gru.bigru_pooled_scan(*args)
    assert keyed.grad_fn is None
    assert launched == [("fwd", None), ("bwd", None)]
