"""The port's FFN tensor parallelism (``textreid_torch/parallel/mesh.py``:
``tp_spec``, ``zero1_spec``, ``shard_state``; ``models/vit.py``'s split
block) against the JAX package on the CPU.

Placements, in one process: the owner of every element of every
parameter under the port's ``tp_spec`` and ``zero1_spec`` (a data axis of
2, leaves from 64 elements so that small ones split too) equals JAX's
under its own on a ``data 2 x model 2`` mesh, carried across leaf by leaf
with ``state_dict_from_jax``'s layout (flax's ``[in, out]`` kernels are
the transpose of ``nn.Linear``'s), for JAX's tiny full-CLIP of
``tests/test_tensor_parallel.py`` (32x16 input, patch 8, width 32, 2
layers, 4 heads, both towers) and for the ViT + bi-GRU model.

Steps, on 4 gloo ranks as ``data 2 x model 2`` (``tests/torch_dp_worker.py``,
one launch): two MoCo steps of the tiny full-CLIP from one JAX start on
the 8-row batches, with SGD and then Adam, against JAX's single-device
``make_train_step``: metrics, the gathered parameters and the queues
within rtol 2e-4 / atol 2e-5 (``tests/test_tensor_parallel.py``'s own
tolerance; Adam's first step follows rounding noise where ``|g + wd p|``
is under the noise floor, so those entries are held within two steps of
the learning rate), step 1's gathered gradients against JAX's by the
gates of ``test_torch_dp_step.py``; each rank's split leaves at the
shapes ``tp_spec`` gives; the eval-mode encode under the split against
the one-process ``encode_image``.  The same Adam run with ZeRO-1 on top
equals it bit for bit, and its checkpoint (written after step 1 in the
single-process layout) loads into one process, whose step 2 matches the
ranks', and back into the ranks, bit for bit.  A model axis over the
flagship (no transformer FFN) raises JAX's ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models.text_transformer import (
    TextTransformer as JaxTextTransformer,
)
from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_tpu.parallel import make_mesh as jax_make_mesh
from textreid_tpu.parallel.mesh import DATA_AXIS as JAX_DATA
from textreid_tpu.parallel.mesh import MODEL_AXIS as JAX_MODEL
from textreid_tpu.parallel.mesh import shard_state as jax_shard_state
from textreid_tpu.parallel.mesh import zero1_spec as jax_zero1_spec
from textreid_torch.config import get_default_cfg
from textreid_torch.engine.steps import encode_step
from textreid_torch.models import build_model
from textreid_torch.parallel import make_mesh, shard_state
from textreid_torch.parallel.mesh import jax_dim_order, tp_spec, zero1_spec
from textreid_torch.utils.weight_convert import (
    state_dict_from_jax,
    train_state_from_jax,
)

from textreid_tpu.engine import create_train_state as jax_create_train_state
from textreid_tpu.engine import make_train_step as jax_make_train_step
from textreid_tpu.solver import make_optimizer as jax_make_optimizer
from textreid_tpu.solver.build import set_learning_rate as jax_set_lr

from test_torch_train_gru2l import port_start
from test_torch_train_step import (
    CLASSES,
    K,
    LR,
    NOISE_FLOOR,
    TOKENS,
    VOCAB,
    _pieces,
    _torch_batch,
    frozen_table,
    perturb_biases,
    jax_grads,
    make_batch,
)
from test_torch_train_step import jax_model as jax_vit_gru
from test_torch_train_step import tiny_cfg as vit_gru_cfg
from test_torch_train_step_bn import GRAD_ATOL, GRAD_RTOL_OF_MAX, perturb_bn
from torch_dp_worker import launch

torch.set_num_threads(2)

WIDTH, LAYERS, HEADS, PATCH = 32, 2, 4, 8
TINY = f"""
MODEL:
  VISUAL_MODEL: "vit"
  TEXTUAL_MODEL: "transformer"
  NUM_CLASSES: {CLASSES}
  VIT: {{PATCH_SIZE: {PATCH}, WIDTH: {WIDTH}, LAYERS: {LAYERS},
         HEADS: {HEADS}, OUTPUT_DIM: 32}}
  TRANSFORMER: {{ARCH: "", WIDTH: {WIDTH}, LAYERS: {LAYERS}, HEADS: {HEADS},
                OUTPUT_DIM: 32, VOCAB_SIZE: {VOCAB}, CONTEXT_LENGTH: 12}}
  EMBEDDING: {{EMBED_HEAD: "moco", FEATURE_SIZE: 32, EPSILON: 0.1}}
  MOCO: {{FC: False, K: {K}}}
INPUT: {{HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: {TOKENS}}}
SOLVER: {{IMS_PER_BATCH: 8, WEIGHT_DECAY_BIAS: 0.01}}
"""
MESH = (2, 2, 1)  # data x model, one slice
RTOL, ATOL = 2e-4, 2e-5  # tests/test_tensor_parallel.py's
MIN_ZERO1 = 64  # so that the tiny models' leaves split too


def fullclip_cfg(tmp_path, optimizer="Adam"):
    path = tmp_path / "tp.yaml"
    path.write_text(TINY)
    cfg = get_default_cfg()
    cfg.merge_from_file(str(path))
    cfg.SOLVER.OPTIMIZER = optimizer
    return cfg


def jax_fullclip(cfg):
    return JaxModel(
        visual=JaxViT(input_resolution=(32, 16), patch_size=PATCH,
                      width=WIDTH, layers=LAYERS, heads=HEADS, output_dim=32),
        textual=JaxTextTransformer(vocab_size=VOCAB, context_length=12,
                                   width=WIDTH, layers=LAYERS, heads=HEADS,
                                   output_dim=32),
        feature_size=32, num_classes=CLASSES, embed_head="moco",
        moco_fc=False, pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD))


# -- placements ---------------------------------------------------------------

def _owners(shape, spec, mesh_shape):
    """``1 + 10 * model owner + data owner`` of every element of a leaf of
    ``shape`` under ``spec`` (one axis name or None a dimension)."""
    out = np.ones(shape, np.float32)
    grid = np.indices(shape) if shape else []
    for d, name in enumerate(spec):
        if name is None:
            continue
        owner = grid[d] // (shape[d] // mesh_shape[name])
        out += owner * (10 if name == "model" else 1)
    return out


def jax_owner_maps(params):
    mesh = jax_make_mesh(2, 2)
    shape = {"model": mesh.shape[JAX_MODEL], "data": mesh.shape[JAX_DATA]}

    def owners(path, leaf):
        spec = tuple(jax_zero1_spec(path, leaf, mesh, MIN_ZERO1))
        spec = spec + (None,) * (leaf.ndim - len(spec))
        return _owners(leaf.shape, spec, shape)

    return state_dict_from_jax({"params": jax.tree_util.tree_map_with_path(
        owners, jax.tree.map(np.asarray, params))})


def port_owner_maps(model):
    out = {}
    for name, p in model.named_parameters():
        spec = [None] * p.dim()
        tp = tp_spec(name, p.shape)
        if tp is not None:
            spec[tp] = "model"
        z = zero1_spec(name, p.shape, 2, jax_dim_order(model, name),
                       MIN_ZERO1)
        if z is not None:
            spec[z] = "data"
        out[name] = _owners(tuple(p.shape), spec, {"model": 2, "data": 2})
    return out


def jax_param_shapes(jax_model, batch):
    """Zeros in the shapes of ``jax_model``'s parameters (traced, not
    computed)."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["pixels"]),
        jnp.asarray(batch["token_ids"]), jnp.asarray(batch["lengths"]),
        method="init_all"))["params"]
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)


def _assert_same_owners(jax_model, cfg, batch):
    params = jax_param_shapes(jax_model, batch)
    want = jax_owner_maps(params)
    model = build_model(cfg, "cpu", torch.float32, torch.float32, train=True)
    got = port_owner_maps(model)
    assert set(got) <= set(want)
    split = {"model": 0, "data": 0}
    for name, owners in got.items():
        np.testing.assert_array_equal(owners, want[name], err_msg=name)
        split["model"] += int((owners >= 11).any())
        split["data"] += int((owners % 10 == 2).any())
    return split


def test_placements_match_jax_on_the_tiny_full_clip(tmp_path):
    cfg = fullclip_cfg(tmp_path)
    split = _assert_same_owners(jax_fullclip(cfg), cfg, make_batch(1))
    # c_fc weight + bias and c_proj weight of 2 blocks in 2 towers
    assert split["model"] == 12
    assert split["data"] > 12


def test_placements_match_jax_on_the_vit_gru_model(tmp_path):
    cfg = vit_gru_cfg(tmp_path, fc=True)
    table = frozen_table(tmp_path)
    split = _assert_same_owners(jax_vit_gru(cfg, table), cfg, make_batch(1))
    assert split["model"] == 6  # the ViT's 2 blocks; the GRU has none
    assert split["data"] > 6


def test_a_model_axis_over_the_flagship_raises_as_in_jax(tmp_path):
    """The RN50 + bi-GRU flagship has no transformer FFN: a model axis
    would replicate everything, and both packages refuse it."""
    from test_torch_train_step_bn import RN_SPEC, jax_model, tiny_cfg
    from test_torch_train_step_bn import make_batch as flagship_batch

    from textreid_torch.engine import create_train_state
    from textreid_torch.models import model as model_module
    from textreid_torch.models.m_resnet import ModifiedResNet
    from textreid_torch.solver import make_optimizer

    cfg = tiny_cfg(tmp_path)
    table = frozen_table(tmp_path)
    batch = flagship_batch(1)
    params = jax_param_shapes(jax_model(cfg, table), batch)
    with pytest.raises(ValueError) as want:
        jax_shard_state({"params": params}, jax_make_mesh(4, 2))
    build = model_module.build_m_resnet
    model_module.build_m_resnet = lambda cfg: ModifiedResNet(**RN_SPEC)
    try:
        model = build_model(cfg, "cpu", torch.float32, torch.float32,
                            train=True)
    finally:
        model_module.build_m_resnet = build
    state = create_train_state(cfg, model, make_optimizer(cfg, model), 8)
    mesh = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError) as got:
        shard_state(state, mesh)
    assert str(got.value) == str(want.value)


# -- the steps on 4 ranks -------------------------------------------------------

def quick_jax_start(cfg, jax_model, batches, seed=5):
    """``test_torch_train_gru2l.py:jax_start``'s state and jitted step,
    the optimizer built on the parameters' shapes (traced, not computed:
    it reads their tree alone) and the parameters initialised once, under
    ``jit``."""
    tx = jax_make_optimizer(cfg, jax_param_shapes(jax_model, batches[0]))
    jstate = jax_create_train_state(cfg, jax_model, tx, jax.random.PRNGKey(0),
                                    batches[0])
    params, stats = perturb_bn(perturb_biases(jstate.params),
                               jstate.batch_stats, seed=seed)
    jstate = jstate.replace(params=params, batch_stats=stats,
                            opt_state=jax_set_lr(tx.init(params), LR))
    _, key_stats = perturb_bn(params, stats, seed=seed + 1)
    jstate = jstate.replace(key_params=jax.tree.map(jnp.copy, params),
                            key_batch_stats=key_stats)
    return jstate, jax.jit(jax_make_train_step(jax_model, tx, cfg))


def jax_starts(root, batches):
    """``{name: (cfg, (JAX state, jitted step))}`` for SGD and Adam from one
    start's weights."""
    sgd = fullclip_cfg(root, "SGD")
    out = {"sgd": (sgd, quick_jax_start(sgd, jax_fullclip(sgd), batches))}
    adam = fullclip_cfg(root, "Adam")
    model = jax_fullclip(adam)
    tx = jax_make_optimizer(adam, jax_param_shapes(model, batches[0]))
    first = out["sgd"][1][0]
    out["adam"] = (adam, (first.replace(opt_state=jax_set_lr(
        tx.init(first.params), LR)), jax.jit(jax_make_train_step(
            model, tx, adam))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's starts and one launch of the 4 ranks: SGD, Adam, Adam with
    ZeRO-1 (its checkpoint after step 1), each two steps."""
    root = tmp_path_factory.mktemp("tp")
    batches = [make_batch(1), make_batch(2)]
    starts, runs = jax_starts(root, batches), {}
    for name, (cfg, (jstate, _)) in starts.items():
        runs[name] = {"cfg": cfg.to_dict(), "mesh": MESH,
                      "pieces": train_state_from_jax(_pieces(jstate)),
                      "batches": batches}
    runs["sgd"]["encode"] = make_batch(3)
    runs["zero"] = {**runs["adam"], "zero": True, "min_zero1": MIN_ZERO1,
                    "checkpoint": str(root / "ckpt" / "step1.pth")}
    out = launch("mesh_runs", {"lr": LR, "runs": runs}, root / "ranks",
                 world=4)
    return starts, batches, out, runs["zero"]["checkpoint"]


def _close(got, want, what, noisy=None):
    got, want = np.asarray(got), np.asarray(want)
    if noisy is not None:
        assert np.abs(got - want).max(initial=0) <= 2 * LR + 1e-6, what
        got, want = got[~noisy], want[~noisy]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _assert_matches_jax(starts, batches, out, _, name):
    cfg, (jstate, jstep) = starts[name]
    records = [rank[name] for rank in out]
    # the ranks agree, bit for bit, on everything they gathered
    for rec in records[1:]:
        for a, b in zip(rec["steps"], records[0]["steps"]):
            assert a["metrics"] == b["metrics"]
            for which in ("model", "key_model"):
                for k, v in a["state"][which].items():
                    assert torch.equal(v, b["state"][which][k]), k
    jmodel = jax_fullclip(cfg)
    want_grads = state_dict_from_jax({"params": jax.tree.map(
        np.asarray, jax.jit(lambda s, b: jax_grads(jmodel, cfg, s, b))(
            jstate, jax.tree.map(jnp.asarray, batches[0])))})
    got_grads = records[0]["steps"][0]["grads"]
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        top = np.abs(want_grads[k]).max()
        np.testing.assert_allclose(
            g.numpy(), want_grads[k], rtol=1e-4,
            atol=max(GRAD_ATOL, GRAD_RTOL_OF_MAX * top),
            err_msg=f"step-1 gradients: {k}")
    start = train_state_from_jax(_pieces(jstate))["model"]
    decay = {}
    for group in port_start(cfg, jstate)[0].optimizer.param_groups:
        decay.update({id(p): group["weight_decay"] for p in group["params"]})
    tstate, _ = port_start(cfg, jstate)
    wd = {n: decay.get(id(p), 0.0) for n, p in
          tstate.model.named_parameters()}
    noisy = None
    if cfg.SOLVER.OPTIMIZER == "Adam":
        noisy = {k: np.abs(want_grads[k] + wd[k] * start[k]) < NOISE_FLOOR
                 for k in want_grads}
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, batch)
        got = records[0]["steps"][i]
        assert set(got["metrics"]) == set(jmetrics)
        for k, v in jmetrics.items():
            _close(got["metrics"][k], float(v), f"step {i + 1} {k}")
        want = train_state_from_jax(_pieces(jstate))
        for which in ("model", "key_model"):
            for k, v in want[which].items():
                _close(got["state"][which][k].numpy(), v,
                       f"step {i + 1} {which} {k}",
                       None if noisy is None or which == "key_model"
                       else noisy.get(k))
        for k in ("v_queue", "t_queue"):
            _close(got["state"][k].numpy(), want[k], f"step {i + 1} {k}")
        np.testing.assert_array_equal(got["state"]["id_queue"].numpy(),
                                      want["id_queue"])
        assert got["state"]["queue_ptr"] == want["queue_ptr"]


def test_tensor_parallel_sgd_steps_match_jax(runs):
    _assert_matches_jax(*runs, "sgd")


def test_tensor_parallel_adam_steps_match_jax(runs):
    _assert_matches_jax(*runs, "adam")


def test_each_rank_holds_the_parts_tp_spec_gives(runs):
    starts, _, out, _ = runs
    cfg = starts["sgd"][0]
    full = dict(build_model(cfg, "cpu", torch.float32,
                            torch.float32).named_parameters())
    for r, rank in enumerate(out):
        rec = rank["sgd"]
        assert rec["axes"]["data"] == (r % 2, r % 2 + 2)  # same model index
        assert rec["axes"]["model"] == (r - r % 2, r - r % 2 + 1)
        assert rec["shard"] == (r // 2, 2)
        assert len(rec["tp"]) == 12
        for name, shape in rec["shapes"].items():
            want = list(full[name].shape)
            dim = tp_spec(name, want)
            if dim is not None:
                want[dim] //= 2
            assert shape == tuple(want), name
            assert (dim is not None) == (name in rec["tp"]), name


def test_the_encode_under_the_split_matches_one_process(runs):
    starts, _, out, _ = runs
    cfg, (jstate, _) = starts["sgd"]
    tstate, _ = port_start(cfg, jstate)
    tstate.model.eval()
    batch = {k: torch.from_numpy(v) for k, v in make_batch(3).items()}
    # the ranks encode with the state after their two steps
    tstate.model.load_state_dict(out[0]["sgd"]["steps"][-1]["state"][
        "model"])
    want = encode_step(tstate.model, batch)
    for rank in out:
        for got, w in zip(rank["sgd"]["encode"], want):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


def test_zero1_under_the_split_is_bit_equal(runs):
    _, _, out, _ = runs
    for rank in out:
        rec, plain = rank["zero"], rank["adam"]
        assert rec["zero"] and set(rec["zero"]) - set(rec["tp"])
        assert rec["opt_bytes"] < plain["opt_bytes"]
        for a, b in zip(rec["steps"], plain["steps"]):
            assert a["metrics"] == b["metrics"]
            for which in ("model", "key_model"):
                for k, v in a["state"][which].items():
                    assert torch.equal(v, b["state"][which][k]), k
            for i, slot in b["state"]["optimizer"]["state"].items():
                for k, v in slot.items():
                    assert torch.equal(a["state"]["optimizer"]["state"][i][k],
                                       v), (i, k)


def test_a_split_checkpoint_loads_into_one_process_and_back(runs):
    """Written by rank 0 after step 1 under data 2 x model 2 with ZeRO-1:
    the single-process layout (every leaf and moment whole), which one
    process restores (strict) and steps on as the ranks did."""
    from textreid_torch.engine import make_train_step

    starts, batches, out, path = runs
    cfg, (jstate, _) = starts["adam"]
    state, _ = port_start(cfg, jstate)
    payload = torch.load(path, weights_only=True)
    for which in ("model", "key_model"):
        want = getattr(state, which).state_dict()
        assert {k: v.shape for k, v in payload[which].items()} == {
            k: v.shape for k, v in want.items()}
    state.load_state_dict(payload)
    metrics = make_train_step(cfg)(state, _torch_batch(batches[1]))
    got = out[0]["zero"]["steps"][1]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5,
                                   err_msg=k)
    for k, v in state.state_dict()["model"].items():
        diff = (got["state"]["model"][k] - v).abs()
        assert diff.max() <= 2 * LR + 1e-6, k
        assert (diff > 1e-6).float().mean() < 1e-3, k
    # and back: the ranks resumed from the file take step 2 bit for bit
    for rank in out:
        assert rank["zero"]["resumed_equal"]
        again, first = rank["zero"]["resumed"], rank["zero"]["steps"][1]
        assert again["metrics"] == first["metrics"]
        for which in ("model", "key_model"):
            for k, v in again["state"][which].items():
                assert torch.equal(v, first["state"][which][k]), k
