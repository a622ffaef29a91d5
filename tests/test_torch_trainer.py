"""Training as shipped, on the CPU: evaluation every epoch with a ``best``
checkpoint, checkpoints pruned under ``CHECKPOINT_KEEP``, resume (``auto``
included), preemption saves, the ``MODEL.WEIGHT`` warm start and
background checkpoint writes, each against the JAX package where it has a
counterpart.

``train_net.main`` runs a tiny ViT + bi-GRU model (the yaml below, with no
``SOLVER.EVALUATE_PERIOD`` override: it is 1, the default) on synthetic
CUHK-PEDES train and test splits at 32x16 pixels, two steps an epoch.  The
warm start runs the flagship's configuration with a narrow ModifiedResNet
on both sides (``tests/test_torch_train_step_bn.py``'s).  Equalities are
exact (bit for bit) unless a line says otherwise.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.data import make_data_loader as jax_make_data_loader
from textreid_tpu.engine.inference import inference as jax_inference
from textreid_tpu.engine.state import TrainState as JaxTrainState
from textreid_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from textreid_torch import test_net, train_net
from textreid_torch.data import make_data_loader, make_synthetic_dataset
from textreid_torch.engine import create_train_state, make_train_step
from textreid_torch.engine import trainer
from textreid_torch.models import build_model
from textreid_torch.models import model as model_module
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.solver import make_optimizer
from textreid_torch.utils.checkpoint import (
    Checkpointer,
    auto_resume_path,
    read_meta,
)
from textreid_torch.utils.meters import MetricLogger
from textreid_torch.utils.preempt import PreemptionGuard
from textreid_torch.utils.weight_convert import train_state_from_jax

from test_torch_isolation import person_search_logger  # noqa: F401
from test_torch_train_step import frozen_table, jax_model, make_batch
from test_torch_train_step import perturb_biases, tiny_cfg
from test_torch_train_step_bn import RN_SPEC, _pieces, perturb_bn
from test_torch_train_step_bn import jax_model as jax_flagship_model
from test_torch_train_step_bn import tiny_cfg as flagship_tiny_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = os.path.join(
    REPO, "configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml")

TINY = """
MODEL:
  VISUAL_MODEL: "vit"
  TEXTUAL_MODEL: "bigru"
  NUM_CLASSES: 4
  VIT: {PATCH_SIZE: 8, WIDTH: 64, LAYERS: 2, HEADS: 2, OUTPUT_DIM: 32}
  GRU: {ONEHOT: "clip_vit", EMBEDDING_SIZE: 16, NUM_UNITS: 16,
        VOCABULARY_SIZE: 50, DROPOUT_KEEP_PROB: 1.0}
  EMBEDDING: {EMBED_HEAD: "moco", FEATURE_SIZE: 32, EPSILON: 0.1}
  MOCO: {FC: False, K: 32}
INPUT: {HEIGHT: 32, WIDTH: 16, USE_AUG: True, MAX_TEXT_LENGTH: 10}
DATASETS:
  TRAIN: ("cuhkpedes_train", )
  TEST: ("cuhkpedes_test", )
DATALOADER: {IMS_PER_ID: 4, NUM_WORKERS: 2}
SOLVER: {IMS_PER_BATCH: 8, NUM_EPOCHS: 2, BASE_LR: 0.001, LOG_PERIOD: 1,
         CHECKPOINT_PERIOD: 1, CHECKPOINT_KEEP: 1, WARMUP_EPOCHS: 0}
TEST: {IMS_PER_BATCH: 8}
TPU: {ALLOW_RANDOM_VOCAB: True, DEBUG_NANS: True}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    data = str(root / "datasets" / "cuhkpedes")
    make_synthetic_dataset(data, num_identities=4, images_per_id=4,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="train")
    make_synthetic_dataset(data, num_identities=4, images_per_id=2,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="test", seed=1)
    (root / "configs" / "tiny").mkdir(parents=True)
    for name in ("straight", "halves", "preempted", "sync"):
        (root / "configs" / "tiny" / f"{name}.yaml").write_text(TINY)
    return root


def _main(root, name, *extra):
    return train_net.main(["--root", str(root), "--config-file",
                           str(root / "configs" / "tiny" / f"{name}.yaml"),
                           "--device", "cpu", *extra])


def _out(root, name):
    return root / "output" / "tiny" / name


def _state_tensors(state):
    """Every tensor and number of a state's checkpoint, flattened."""
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = obj

    walk("", state.state_dict() if hasattr(state, "state_dict") else state)
    return flat


def _assert_same(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.fixture(scope="module")
def straight(workspace):
    """Two epochs through ``train_net.main`` as the yaml ships them
    (evaluation after each), with ``--use-tensorboard``."""
    state, meters = _main(workspace, "straight", "--use-tensorboard")
    return state, meters


def test_two_epochs_evaluate_after_each_and_keep_the_best(workspace,
                                                          straight):
    state, meters = straight
    out = _out(workspace, "straight")
    top1 = list(meters.top1.deque)
    assert len(top1) == 2 and all(math.isfinite(v) for v in top1)
    assert state.step == 4 and state.model.training
    # best.pth: the first epoch (R@1 above 0) and any strict gain after it
    best = read_meta(out / "best.pth")
    assert best["best_top1"] == max(top1) > 0
    assert best["epoch"] == 1 + top1.index(max(top1))
    # CHECKPOINT_KEEP 1: epoch_1.pth pruned, epoch_2.pth kept
    assert (out / "epoch_2.pth").is_file()
    assert not (out / "epoch_1.pth").exists()
    assert not list(out.glob("*.tmp"))
    assert read_meta(out / "epoch_2.pth")["iteration"] == 4
    # the meters also went to tensorboardX (installed here)
    assert list((out / "tensorboard").glob("events.out.tfevents.*"))


def test_test_net_on_best_gives_the_logged_top1(workspace, straight):
    """In-training evaluation and ``test_net`` both run f32 weights with
    f32 compute on the CPU: the same t2i R@1."""
    out = _out(workspace, "straight")
    best = read_meta(out / "best.pth")
    got = test_net.main(["--root", str(workspace), "--config-file",
                         str(workspace / "configs" / "tiny" /
                             "straight.yaml"),
                         "--checkpoint-file", str(out / "best.pth"),
                         "--device", "cpu"])
    assert got == {"cuhkpedes_test": pytest.approx(best["best_top1"],
                                                   abs=1e-9)}


def test_one_epoch_then_auto_resume_equals_two_straight_epochs(workspace,
                                                               straight):
    """The parameters, Adam state, queues, ids, pointer and step after 1
    epoch plus ``--resume-from auto`` for 1 equal 2 straight epochs bit for
    bit; the resumed run takes its budget from its own config and keeps
    the best R@1 it resumed with."""
    _main(workspace, "halves", "SOLVER.NUM_EPOCHS", "1")
    out = _out(workspace, "halves")
    assert read_meta(out / "epoch_1.pth")["max_epoch"] == 1
    assert auto_resume_path(str(out)) == str(out / "epoch_1.pth")
    state, meters = _main(workspace, "halves", "--resume-from", "auto")
    assert len(meters.top1.deque) == 1  # epoch 2's evaluation only
    _assert_same(_state_tensors(state), _state_tensors(straight[0]))
    assert read_meta(out / "best.pth")["best_top1"] == read_meta(
        _out(workspace, "straight") / "best.pth")["best_top1"]


def test_preemption_mid_epoch_saves_and_auto_resume_finishes(workspace,
                                                             monkeypatch):
    """``PreemptionGuard.trip()`` after the first step of epoch 2:
    ``preempt.pth`` holds that state with ``epoch`` pinned to 1; ``auto``
    takes it (newer than ``epoch_1.pth``) and the run finishes epoch 2 and
    the budget."""
    guards, calls = [], []
    moves = trainer.to_device

    def guard(enabled):
        guards.append(PreemptionGuard(enabled=False))
        return guards[-1]

    def to_device(batch, device):
        calls.append(1)
        if len(calls) == 3:  # the loader's first batch of epoch 2
            guards[-1].trip()
        return moves(batch, device)

    monkeypatch.setattr(trainer, "PreemptionGuard", guard)
    monkeypatch.setattr(trainer, "to_device", to_device)
    state, _ = _main(workspace, "preempted")
    out = _out(workspace, "preempted")
    assert state.step == 3
    meta = read_meta(out / "preempt.pth")
    assert meta["epoch"] == 1 and meta["iteration"] == 3
    assert not (out / "epoch_2.pth").exists()
    assert auto_resume_path(str(out)) == str(out / "preempt.pth")
    monkeypatch.undo()
    state, meters = _main(workspace, "preempted", "--resume-from", "auto")
    assert state.step == 5  # epoch 2 again from the preempted state
    assert read_meta(out / "epoch_2.pth")["iteration"] == 5
    assert len(meters.top1.deque) == 1


def _jax_moco_state(model, batch, k, dim=32):
    """A JAX MoCo ``TrainState`` as ``create_train_state`` lays it out
    (the key encoders a copy of the query's, empty queues), without an
    optimizer, which neither evaluation nor a warm start reads."""
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["pixels"]),
        jnp.asarray(batch["token_ids"]), jnp.asarray(batch["lengths"]),
        method="init_all"))()
    stats = variables.get("batch_stats", {})
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=stats, constants=variables["constants"], opt_state=None,
        key_params=variables["params"], key_batch_stats=stats,
        v_queue=jnp.zeros((k, dim)), t_queue=jnp.zeros((k, dim)),
        id_queue=jnp.full((k,), -1, jnp.int32),
        queue_ptr=jnp.zeros((), jnp.int32))


def test_in_training_top1_equals_jax_inference(tmp_path):
    """The trainer's evaluation after an epoch at learning rate 0 (the
    weights stay as loaded; the ViT has no BatchNorm) against JAX's
    ``inference`` on the same weights, carried over with
    ``train_state_from_jax``, on the same val split; the model is back in
    train mode after it."""
    cfg = tiny_cfg(tmp_path, fc=False)
    cfg.DATASETS.TRAIN = ("cuhkpedes_train",)
    cfg.DATASETS.TEST = ("cuhkpedes_test",)
    cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.IMS_PER_ID = 8, 4
    cfg.TEST.IMS_PER_BATCH = 8
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.INPUT.MAX_TEXT_LENGTH = 10
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    data = str(tmp_path / "datasets" / "cuhkpedes")
    make_synthetic_dataset(data, num_identities=4, images_per_id=4,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="train")
    make_synthetic_dataset(data, num_identities=4, images_per_id=2,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="test", seed=1)
    table = frozen_table(tmp_path)
    batch = make_batch(1)
    model = jax_model(cfg, table)
    jstate = _jax_moco_state(model, batch, cfg.MODEL.MOCO.K)
    jstate = jstate.replace(params=perturb_biases(jstate.params))
    want = jax_inference(model, jstate,
                         jax_make_data_loader(cfg, is_train=False)[0],
                         dataset_name="val", save_data=False, rerank=False)

    tmodel = build_model(cfg, "cpu", torch.float32, torch.float32,
                         train=True)
    tstate = create_train_state(cfg, tmodel, make_optimizer(cfg, tmodel), 8)
    tstate.load(train_state_from_jax(_pieces(jstate)))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    meters = trainer.do_train(
        cfg, tstate, make_train_step(cfg), make_data_loader(cfg),
        make_data_loader(cfg, is_train=False), Checkpointer(""),
        MetricLogger(), lambda epoch: 0.0, {"max_epoch": 1}, "cpu")
    assert tstate.step == 2 and tmodel.training
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert list(meters.top1.deque) == [pytest.approx(float(want), abs=1e-9)]


def _history(save_dir, jax_dir, epochs):
    """The same checkpoint history in both packages' layouts: ``epoch_N``,
    ``best`` and ``preempt``."""
    for n in epochs:
        (save_dir / f"epoch_{n}.pth").write_bytes(b"")
        (jax_dir / f"epoch_{n}").mkdir()
    for name in ("best", "preempt"):
        (save_dir / f"{name}.pth").write_bytes(b"")
        (jax_dir / name).mkdir()


@pytest.mark.parametrize("keep", [0, 1, 2, 4, 9])
def test_prune_keeps_the_epochs_jax_keeps(tmp_path, keep):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    _history(port, jax_dir, (1, 2, 3, 5, 10, 11))
    Checkpointer(str(port)).prune_epochs(keep)
    JaxCheckpointer(save_dir=str(jax_dir), save_to_disk=True).prune_epochs(
        keep)
    kept = sorted(p.name[:-4] for p in port.iterdir())
    assert kept == sorted(p.name for p in jax_dir.iterdir())
    assert "best" in kept and "preempt" in kept


class _Chosen(Exception):
    """Raised by the patched JAX ``train`` with the path it resumes from."""


def _jax_auto_choice(monkeypatch, out_dir):
    """What the JAX ``train_net.py`` resumes from with ``--resume-from
    auto`` in ``out_dir`` (its ``train`` runs up to the resume, with the
    model building and the training stubbed out)."""
    import textreid_tpu.engine
    import textreid_tpu.utils.checkpoint
    import train_net as jax_train_net
    from textreid_tpu.config import get_default_cfg

    def chosen(self, path, state):
        raise _Chosen(path)

    def fresh(*args, **kwargs):
        raise _Chosen(None)

    monkeypatch.setattr(jax_train_net, "setup_compilation_cache",
                        lambda cfg: None)
    monkeypatch.setattr(jax_train_net, "build_everything",
                        lambda cfg, logger: (None,) * 7)
    monkeypatch.setattr(textreid_tpu.utils.checkpoint.Checkpointer, "resume",
                        chosen)
    monkeypatch.setattr(textreid_tpu.engine, "do_train", fresh)
    cfg = get_default_cfg()
    cfg.ROOT = str(out_dir)
    with pytest.raises(_Chosen) as got:
        jax_train_net.train(cfg, str(out_dir), "auto", False)
    return got.value.args[0]


@pytest.mark.parametrize("epochs,preempt_iteration,want", [
    ((1, 2), None, "epoch_2"),      # the newest epoch
    ((1, 2), 9, "preempt"),         # a preemption after it
    ((1, 2), 4, "epoch_2"),         # a stale one (not strictly newer)
    ((), 3, "preempt"),             # only a preemption
    ((), None, None),               # nothing: a fresh start
])
def test_auto_resume_chooses_what_jax_chooses(tmp_path, monkeypatch, epochs,
                                              preempt_iteration, want):
    import json

    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    state = {"model": {"w": torch.zeros(2)}}
    for n in epochs:
        torch.save({**state, "meta": {"epoch": n, "iteration": 2 * n}},
                   port / f"epoch_{n}.pth")
        (jax_dir / f"epoch_{n}").mkdir()
        (jax_dir / f"epoch_{n}.meta.json").write_text(
            json.dumps({"epoch": n, "iteration": 2 * n}))
    if preempt_iteration is not None:
        meta = {"epoch": 1, "iteration": preempt_iteration}
        torch.save({**state, "meta": meta}, port / "preempt.pth")
        (jax_dir / "preempt").mkdir()
        (jax_dir / "preempt.meta.json").write_text(json.dumps(meta))
    got = auto_resume_path(str(port))
    jax_got = _jax_auto_choice(monkeypatch, jax_dir)
    name = None if got is None else os.path.basename(got)[:-4]
    assert name == (None if jax_got is None else os.path.basename(jax_got))
    assert name == want


def _flagship_argv(root, *extra):
    return ["--root", str(root), "--config-file", FLAGSHIP_YAML, "--device",
            "cpu", "INPUT.HEIGHT", "64", "INPUT.WIDTH", "32",
            "MODEL.GRU.VOCABULARY_SIZE", "50", "MODEL.GRU.EMBEDDING_SIZE",
            "16", "MODEL.GRU.NUM_UNITS", "16", "MODEL.NUM_CLASSES", "8",
            "MODEL.EMBEDDING.FEATURE_SIZE", "32", "SOLVER.IMS_PER_BATCH", "8",
            "DATALOADER.IMS_PER_ID", "4", "DATALOADER.NUM_WORKERS", "2",
            "SOLVER.NUM_EPOCHS", "0", "SOLVER.EVALUATE_PERIOD", "0",
            *extra]


def test_warm_start_equals_jax_install(tmp_path, monkeypatch):
    """``MODEL.WEIGHT`` = a reference ``.pth`` written by JAX's
    ``export_textreid_checkpoint``: the query model, the key encoders, the
    queues, the ids and the pointer equal what JAX's
    ``install_torch_checkpoint`` makes of it; a ``MODEL.MOCO.K`` other
    than the file's raises and names the queue; an orbax directory is not
    supported."""
    import textreid_tpu.utils.weight_convert as jwc
    from textreid_tpu.utils.bootstrap import install_torch_checkpoint

    # both packages' flagship at a narrow width (a stage a bottleneck)
    monkeypatch.setattr(model_module, "build_m_resnet",
                        lambda cfg: ModifiedResNet(**RN_SPEC))
    convert = jwc.convert_m_resnet
    monkeypatch.setattr(jwc, "convert_m_resnet",
                        lambda sd, layers, final_grid=None: convert(
                            sd, RN_SPEC["layers"], final_grid))
    cfg = flagship_tiny_cfg(tmp_path)
    cfg.MODEL.MOCO.K = 16
    table = frozen_table(tmp_path)
    make_synthetic_dataset(str(tmp_path / "datasets" / "cuhkpedes"),
                           num_identities=4, images_per_id=4,
                           image_size=(64, 32), vocab_size=50,
                           max_tokens=10, split="train")
    batch = make_batch(1)
    batch["pixels"] = np.zeros((8, 64, 32, 3), np.uint8)
    model = jax_flagship_model(cfg, table)

    start = _jax_moco_state(model, batch, 16)
    # the file's state: every BatchNorm and bias moved off the start, the
    # key encoders apart from the query's, queues and pointer written
    rng = np.random.RandomState(3)
    params, stats = perturb_bn(perturb_biases(start.params), start.batch_stats,
                               seed=5)
    _, key_stats = perturb_bn(params, stats, seed=6)
    source = start.replace(
        params=params, batch_stats=stats, key_batch_stats=key_stats,
        key_params=perturb_biases(params, seed=4),
        v_queue=jnp.asarray(rng.randn(16, 32).astype(np.float32)),
        t_queue=jnp.asarray(rng.randn(16, 32).astype(np.float32)),
        id_queue=jnp.asarray(np.arange(16, dtype=np.int32) % 5),
        queue_ptr=jnp.asarray(8, jnp.int32))
    path = str(tmp_path / "reference.pth")
    jwc.save_torch_state_dict(
        jwc.export_textreid_checkpoint(_pieces(source), cfg), path)
    installed = install_torch_checkpoint(
        start,
        jwc.convert_textreid_checkpoint(jwc.load_torch_state_dict(path), cfg))
    want = train_state_from_jax(_pieces(installed))

    state, _ = train_net.main(_flagship_argv(
        tmp_path, "MODEL.MOCO.K", "16", "MODEL.WEIGHT", path))
    got = state.state_dict()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], torch.as_tensor(v)), k
    towers = [k for k in got["key_model"] if k.startswith(
        ("visual_model.", "textual_model."))]
    assert len(towers) > 100
    for k in towers:
        assert torch.equal(got["key_model"][k],
                           torch.as_tensor(want["key_model"][k])), k
    assert not torch.equal(got["key_model"]["visual_model.bn1.bias"],
                           got["model"]["visual_model.bn1.bias"])
    for k in ("v_queue", "t_queue", "id_queue"):
        assert torch.equal(got[k], torch.as_tensor(want[k]).to(got[k].dtype))
    assert got["queue_ptr"] == want["queue_ptr"] == 8

    with pytest.raises(ValueError, match="v_queue"):
        train_net.main(_flagship_argv(tmp_path, "MODEL.MOCO.K", "24",
                                      "MODEL.WEIGHT", path))
    with pytest.raises(NotImplementedError, match="not supported"):
        train_net.main(_flagship_argv(tmp_path, "MODEL.MOCO.K", "16",
                                      "MODEL.WEIGHT", str(tmp_path)))


def test_a_background_write_equals_a_synchronous_one(workspace, straight):
    """``async_save``: the snapshot is taken before ``save`` returns, so an
    in-place update right after it does not reach the file, and the file
    holds what a synchronous save of the same state holds."""
    state = straight[0]
    out = _out(workspace, "sync")
    out.mkdir(parents=True)
    sync, background = Checkpointer(str(out)), Checkpointer(str(out),
                                                            async_save=True)
    sync.save("sync", state, epoch=2, iteration=4)
    want = torch.load(out / "sync.pth", weights_only=True)
    param = next(state.model.parameters())
    background.save("background", state, epoch=2, iteration=4)
    with torch.no_grad():
        param.add_(1.0)  # the next step's update, while the write runs
    background.wait()
    with torch.no_grad():
        param.sub_(1.0)
    got = torch.load(out / "background.pth", weights_only=True)
    _assert_same(_state_tensors(got), _state_tensors(want))
    assert got["meta"] == {"epoch": 2, "iteration": 4}
    restored, meta = sync.resume(str(out / "background.pth"), state)
    assert meta == {"epoch": 2, "iteration": 4}


def test_a_failed_background_write_raises_at_the_next_wait(tmp_path,
                                                            straight):
    ckpt = Checkpointer(str(tmp_path / "missing"), async_save=True)
    ckpt.save("epoch_1", straight[0])
    with pytest.raises(RuntimeError, match="does not exist"):
        ckpt.wait()
    ckpt.wait()  # raised once


def test_guard_trip_signal_and_uninstall():
    """``PreemptionGuard`` (as JAX's): ``trip`` sets ``triggered`` (and,
    with one process, ``triggered_global``); an installed guard turns a
    SIGTERM into the flag and ``uninstall`` restores the handler before
    it."""
    import signal
    import time

    inert = PreemptionGuard(enabled=False)
    assert not inert.triggered and not inert.installed
    inert.trip()
    assert inert.triggered and inert.triggered_global()
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(enabled=True)
    try:
        assert guard.installed
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not guard.triggered and time.time() < deadline:
            time.sleep(0.01)
        assert guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_resume_from_an_orbax_directory_is_not_supported(tmp_path):
    with pytest.raises(NotImplementedError, match=re.escape(
            "export it to a reference .pth with tools/export_torch.py")):
        Checkpointer(str(tmp_path)).resume(str(tmp_path), None)


def test_a_weights_only_load_keeps_the_optimizer_queues_and_progress(
        workspace, straight):
    """``Checkpointer.load`` (JAX's weights-only load): both models' weights
    from the file; the optimizer, the queues, the pointer and ``step`` of
    the state it loads into stay as they were."""
    cfg_path = workspace / "configs" / "tiny" / "sync.yaml"
    state, _ = train_net.main(["--root", str(workspace), "--config-file",
                               str(cfg_path), "--device", "cpu",
                               "SOLVER.NUM_EPOCHS", "0"])
    before = _state_tensors(state)
    Checkpointer("").load(str(_out(workspace, "straight") / "best.pth"),
                          state)
    after = _state_tensors(state)
    saved = torch.load(_out(workspace, "straight") / "best.pth",
                       weights_only=True)
    for which in ("model", "key_model"):
        for k, v in saved[which].items():
            assert torch.equal(after[f"/{which}/{k}"], v), k
    rest = [k for k in before if not k.startswith(("/model/", "/key_model/"))]
    assert rest and any(k.startswith("/optimizer/") for k in rest)
    _assert_same({k: after[k] for k in rest}, {k: before[k] for k in rest})
    assert state.step == 0 and saved["step"] > 0
