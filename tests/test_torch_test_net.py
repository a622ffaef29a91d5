"""The eval path as a whole: ``python -m textreid_torch.test_net`` and the
port's ``inference`` against the JAX package's ``inference`` on the same
weights, on the CPU in float32.

A tiny synthetic CUHK-PEDES test split (8 identities x 2 images at 32x16)
and a narrow m_resnet50 (res5 stride 1) with a 2-layer bi-GRU (H=16) over a
seeded frozen token table.  The JAX state crosses with
``state_dict_from_jax`` into a ``.pth``.  Embeddings agree to atol 1e-4
(convolutions sum in another order), the metric grid is the same, and an
``inference_data.npz`` written by either package is replayed by the other,
as is one in the reference's similarity-matrix format.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.config import get_default_cfg as jax_default_cfg
from textreid_tpu.data import make_data_loader as jax_make_data_loader
from textreid_tpu.engine.inference import inference as jax_inference
from textreid_tpu.engine.state import TrainState
from textreid_tpu.models import build_model as jax_build_model
from textreid_tpu.utils.vocab import frozen_table_initializer
from textreid_torch import test_net
from textreid_torch.config import get_default_cfg
from textreid_torch.data import make_data_loader, make_synthetic_dataset
from textreid_torch.engine.inference import compute_embeddings, inference
from textreid_torch.evaluation.metrics import format_results_table
from textreid_torch.utils.bootstrap import build_eval_model
from textreid_torch.utils.weight_convert import state_dict_from_jax

torch.set_num_threads(2)

TINY = """
MODEL:
  VISUAL_MODEL: "m_resnet50"
  TEXTUAL_MODEL: "bigru"
  NUM_CLASSES: 8
  RESNET: {RES5_STRIDE: 1}
  GRU: {ONEHOT: "clip_vit", VOCABULARY_SIZE: 16, EMBEDDING_SIZE: 16,
        NUM_UNITS: 16, NUM_LAYER: 2}
  EMBEDDING: {EMBED_HEAD: "moco", FEATURE_SIZE: 32}
INPUT: {HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: 12}
DATASETS:
  TEST: ("cuhkpedes_test", )
DATALOADER: {NUM_WORKERS: 2}
TEST: {IMS_PER_BATCH: 6}
TPU: {ALLOW_RANDOM_VOCAB: True}
"""


def _cfg(factory, root):
    cfg = factory()
    cfg.merge_from_file(str(root / "configs" / "tiny" / "eval.yaml"))
    cfg.ROOT = str(root)
    cfg.freeze()
    return cfg


def _table(text, column):
    """One column of a logged metric grid as floats."""
    lines = [ln.split() for ln in text.strip().splitlines()]
    at = lines[0].index(column)
    return [float(ln[at]) for ln in lines[1:]]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, checkpoint path, jax (model, state, loader), jax cache dir)."""
    root = tmp_path_factory.mktemp("ws")
    make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                           num_identities=8, images_per_id=2,
                           image_size=(32, 16), vocab_size=16, max_tokens=10,
                           split="test", seed=1)
    (root / "configs" / "tiny").mkdir(parents=True)
    (root / "configs" / "tiny" / "eval.yaml").write_text(TINY)

    cfg = _cfg(jax_default_cfg, root)
    loader = jax_make_data_loader(cfg, is_train=False)[0]
    model = jax_build_model(cfg, frozen_table_initializer(cfg))
    sample = next(iter(loader))
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(sample["pixels"]),
        jnp.asarray(sample["token_ids"]), jnp.asarray(sample["lengths"]),
        method="init_all"))()
    rng = np.random.RandomState(0)

    def leaf(path, x):  # seeded values: BN statistics away from (0, 1)
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return np.asarray(x)

    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=jax.tree_util.tree_map_with_path(
            leaf, variables["batch_stats"]),
        constants=variables["constants"], opt_state=None)
    ckpt = str(root / "model.pth")
    torch.save({"model": {
        k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(
            {"params": state.params, "batch_stats": state.batch_stats,
             "constants": state.constants}).items()}}, ckpt)
    jax_dir = root / "jax_cache"
    jax_dir.mkdir()
    return root, ckpt, (model, state, loader), jax_dir


@pytest.fixture(scope="module")
def jax_run(workspace, caplog_module):
    """The JAX ``inference`` on the workspace: (top-1, logged grid)."""
    _, _, (model, state, loader), jax_dir = workspace
    with caplog_module.at_level(logging.INFO, "PersonSearch.inference"):
        caplog_module.clear()
        top1 = jax_inference(model, state, loader, output_folder=str(jax_dir),
                             save_data=True)
        grid = caplog_module.messages[-1]
    return top1, grid


@pytest.fixture(scope="module")
def caplog_module():
    """A module-scoped log capture on the eval logger (``caplog`` is
    function-scoped and the PersonSearch logger does not propagate)."""
    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

        def clear(self):
            self.messages.clear()

        def at_level(self, level, name):
            logger = logging.getLogger(name)
            logger.setLevel(level)
            handler = self

            class Ctx:
                def __enter__(self):
                    logger.addHandler(handler)

                def __exit__(self, *exc):
                    logger.removeHandler(handler)
            return Ctx()
    return Capture()


def _port_model(workspace):
    root, ckpt, _, _ = workspace
    cfg = _cfg(get_default_cfg, root)
    return cfg, build_eval_model(cfg, ckpt, "cpu")


def test_two_layer_jax_state_loads_into_the_port(workspace):
    _, model = _port_model(workspace)
    sd = model.state_dict()
    assert sd["textual_model.gru.weight_ih_l1"].shape == (48, 32)
    assert sd["textual_model.gru.weight_hh_l1_reverse"].shape == (48, 16)
    assert not model.training


def test_embeddings_match_jax(workspace, jax_run):
    root, _, _, jax_dir = workspace
    cfg, model = _port_model(workspace)
    got = compute_embeddings(model, make_data_loader(cfg, is_train=False)[0])
    with np.load(jax_dir / "inference_data.npz") as want:
        for key in ("v_embed", "t_embed"):
            assert got[key].shape == (16, 32)
            np.testing.assert_allclose(got[key], want[key], atol=1e-4)
        for key in ("pids", "image_ids"):
            np.testing.assert_array_equal(got[key], want[key])


def test_cli_prints_the_jax_grid_and_replays_its_cache(workspace, jax_run,
                                                       caplog_module):
    root, ckpt, _, jax_dir = workspace
    want_top1, want_grid = jax_run
    argv = ["--root", str(root), "--config-file",
            str(root / "configs" / "tiny" / "eval.yaml"),
            "--checkpoint-file", ckpt, "--device", "cpu", "--load-result"]
    out_dir = root / "output" / "tiny" / "eval" / "inference" / "cuhkpedes_test"
    with caplog_module.at_level(logging.INFO, "PersonSearch.inference"):
        caplog_module.clear()
        top1 = test_net.main(argv)
        grid = caplog_module.messages[-1]
        assert any("Start evaluation" in m for m in caplog_module.messages)
        cache = out_dir / "inference_data.npz"
        assert cache.exists()
        # the second run replays the cache and encodes nothing
        caplog_module.clear()
        again = test_net.main(argv)
        assert any("Loading cached" in m for m in caplog_module.messages)
        assert not any("Start evaluation" in m
                       for m in caplog_module.messages)
        assert caplog_module.messages[-1] == grid
    assert again == top1 == {"cuhkpedes_test": pytest.approx(want_top1,
                                                             abs=1e-4)}
    assert grid.strip().splitlines()[0].split() == ["topk", "t2i", "re_t2i",
                                                    "i2t", "re_i2t"]
    for col in ("t2i", "re_t2i", "i2t", "re_i2t"):
        np.testing.assert_allclose(_table(grid, col), _table(want_grid, col),
                                   atol=0.011)  # the table prints 2 decimals
    with np.load(cache) as got, np.load(jax_dir / "inference_data.npz") as want:
        assert set(got.files) == set(want.files)  # the dual format
        for key in ("similarity", "rvn_mat", "rtn_mat"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-4)


def test_caches_cross_replay_between_the_packages(workspace, jax_run,
                                                  caplog_module, tmp_path):
    root, ckpt, (jax_model, state, loader), jax_dir = workspace
    want_top1, want_grid = jax_run
    cfg, model = _port_model(workspace)
    with caplog_module.at_level(logging.INFO, "PersonSearch.inference"):
        # the port replays what the JAX package wrote (no loader needed)
        caplog_module.clear()
        top1 = inference(model, None, output_folder=str(jax_dir))
        assert top1 == pytest.approx(want_top1, abs=1e-4)
        assert caplog_module.messages[-1] == want_grid
        # the JAX package replays what the port wrote
        port_top1 = inference(model, make_data_loader(cfg, is_train=False)[0],
                              output_folder=str(tmp_path), save_data=True)
        port_grid = caplog_module.messages[-1]
        poisoned = state.replace(
            params=jax.tree.map(lambda x: x * 0.0, state.params))
        replayed = jax_inference(jax_model, poisoned, loader,
                                 output_folder=str(tmp_path))
        assert replayed == pytest.approx(port_top1, abs=1e-4)
        assert caplog_module.messages[-1] == port_grid


def test_reference_format_cache_is_replayed(workspace, caplog_module,
                                            tmp_path):
    """{image_pid, text_pid, similarity, rvn_mat, rtn_mat} without
    embeddings, as the reference torch code saves it."""
    _, model = _port_model(workspace)
    rng = np.random.RandomState(5)
    q, g = 12, 8
    data = dict(similarity=rng.randn(q, g).astype(np.float32),
                text_pid=rng.randint(0, 4, q), image_pid=rng.randint(0, 4, g),
                rvn_mat=(rng.rand(q, g) * 0.05).astype(np.float32),
                rtn_mat=(rng.rand(g, q) * 0.05).astype(np.float32))
    np.savez(tmp_path / "inference_data.npz", **data)
    with caplog_module.at_level(logging.INFO, "PersonSearch.inference"):
        top1 = inference(model, None, output_folder=str(tmp_path))
        port_grid = caplog_module.messages[-1]
        want = jax_inference(None, None, None, output_folder=str(tmp_path))
        assert caplog_module.messages[-1] == port_grid
    assert top1 == pytest.approx(want, abs=1e-4)
    assert "re_i2t" in port_grid


def test_an_orbax_directory_and_a_missing_card_raise(workspace, tmp_path):
    root, ckpt, _, _ = workspace
    argv = ["--root", str(root), "--config-file",
            str(root / "configs" / "tiny" / "eval.yaml")]
    with pytest.raises(NotImplementedError, match="not supported; export "
                       "it to a reference .pth with tools/export_torch.py"):
        test_net.main(argv + ["--checkpoint-file", str(tmp_path),
                              "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            test_net.main(argv + ["--checkpoint-file", ckpt])
