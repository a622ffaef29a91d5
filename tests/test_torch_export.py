"""``textreid_torch.tools.export_torch``: the port's export of a train state
against the JAX package's ``export_textreid_checkpoint`` on the same
pieces (the port's state from ``train_state_from_jax``), the JAX importer
reading the port's file, and the CLI's round trip from a checkpoint of the
port back into a fresh state, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_isolation import person_search_logger  # noqa: F401
from textreid_tpu.config import get_default_cfg as jax_default_cfg
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxTextReIDModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.utils.weight_convert import (
    convert_textreid_checkpoint,
    export_textreid_checkpoint,
    load_torch_state_dict,
)
from textreid_torch.config import get_default_cfg
from textreid_torch.tools import export_torch
from textreid_torch.utils.bootstrap import (
    build_train_state,
    install_reference_checkpoint,
    read_reference_checkpoint,
)
from textreid_torch.utils.checkpoint import Checkpointer
from textreid_torch.utils.weight_convert import (
    export_reference_state_dict,
    save_reference_state_dict,
    train_state_from_jax,
)

torch.set_num_threads(2)

VOCAB, EMB, HID, FEAT, K = 30, 8, 6, 12, 8
# (head, MOCO.FC, GRU.ONEHOT): the MoCo CLIP-RN50 model with its projectors
# over the frozen table, the simple head, and a learned token table
CASES = {"moco_fc": ("moco", True, "clip_vit"),
         "simple": ("simple", False, "clip_vit"),
         "learned_vocab": ("moco", False, "yes")}


def _cfg(factory, case):
    head, fc, onehot = CASES[case]
    cfg = factory()
    cfg.MODEL.VISUAL_MODEL = "m_resnet50"
    cfg.MODEL.TEXTUAL_MODEL = "bigru"
    cfg.MODEL.GRU.ONEHOT = onehot
    cfg.MODEL.GRU.VOCABULARY_SIZE = VOCAB
    cfg.MODEL.GRU.EMBEDDING_SIZE = EMB
    cfg.MODEL.GRU.NUM_UNITS = HID
    cfg.MODEL.RESNET.RES5_STRIDE = 1
    cfg.MODEL.EMBEDDING.EMBED_HEAD = head
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = FEAT
    cfg.MODEL.MOCO.FC = fc
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 64, 32
    return cfg


def _drawn(tree, rng):
    return jax.tree.map(
        lambda x: rng.randn(*x.shape).astype(x.dtype), tree)


def _perturbed(tree, rng):
    return jax.tree.map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(
            np.asarray(x).dtype), tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_case(request):
    """(case, JAX TrainState pieces) of a tiny-width CLIP RN50 (RN50's
    block counts, which the JAX importer assumes) + bi-GRU model."""
    case = request.param
    head, fc, onehot = CASES[case]
    model = JaxTextReIDModel(
        visual=JaxModifiedResNet(layers=(3, 4, 6, 3), output_dim=16, heads=2,
                                 input_resolution=(64, 32), width=8),
        textual=JaxBiGRU(hidden_dim=HID, vocab_size=VOCAB, embed_size=EMB,
                         use_onehot=onehot, allow_random_table=True),
        feature_size=FEAT, num_classes=5, embed_head=head, moco_fc=fc)
    # shapes only (no compile): every value is drawn from the seed
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3), jnp.uint8),
        jnp.ones((1, 6), jnp.int32), jnp.ones((1,), jnp.int32),
        method="init_all"))
    rng = np.random.RandomState(3)
    pieces = {name: _drawn(shapes[name], rng)
              for name in ("params", "batch_stats", "constants")
              if name in shapes}
    # running variances stay positive
    pieces["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: np.abs(x) if p[-1].key == "var" else x,
        pieces["batch_stats"])
    if head == "moco":
        pieces.update(
            key_params=_perturbed(pieces["params"], rng),
            key_batch_stats=jax.tree.map(lambda x: x * 1.5,
                                         pieces["batch_stats"]),
            v_queue=rng.randn(K, FEAT).astype(np.float32),
            t_queue=rng.randn(K, FEAT).astype(np.float32),
            id_queue=rng.randint(-1, 9, K).astype(np.int32),
            queue_ptr=np.asarray(4, np.int32))
    return case, pieces


def test_export_equals_the_jax_exporter(jax_case):
    """Key for key, dtype for dtype, value for value."""
    case, pieces = jax_case
    want = export_textreid_checkpoint(pieces, _cfg(jax_default_cfg, case))
    got = export_reference_state_dict(_cfg(get_default_cfg, case),
                                      train_state_from_jax(pieces))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    if CASES[case][2] == "yes":  # the learned table's pad row
        assert not got["textual_model.embed.weight"][0].any()
        assert np.asarray(
            pieces["params"]["textual"]["token_embedding"])[0].any()


def test_the_jax_importer_reads_the_exported_file(jax_case, tmp_path):
    case, pieces = jax_case
    path = str(tmp_path / "exported.pth")
    save_reference_state_dict(export_reference_state_dict(
        _cfg(get_default_cfg, case), train_state_from_jax(pieces)), path)
    back = convert_textreid_checkpoint(load_torch_state_dict(path),
                                       _cfg(jax_default_cfg, case))
    want = {k: v for k, v in pieces.items() if k != "constants"}
    if "key_params" in want:  # the key encoders: towers and projectors
        want["key_params"] = {k: v for k, v in want["key_params"].items()
                              if k in ("visual", "textual", "v_fc", "t_fc")}
    if CASES[case][2] == "yes":  # zeroed on export, as the reference has it
        for tree in ("params", "key_params"):
            table = np.array(want[tree]["textual"]["token_embedding"])
            table[0] = 0.0
            want[tree] = {**want[tree], "textual": {
                **want[tree]["textual"], "token_embedding": table}}
    assert sorted(back) == sorted(want)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path_, got), (_, value) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(value),
                                      err_msg=str(path_))


def test_a_transformer_tower_is_refused_with_the_jax_wording():
    jax_cfg = _cfg(jax_default_cfg, "simple")
    jax_cfg.MODEL.TEXTUAL_MODEL = "transformer"
    with pytest.raises(ValueError) as want:
        export_textreid_checkpoint({"params": {}}, jax_cfg)
    cfg = _cfg(get_default_cfg, "simple")
    cfg.MODEL.TEXTUAL_MODEL = "transformer"
    with pytest.raises(ValueError) as got:
        export_reference_state_dict(cfg, {"model": {}})
    assert str(got.value) == str(want.value)


TINY = """
MODEL:
  VISUAL_MODEL: "resnet18"
  TEXTUAL_MODEL: "bigru"
  NUM_CLASSES: 8
  GRU: {VOCABULARY_SIZE: 40, EMBEDDING_SIZE: 16, NUM_UNITS: 16}
  EMBEDDING: {EMBED_HEAD: "moco", FEATURE_SIZE: 16}
  MOCO: {K: 16, FC: True}
INPUT: {HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: 10}
SOLVER: {IMS_PER_BATCH: 8}
"""


def test_cli_exports_a_checkpoint_that_reinstalls_bit_for_bit(tmp_path):
    """A checkpoint of the port (``Checkpointer.save``) through the CLI, the
    file installed into a fresh state: query model, key encoders, queues
    and pointer all equal; re-exporting the exported file gives it back."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY)
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    cfg.freeze()
    state = build_train_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for model in (state.model, state.key_model):
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=gen))
            # the export writes the learned table's pad row as zeros, as
            # nn.Embedding(padding_idx=0) has it
            model.textual_model.embed.weight[0] = 0.0
        state.id_queue.copy_(torch.arange(16) % 5)
    state.queue_ptr = 8
    Checkpointer(str(tmp_path)).save("best", state, epoch=1)
    out = str(tmp_path / "exported.pth")
    sd = export_torch.main(["--config-file", str(cfg_path),
                            "--checkpoint-file", str(tmp_path / "best.pth"),
                            "--output", out, "--device", "cpu"])
    assert sd["embed_model.queue_ptr"].tolist() == [8]
    assert sd["embed_model.v_queue"].shape == (16, 16)
    assert not any(k.startswith("optimizer") or k == "meta" for k in sd)
    fresh = build_train_state(cfg, "cpu")
    install_reference_checkpoint(fresh, read_reference_checkpoint(out))
    for mine, theirs in ((state.model, fresh.model),
                         (state.key_model, fresh.key_model)):
        want, got = mine.state_dict(), theirs.state_dict()
        for key in want:
            if key.startswith(("visual_model.", "textual_model.")) or (
                    mine is state.model) or "_fc_q." in key:
                if key.endswith("num_batches_tracked"):
                    continue
                assert torch.equal(got[key], want[key]), key
    for name in ("v_queue", "t_queue", "id_queue"):
        assert torch.equal(getattr(fresh, name), getattr(state, name)), name
    assert fresh.queue_ptr == 8
    again = export_torch.main(["--config-file", str(cfg_path),
                               "--checkpoint-file", out, "--output",
                               str(tmp_path / "again.pth"), "--device",
                               "cpu"])
    assert sorted(again) == sorted(sd)
    for key in sd:
        assert torch.equal(again[key], sd[key]), key
