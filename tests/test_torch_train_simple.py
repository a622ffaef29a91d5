"""The simple embedding head's train step against the JAX package's, on the
CPU in f32, and the simple head's state through the trainer, the
checkpoints and the warm start.

Two steps (``simple_train_step``: instance and global-align losses on f32
embeddings, the shared projection, no key model, no queue) of
``baseline_gru_cliprn50_ls_bs128.yaml`` (the narrow ModifiedResNet of
``tests/test_torch_train_step_bn.py`` + the bi-GRU over the frozen CLIP
table) and of ``baseline_gru_rn50_ls_bs128.yaml``'s family (the
torchvision ResNet, resnet18 here, res5 stride 1, + the bi-GRU over a
learnable table, ``ONEHOT: "yes"``), at 64x32 pixels, batch 8, from one
JAX init carried across with ``train_state_from_jax``, BatchNorm parameters
and statistics off their initial values.  Held as
``tests/test_torch_train_gru2l.py:assert_two_steps`` holds the MoCo step:
loss dicts (LOSS_RTOL), the trunk by its update (TRUNK_UPDATE_RTOL), every
other parameter at atol 1e-6 (entries under the gradient floor within two
Adam steps), the BatchNorm statistics (STATS_RTOL).  The full-width
resnet18's visual embed layer is held by its update
(DOWNSTREAM_UPDATE_RTOL): its second step follows the trunk's first.
"""

import os

import pytest
import torch

from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.models.resnet import ResNet as JaxResNet
from textreid_torch import train_net
from textreid_torch.data import make_synthetic_dataset
from textreid_torch.engine import create_train_state
from textreid_torch.models import build_model
from textreid_torch.solver import make_optimizer
from textreid_torch.utils.bootstrap import (
    install_reference_checkpoint,
    read_reference_checkpoint,
)
from textreid_torch.utils.checkpoint import Checkpointer
from textreid_torch.utils.weight_convert import save_reference_checkpoint

from test_torch_isolation import person_search_logger  # noqa: F401
from test_torch_train_gru2l import assert_two_steps, jax_start, port_start
from test_torch_train_step import CLASSES, VOCAB, frozen_table
from test_torch_train_step_bn import (
    RN_SPEC,
    make_batch,
    tiny_cfg,
    tiny_resnet,  # noqa: F401
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs", "cuhkpedes")
CLIP_YAML = os.path.join(CONFIGS, "baseline_gru_cliprn50_ls_bs128.yaml")
RN_YAML = os.path.join(CONFIGS, "baseline_gru_rn50_ls_bs128.yaml")


def simple_cfg(root, yaml):
    cfg = tiny_cfg(root)
    cfg.merge_from_file(yaml)
    cfg.MODEL.GRU.VOCABULARY_SIZE = VOCAB
    cfg.MODEL.GRU.EMBEDDING_SIZE = cfg.MODEL.GRU.NUM_UNITS = 16
    cfg.MODEL.NUM_CLASSES = CLASSES
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = RN_SPEC["input_resolution"]
    assert cfg.MODEL.EMBEDDING.EMBED_HEAD == "simple"
    return cfg


def jax_simple_model(cfg, visual, textual):
    return JaxModel(visual=visual, textual=textual, feature_size=32,
                    num_classes=CLASSES, embed_head="simple",
                    pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
                    pixel_std=tuple(cfg.INPUT.PIXEL_STD))


def test_two_simple_steps_of_the_clip_rn50_baseline_match_jax(
        tmp_path, tiny_resnet):  # noqa: F811
    cfg = simple_cfg(tmp_path, CLIP_YAML)
    table = frozen_table(tmp_path)
    batches = [make_batch(1), make_batch(2)]
    jax_model = jax_simple_model(
        cfg, JaxModifiedResNet(**RN_SPEC),
        JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                 use_onehot="clip_vit", frozen_table_init=lambda: table))
    jstate, jstep = jax_start(cfg, jax_model, batches)
    tstate, tstep = port_start(cfg, jstate)
    assert tstate.key_model is None and tstate.v_queue is None
    assert_two_steps(jstate, jstep, tstate, tstep, batches)


def test_two_simple_steps_of_the_torchvision_baseline_match_jax(tmp_path):
    cfg = simple_cfg(tmp_path, RN_YAML)
    cfg.MODEL.VISUAL_MODEL = "resnet18"
    assert cfg.MODEL.GRU.ONEHOT == "yes" and cfg.MODEL.RESNET.RES5_STRIDE == 1
    batches = [make_batch(1), make_batch(2)]
    jax_model = jax_simple_model(
        cfg, JaxResNet(block="basic", layers=(2, 2, 2, 2), res5_stride=1),
        JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                 use_onehot="yes"))
    jstate, jstep = jax_start(cfg, jax_model, batches)
    tstate, tstep = port_start(cfg, jstate)
    table = tstate.model.textual_model.embed.weight
    start = table.detach().clone()
    assert_two_steps(jstate, jstep, tstate, tstep, batches,
                     downstream=("embed_model.v_embed_layer.",))
    assert not torch.equal(table, start)  # the learnable table trains


TINY = """
MODEL:
  VISUAL_MODEL: "resnet18"
  TEXTUAL_MODEL: "bigru"
  NUM_CLASSES: 4
  RESNET: {RES5_STRIDE: 1}
  GRU: {ONEHOT: "yes", EMBEDDING_SIZE: 16, NUM_UNITS: 16,
        VOCABULARY_SIZE: 50, DROPOUT_KEEP_PROB: 1.0}
  EMBEDDING: {EMBED_HEAD: "simple", FEATURE_SIZE: 32, EPSILON: 0.1}
INPUT: {HEIGHT: 32, WIDTH: 16, USE_AUG: True, MAX_TEXT_LENGTH: 10}
DATASETS:
  TRAIN: ("cuhkpedes_train", )
  TEST: ("cuhkpedes_test", )
DATALOADER: {IMS_PER_ID: 4, NUM_WORKERS: 2}
SOLVER: {IMS_PER_BATCH: 8, NUM_EPOCHS: 2, BASE_LR: 0.0001, LOG_PERIOD: 1,
         CHECKPOINT_PERIOD: 1, CHECKPOINT_KEEP: 1, WARMUP_EPOCHS: 0}
TEST: {IMS_PER_BATCH: 8}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    for split, seed in (("train", 0), ("test", 1)):
        make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                               num_identities=4, images_per_id=4,
                               image_size=(32, 16), vocab_size=50,
                               max_tokens=10, split=split, seed=seed)
    (root / "configs" / "tiny").mkdir(parents=True)
    (root / "configs" / "tiny" / "simple.yaml").write_text(TINY)
    return root


def _main(root, *extra):
    return train_net.main(["--root", str(root), "--config-file",
                           str(root / "configs" / "tiny" / "simple.yaml"),
                           "--device", "cpu", *extra])


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, group in enumerate(state.optimizer.state_dict()["state"].values()):
        out.update({f"opt.{i}.{k}": v for k, v in group.items()})
    return out


def train_net_cfg(root):
    from textreid_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(root / "configs" / "tiny" / "simple.yaml"))
    cfg.ROOT = str(root)
    return cfg


def test_the_simple_head_trains_evaluates_saves_and_resumes(workspace):
    """``train_net`` with the simple head and evaluation every epoch: a
    ``best.pth`` and ``epoch_2.pth`` (``epoch_1.pth`` pruned), neither with
    a key model or a queue; one epoch, then ``--resume-from auto`` for the
    second, equal bit for bit to the straight run; the straight run's
    model warm-started from a reference-layout ``.pth`` of its own."""
    straight, _ = _main(workspace)
    out = workspace / "output" / "tiny" / "simple"
    assert sorted(p.name for p in out.glob("*.pth")) == ["best.pth",
                                                         "epoch_2.pth"]
    for name in ("best.pth", "epoch_2.pth"):
        ckpt = torch.load(out / name, weights_only=False)
        assert {"model", "optimizer", "step", "meta"} <= set(ckpt)
        assert not {"key_model", "v_queue", "id_queue", "queue_ptr"} & set(
            ckpt)
    assert straight.step == 4

    for p in out.glob("*.pth"):
        p.unlink()
    _main(workspace, "SOLVER.NUM_EPOCHS", "1")
    resumed, _ = _main(workspace, "--resume-from", "auto")
    assert resumed.step == 4
    a, b = _tensors(straight), _tensors(resumed)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    # a reference-layout warm start: the model alone, no key encoders
    ref = workspace / "reference.pth"
    save_reference_checkpoint(straight.model, str(ref))
    sd = read_reference_checkpoint(str(ref))
    assert not any("_k." in k or "queue" in k for k in sd)
    cfg = train_net_cfg(workspace)
    model = build_model(cfg, "cpu", train=True)
    state = create_train_state(cfg, model, make_optimizer(cfg, model), 8)
    install_reference_checkpoint(state, sd)
    for k, v in straight.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    warm, _ = _main(workspace, "MODEL.WEIGHT", str(ref),
                    "SOLVER.NUM_EPOCHS", "0")
    for k, v in straight.model.state_dict().items():
        assert torch.equal(warm.model.state_dict()[k], v), k

    # best.pth loads back into a simple-head state
    loaded = Checkpointer(str(workspace / "scratch")).resume(
        str(out / "epoch_2.pth"), state)[0]
    assert loaded.step == 4
