"""``python -m textreid_torch.train_net`` on the CPU: one epoch of two MoCo
steps of a tiny ViT + bi-GRU model on a synthetic CUHK-PEDES train split,
the same of the flagship (CLIP RN50 + bi-GRU) and of the torchvision
ResNet-50 baseline (simple head) at 32x16 pixels.  Every shipped yaml for
one step: ``tests/test_torch_train_configs.py``.  Evaluation during
training, checkpoints, resume, warm start and preemption:
``tests/test_torch_trainer.py``."""

import math
import os
import re
import subprocess
import sys

import pytest
import torch

from textreid_torch import train_net
from textreid_torch.data import make_synthetic_dataset

from test_torch_isolation import person_search_logger  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
DATALOADER: {IMS_PER_ID: 4, NUM_WORKERS: 2}
SOLVER: {IMS_PER_BATCH: 8, NUM_EPOCHS: 1, BASE_LR: 0.0001, LOG_PERIOD: 1,
         CHECKPOINT_PERIOD: 1, WARMUP_EPOCHS: 0, EVALUATE_PERIOD: 0}
TPU: {ALLOW_RANDOM_VOCAB: True, DEBUG_NANS: True}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                           num_identities=4, images_per_id=4,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="train")
    (root / "configs" / "tiny").mkdir(parents=True)
    (root / "configs" / "tiny" / "vit.yaml").write_text(TINY)
    return root


def test_cli_trains_one_epoch_on_the_cpu(workspace):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "textreid_torch.train_net", "--root",
         str(workspace), "--config-file", "configs/tiny/vit.yaml",
         "--device", "cpu"], cwd=workspace, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    steps = re.findall(r"epoch \[1\]\[(\d)/2\].*?loss: (\S+)", out.stdout)
    assert [s for s, _ in steps] == ["0", "1"], out.stdout[-3000:]
    assert all(math.isfinite(float(v)) for _, v in steps)

    out_dir = workspace / "output" / "tiny" / "vit"
    assert (out_dir / "log.txt").exists()
    ckpt = torch.load(out_dir / "epoch_1.pth", weights_only=False)
    assert {"model", "key_model", "optimizer", "v_queue", "t_queue",
            "id_queue", "queue_ptr", "meta"} <= set(ckpt)
    assert ckpt["meta"]["iteration"] == 2 and ckpt["meta"]["epoch"] == 1
    assert ckpt["queue_ptr"] == 16  # two batches of 8 into K=32
    assert (ckpt["id_queue"][:16] >= 0).all()
    assert (ckpt["id_queue"][16:] == -1).all()
    assert ckpt["v_queue"].shape == (32, 32)
    # the key encoders trail the query model (EMA), so the two differ
    name = "visual_model.proj"
    assert not torch.equal(ckpt["key_model"][name], ckpt["model"][name])


def _main(workspace, *extra):
    return train_net.main(["--root", str(workspace), "--config-file",
                           str(workspace / "configs" / "tiny" / "vit.yaml"),
                           "--device", "cpu", *extra])


def test_the_flagship_trains_one_epoch_on_the_cpu(workspace):
    """``train_net`` on the flagship's yaml (CLIP RN50 + bi-GRU, BatchNorm
    in training) at 32x16 pixels, batch 8, K=32: two finite steps, and a
    checkpoint whose query and key models both hold moved, distinct
    BatchNorm running statistics."""
    state, meters = train_net.main([
        "--root", str(workspace), "--config-file",
        os.path.join(REPO, "configs/cuhkpedes/"
                     "moco_gru_cliprn50_ls_bs128_2048.yaml"),
        "--device", "cpu", "INPUT.HEIGHT", "32", "INPUT.WIDTH", "16",
        "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.IMS_PER_ID", "4",
        "DATALOADER.NUM_WORKERS", "2", "MODEL.MOCO.K", "32",
        "MODEL.NUM_CLASSES", "4", "SOLVER.NUM_EPOCHS", "1",
        "SOLVER.EVALUATE_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "1",
        "SOLVER.LOG_PERIOD", "1", "TPU.ALLOW_RANDOM_VOCAB", "True",
        "TPU.DEBUG_NANS", "True"])
    assert state.step == 2 and state.queue_ptr == 16
    assert all(math.isfinite(v) for v in meters.loss.deque)
    ckpt = torch.load(workspace / "output" / "cuhkpedes" /
                      "moco_gru_cliprn50_ls_bs128_2048" / "epoch_1.pth",
                      weights_only=False)
    name = "visual_model.layer4.2.bn3.running_var"
    query, key = ckpt["model"][name], ckpt["key_model"][name]
    assert torch.isfinite(query).all() and torch.isfinite(key).all()
    assert not torch.equal(query, torch.ones_like(query))
    assert not torch.equal(query, key)


def test_the_flagship_trains_as_shipped_on_the_cpu(workspace):
    """The flagship's yaml with no ``SOLVER.EVALUATE_PERIOD`` override (1,
    its default): at 32x16 pixels, batch 8, two epochs of two steps, an
    evaluation on a synthetic test split after each, ``best.pth`` from
    the first evaluation with an R@1 above 0 and any strict gain after it,
    and ``CHECKPOINT_KEEP 1`` leaving ``epoch_2.pth`` alone."""
    from textreid_torch.utils.checkpoint import read_meta

    root = workspace / "as_shipped"
    data = root / "datasets" / "cuhkpedes"
    make_synthetic_dataset(str(data), num_identities=4, images_per_id=4,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="train")
    make_synthetic_dataset(str(data), num_identities=4, images_per_id=2,
                           image_size=(32, 16), vocab_size=50, max_tokens=10,
                           split="test", seed=1)
    state, meters = train_net.main([
        "--root", str(root), "--config-file",
        os.path.join(REPO, "configs/cuhkpedes/"
                     "moco_gru_cliprn50_ls_bs128_2048.yaml"),
        "--device", "cpu", "INPUT.HEIGHT", "32", "INPUT.WIDTH", "16",
        "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.IMS_PER_ID", "4",
        "DATALOADER.NUM_WORKERS", "2", "MODEL.MOCO.K", "32",
        "MODEL.NUM_CLASSES", "4", "SOLVER.NUM_EPOCHS", "2",
        "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.CHECKPOINT_KEEP", "1",
        "TEST.IMS_PER_BATCH", "8", "TPU.ALLOW_RANDOM_VOCAB", "True"])
    out = root / "output" / "cuhkpedes" / "moco_gru_cliprn50_ls_bs128_2048"
    top1 = list(meters.top1.deque)
    assert state.step == 4 and len(top1) == 2
    assert all(math.isfinite(v) for v in top1)
    assert sorted(p.name for p in out.glob("*.pth")) == [
        "best.pth", "epoch_2.pth"]
    best = read_meta(out / "best.pth")
    assert best["best_top1"] == max(top1) > 0
    assert best["epoch"] == 1 + top1.index(max(top1))


def test_the_clip_rn50_archive_loads_into_both_trunks_as_jax_loads_it(
        workspace, tmp_path):
    """A CLIP-layout ``ROOT/pretrained/clip/RN50.pt`` (seeded: the port's
    ModifiedResNet-50 at CLIP's 224x224, BatchNorm statistics moved, under
    ``visual.`` beside a text-tower key, as a whole archive has it): after
    ``train_net`` starts the flagship at 32x16 pixels, the query and the
    key trunk both equal what JAX's ``load_clip_visual`` makes of the same
    file (carried over with ``state_dict_from_jax``'s layout), exactly but
    the resized 7x7 -> 2x1 positional embedding (1e-6).  An archive that
    lacks a key of the trunk raises."""
    import numpy as np

    from textreid_torch.models.m_resnet import ModifiedResNet
    from textreid_torch.utils import weight_convert
    from textreid_tpu.utils.weight_convert import load_clip_visual

    torch.manual_seed(3)
    clip = ModifiedResNet((3, 4, 6, 3), 1024, heads=32,
                          input_resolution=(224, 224))
    gen = torch.Generator().manual_seed(4)
    archive = {}
    for k, v in clip.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.randn(v.shape, generator=gen) * 0.1
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=gen) + 0.5
        archive["visual." + k] = v
    archive["token_embedding.weight"] = torch.zeros(4, 8)
    root = tmp_path / "root"
    (root / "pretrained" / "clip").mkdir(parents=True)
    path = root / "pretrained" / "clip" / "RN50.pt"
    torch.save(archive, path)
    for item in (workspace / "datasets").iterdir():
        (root / "datasets").mkdir(exist_ok=True)
        (root / "datasets" / item.name).symlink_to(item)
    argv = [
        "--root", str(root), "--config-file",
        os.path.join(REPO, "configs/cuhkpedes/"
                     "moco_gru_cliprn50_ls_bs128_2048.yaml"),
        "--device", "cpu", "INPUT.HEIGHT", "32", "INPUT.WIDTH", "16",
        "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.IMS_PER_ID", "4",
        "DATALOADER.NUM_WORKERS", "2", "MODEL.MOCO.K", "32",
        "MODEL.NUM_CLASSES", "4", "SOLVER.NUM_EPOCHS", "0",
        "SOLVER.EVALUATE_PERIOD", "0", "TPU.ALLOW_RANDOM_VOCAB", "True"]
    state, _ = train_net.main(argv)

    jax = load_clip_visual(str(path), "RN50", (2, 1))
    want = {}
    weight_convert._visual(want, "", jax["params"], jax["batch_stats"])
    pos = "attnpool.positional_embedding"
    assert want[pos].shape == (3, 2048)
    for model in (state.model, state.key_model):
        got = model.visual_model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            if k == pos:
                np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                           atol=1e-6)
            else:
                assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k
    assert not torch.equal(state.model.visual_model.bn1.running_var,
                           torch.ones(32))

    del archive["visual.layer4.2.bn3.running_var"]
    torch.save(archive, path)
    with pytest.raises(KeyError, match="layer4.2.bn3.running_var"):
        train_net.main(argv)


def test_the_torchvision_resnet50_trains_one_epoch_on_the_cpu(workspace):
    """``baseline_gru_rn50_ls_bs128.yaml`` (torchvision ResNet-50 + bi-GRU
    over a learnable 12k-row table, simple head) at 32x16 pixels, batch 8:
    two finite steps; the checkpoint holds no key model and no queue; the
    trunk's running statistics moved, and the token table trains."""
    state, meters = train_net.main([
        "--root", str(workspace), "--config-file",
        os.path.join(REPO, "configs/cuhkpedes/"
                     "baseline_gru_rn50_ls_bs128.yaml"),
        "--device", "cpu", "INPUT.HEIGHT", "32", "INPUT.WIDTH", "16",
        "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.IMS_PER_ID", "4",
        "DATALOADER.NUM_WORKERS", "2", "MODEL.NUM_CLASSES", "4",
        "SOLVER.NUM_EPOCHS", "1", "SOLVER.EVALUATE_PERIOD", "0",
        "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.LOG_PERIOD", "1",
        "TPU.DEBUG_NANS", "True"])
    assert state.step == 2 and state.key_model is None
    losses = list(meters.loss.deque)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert set(meters.meters) >= {"instance_loss", "global_align_loss"}
    ckpt = torch.load(workspace / "output" / "cuhkpedes" /
                      "baseline_gru_rn50_ls_bs128" / "epoch_1.pth",
                      weights_only=False)
    assert {"model", "optimizer", "meta"} <= set(ckpt)
    assert not {"key_model", "v_queue", "queue_ptr"} & set(ckpt)
    var = ckpt["model"]["visual_model.layer4.2.bn3.running_var"]
    assert torch.isfinite(var).all() and not torch.equal(
        var, torch.ones_like(var))
    # the learnable table trains: the last step's gradient reached it
    assert state.model.textual_model.embed.weight.grad.abs().sum() > 0


def test_cuda_without_a_card_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(RuntimeError, match="is_available"):
        train_net.main(["--root", str(workspace), "--device", "cuda"])
