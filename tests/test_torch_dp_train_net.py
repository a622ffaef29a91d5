"""``textreid_torch.train_net`` and ``test_net`` on 2 gloo ranks on the CPU
(``--device cpu``, a ``file://`` store; ``tests/torch_dp_worker.py``)
against one process, on the synthetic workspace and the tiny ViT + bi-GRU
MoCo yaml of ``tests/test_torch_trainer.py`` (batch 8: 4 rows a rank;
evaluation after every epoch).

* One epoch on 2 ranks: rank 0 alone logs (``log.txt``, the console) and
  writes ``epoch_1.pth`` and ``best.pth``; the checkpoint's weights,
  queues, ids and pointer equal the one-process run's within the step
  tolerances (f32 sums in another order: 1e-5; the attention's key bias,
  whose gradient is exactly zero, within its two Adam steps) and the
  in-training evaluation's R@1 equals it.
* The process-sharded train loader: the 2 ranks' local batches concatenate
  to the one-process global batch, augmentation included.
* SIGTERM to rank 1 alone at its third step: both ranks stop at that
  iteration, one ``preempt.pth`` (epoch pinned back); ``--resume-from
  auto`` on 2 ranks then finishes the budget from it.
* ``test_net`` on 2 ranks: the one-process embeddings and grid.
"""

import os

import numpy as np
import pytest
import torch

from textreid_torch import test_net, train_net
from textreid_torch.data import make_data_loader, make_synthetic_dataset
from textreid_torch.config import get_default_cfg
from textreid_torch.utils.checkpoint import read_meta

from test_torch_isolation import person_search_logger  # noqa: F401
from test_torch_trainer import TINY
from torch_dp_worker import launch

torch.set_num_threads(2)

LR = 0.001  # TINY's BASE_LR, no warmup
NAMES = ("single", "dp", "preempted", "eval_single", "eval_dp")


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
    for name in NAMES:
        (root / "configs" / "tiny" / f"{name}.yaml").write_text(TINY)
    return root


def _argv(root, name, *extra):
    return ["--root", str(root), "--config-file",
            str(root / "configs" / "tiny" / f"{name}.yaml"), "--device",
            "cpu", *extra]


def _out(root, name):
    return root / "output" / "tiny" / name


def _two_ranks(root, tmp, module, argv, sigterm=None):
    return launch("main", {"module": module, "argv": argv,
                           "sigterm": sigterm}, tmp)


@pytest.fixture(scope="module")
def one_epoch(workspace, tmp_path_factory):
    """(one process's state, the 2 ranks' outputs, the ranks' directory)
    after one epoch of the same yaml."""
    state, _ = train_net.main(_argv(workspace, "single", "SOLVER.NUM_EPOCHS",
                                    "1"))
    tmp = tmp_path_factory.mktemp("dp_ranks")
    out = _two_ranks(workspace, tmp, "train_net",
                     _argv(workspace, "dp", "SOLVER.NUM_EPOCHS", "1"))
    return state, out, tmp


def _zero_gradient(name, w):
    """The entries whose loss gradient is exactly zero: the key third of an
    attention's ``in_proj_bias`` (a softmax does not see a constant added
    to every key); their gradient is rounding noise, which Adam's first
    steps turn into +-lr either way."""
    mask = torch.zeros_like(w, dtype=torch.bool)
    if name.endswith("attn.in_proj_bias"):
        third = w.numel() // 3
        mask[third:2 * third] = True
    return mask


def _close(got, want, what, adam_bound):
    """Tensors within 1e-5 (f32 sums in another order), the zero-gradient
    entries within two Adam steps."""
    for name, w in want.items():
        g = got[name]
        if not isinstance(w, torch.Tensor) or not w.is_floating_point():
            assert torch.equal(torch.as_tensor(g), torch.as_tensor(w)), name
            continue
        noise = _zero_gradient(name, w)
        torch.testing.assert_close(g[~noise], w[~noise], rtol=1e-5,
                                   atol=1e-5, msg=f"{what} {name}")
        assert ((g - w)[noise].abs() <= adam_bound).all(), name


def test_two_ranks_train_one_epoch_as_one_process(workspace, one_epoch):
    single, out, tmp = one_epoch
    assert out[0]["step"] == out[1]["step"] == single.step == 2
    dp_dir, single_dir = _out(workspace, "dp"), _out(workspace, "single")
    # (the in-process run writes a log.txt only when it is the first to set
    # up the process's "PersonSearch" logger, so its listing is not held)
    assert sorted(os.listdir(dp_dir)) == ["best.pth", "epoch_1.pth",
                                          "log.txt"]
    assert {"best.pth", "epoch_1.pth"} <= set(os.listdir(single_dir))
    with open(dp_dir / "log.txt") as f:
        log = f.read()
    assert log.count("Running with config") == 1  # rank 0's alone
    assert "Data parallel over 2 ranks: 4 of the 8 rows" in log
    with open(tmp / "rank1.log") as f:
        assert "PersonSearch" not in f.read()
    with open(tmp / "rank0.log") as f:
        assert "Evaluation after epoch 1" in f.read()
    want = torch.load(single_dir / "epoch_1.pth", weights_only=True)
    got = torch.load(dp_dir / "epoch_1.pth", weights_only=True)
    for which in ("model", "key_model"):
        _close(got[which], want[which], which, adam_bound=2 * 2 * LR)
    for name in ("v_queue", "t_queue"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-5)
    assert torch.equal(got["id_queue"], want["id_queue"])
    assert got["queue_ptr"] == want["queue_ptr"] == 16
    assert got["meta"]["iteration"] == want["meta"]["iteration"] == 2
    assert read_meta(dp_dir / "best.pth")["best_top1"] == pytest.approx(
        read_meta(single_dir / "best.pth")["best_top1"], abs=1e-9)
    # every rank holds the same state, rank 0's on disk
    for which in ("model", "key_model"):
        for name, v in out[1]["state"][which].items():
            torch.testing.assert_close(v, out[0]["state"][which][name],
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(v, got[which][name], rtol=0, atol=0)


def test_process_sharded_loader_concatenates_to_the_global_batch(workspace):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(workspace / "configs" / "tiny" / "dp.yaml"))
    cfg.ROOT = str(workspace)
    loaders = [make_data_loader(cfg, is_train=True, process_shard=shard)
               for shard in (None, (0, 2), (1, 2))]
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == len(batches[2]) == 2
        for whole, a, b in zip(*batches):
            assert a["pixels"].shape[0] == 4
            for key in whole:
                np.testing.assert_array_equal(
                    np.concatenate([a[key], b[key]]), whole[key], key)


def test_sigterm_to_one_rank_stops_both_and_auto_resume_continues(
        workspace, tmp_path_factory):
    """Rank 1 is signalled as its third step starts (the first of epoch
    2): both ranks stop after it, rank 0 writes one ``preempt.pth``
    (epoch pinned to 1); ``--resume-from auto`` on 2 ranks runs epoch 2
    again and ends the budget."""
    out = _two_ranks(workspace, tmp_path_factory.mktemp("preempt"),
                     "train_net", _argv(workspace, "preempted"),
                     sigterm=(1, 3))
    assert out[0]["step"] == out[1]["step"] == 3
    save_dir = _out(workspace, "preempted")
    meta = read_meta(save_dir / "preempt.pth")
    assert meta["epoch"] == 1 and meta["iteration"] == 3
    assert not (save_dir / "epoch_2.pth").exists()
    assert not list(save_dir.glob("*.tmp"))
    preempted = torch.load(save_dir / "preempt.pth", weights_only=True)
    torch.testing.assert_close(preempted["model"], out[1]["state"]["model"],
                               rtol=0, atol=0)
    out = _two_ranks(workspace, tmp_path_factory.mktemp("resume"),
                     "train_net", _argv(workspace, "preempted",
                                        "--resume-from", "auto"))
    assert out[0]["step"] == out[1]["step"] == 5
    assert read_meta(save_dir / "epoch_2.pth")["iteration"] == 5
    for name, v in out[1]["state"]["model"].items():
        torch.testing.assert_close(v, out[0]["state"]["model"][name],
                                   rtol=0, atol=1e-6)


def test_test_net_on_two_ranks_gives_the_one_process_grid(
        workspace, one_epoch, tmp_path_factory):
    checkpoint = str(_out(workspace, "single") / "epoch_1.pth")
    want = test_net.main(_argv(workspace, "eval_single", "--checkpoint-file",
                               checkpoint, "--load-result"))
    tmp = tmp_path_factory.mktemp("eval_ranks")
    out = _two_ranks(workspace, tmp, "test_net", _argv(
        workspace, "eval_dp", "--checkpoint-file", checkpoint,
        "--load-result"))
    assert out[0]["top1"] == out[1]["top1"] == pytest.approx(want, abs=1e-9)
    caches = [np.load(_out(workspace, name) / "inference" / "cuhkpedes_test"
                      / "inference_data.npz")
              for name in ("eval_single", "eval_dp")]
    assert set(caches[0].files) == set(caches[1].files)
    for key in caches[0].files:
        np.testing.assert_allclose(caches[1][key], caches[0][key], atol=1e-6,
                                   err_msg=key)
    with open(tmp / "rank0.log") as f:
        grid = f.read()
    assert "re_t2i" in grid and "re_i2t" in grid
    with open(tmp / "rank1.log") as f:
        assert "t2i" not in f.read()
