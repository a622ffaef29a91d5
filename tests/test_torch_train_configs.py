"""Every yaml under ``configs/`` trains in the port: ``train_net.main``
with ``--device cpu`` takes one step of each, its towers as shipped, at
32x16 pixels, captions of 10 tokens and batch 16 (the accum8 yaml: 8
microbatches of 2).  Nothing raises, the losses are finite, the loss dict
is the head's, and the MoCo queue pointer advanced by the batch.
"""

import glob
import math
import os

import pytest

from textreid_torch import train_net
from textreid_torch.data import make_synthetic_dataset

from test_torch_isolation import person_search_logger  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "*", "*.yaml")))
BATCH = 16
TINY = ["INPUT.HEIGHT", "32", "INPUT.WIDTH", "16", "INPUT.MAX_TEXT_LENGTH",
        "10", "SOLVER.IMS_PER_BATCH", str(BATCH), "DATALOADER.IMS_PER_ID",
        "4", "DATALOADER.NUM_WORKERS", "1", "SOLVER.NUM_EPOCHS", "1",
        "SOLVER.EVALUATE_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0",
        "SOLVER.LOG_PERIOD", "1", "TPU.ALLOW_RANDOM_VOCAB", "True",
        "TPU.DEBUG_NANS", "True"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """One batch of 4 identities x 4 images for each dataset a yaml
    names."""
    root = tmp_path_factory.mktemp("ws")
    for name in ("cuhkpedes", "icfgpedes"):
        make_synthetic_dataset(str(root / "datasets" / name),
                               num_identities=BATCH // 4, images_per_id=4,
                               image_size=(32, 16), vocab_size=50,
                               max_tokens=10, split="train")
    return root


def test_every_shipped_yaml_is_here():
    assert len(YAMLS) == 11


@pytest.mark.parametrize("yaml", YAMLS)
def test_every_shipped_yaml_trains_one_step_on_the_cpu(workspace, yaml):
    argv = ["--root", str(workspace), "--config-file",
            os.path.join(REPO, yaml), "--device", "cpu", *TINY]
    state, meters = train_net.main(argv)
    assert state.step == 1
    loss = list(meters.loss.deque)
    assert len(loss) == 1 and math.isfinite(loss[0]), loss
    moco = "moco" in os.path.basename(yaml)
    names = {"instance_loss", "global_align_loss"} | (
        {"infonce_loss"} if moco else set())
    assert names <= set(meters.meters)
    assert ("infonce_loss" in meters.meters) == moco
    if moco:
        assert state.queue_ptr == BATCH
    else:
        assert state.key_model is None
