"""Training CLI (counterpart of the JAX package's ``train_net.py``).

    python -m textreid_torch.train_net --root ROOT --config-file CFG.yaml \
        [--device cuda|cpu] [KEY VALUE ...]

The reference argument surface (``--root``, ``--config-file``, trailing
dotted config overrides) plus ``--device`` (default ``cuda``, which raises
when no card is present).  Python, numpy and torch are seeded from
``cfg.SEED``; the output directory is ``ROOT/output/<config dir>/<config
name>``, as in the JAX package.  ``ROOT/pretrained/clip/ViT-B-16.pt`` (or
the archive of the configured ViT) is loaded into the query and key visual
towers when it is there; otherwise the seeded initialisation is kept and
logged.

Not ported yet (each raises, naming its ROADMAP Queue A item):
``--resume-from`` and a full-model warm start (``MODEL.WEIGHT``) (item 5),
evaluation during training (item 4).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

CLIP_ARCHIVES = {"clip_vit_b32": "ViT-B-32", "clip_vit_b16": "ViT-B-16",
                 "clip_vit_l14": "ViT-L-14"}


def load_clip_state_dict(path: str) -> dict:
    """A CLIP archive (TorchScript, as OpenAI ships them) or a plain
    state dict saved with ``torch.save``."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrained_visual(cfg, model, logger) -> None:
    """CLIP ViT weights into ``model.visual_model`` when the archive is
    under ``ROOT/pretrained/clip``."""
    name = cfg.MODEL.VISUAL_MODEL
    if not name.startswith("clip_vit"):
        return
    path = os.path.join(cfg.ROOT, "pretrained", "clip",
                        f"{CLIP_ARCHIVES.get(name, 'ViT-B-16')}.pt")
    if not os.path.isfile(path):
        logger.info("No CLIP archive at %s: the visual tower keeps its "
                    "seeded initialisation (SEED %d)", path, cfg.SEED)
        return
    from .utils.weight_convert import convert_clip_vit

    logger.info("Loading CLIP ViT weights from %s", path)
    visual = model.visual_model
    sd = convert_clip_vit(load_clip_state_dict(path), visual.layers,
                          final_grid=visual.grid, prefix="")
    missing, unexpected = visual.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    if missing or unexpected:
        raise KeyError(f"{path} does not match the visual tower: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")


def train(cfg, output_dir: str, device):
    """Build the model, optimizer and MoCo state, and train.  Returns
    ``(state, meters)``."""
    import logging

    from .data import make_data_loader
    from .engine import create_train_state, make_train_step
    from .engine.trainer import do_train
    from .models import build_model
    from .solver import make_lr_schedule, make_optimizer
    from .solver.build import apply_freeze
    from .utils.platform import compute_dtype

    logger = logging.getLogger("PersonSearch.train")
    if cfg.SOLVER.EVALUATE_PERIOD > 0:
        raise NotImplementedError(
            "evaluation during training (SOLVER.EVALUATE_PERIOD > 0) is not "
            "ported yet (ROADMAP Queue A item 4); pass "
            "SOLVER.EVALUATE_PERIOD 0")
    if cfg.MODEL.WEIGHT != "imagenet":
        raise NotImplementedError(
            "a full-model warm start (MODEL.WEIGHT) is not ported yet "
            "(ROADMAP Queue A item 5)")
    train_step = make_train_step(cfg)
    model = build_model(cfg, device, torch.float32,
                        compute_dtype(cfg, device), train=True)
    load_pretrained_visual(cfg, model, logger)
    if cfg.MODEL.FREEZE:
        apply_freeze(model)
        logger.info("MODEL.FREEZE: the text tower is frozen")
    optimizer = make_optimizer(cfg, model)
    state = create_train_state(cfg, model, optimizer,
                               cfg.SOLVER.IMS_PER_BATCH)
    data_loader = make_data_loader(cfg, is_train=True)
    arguments = {"iteration": 0, "epoch": 0,
                 "max_epoch": cfg.SOLVER.NUM_EPOCHS}
    meters = do_train(cfg, state, train_step, data_loader,
                      make_lr_schedule(cfg), output_dir, arguments, device)
    return state, meters


def main(argv=None):
    parser = argparse.ArgumentParser(description="textreid_torch training")
    parser.add_argument("--root", default="./", type=str, help="root path")
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--resume-from", type=str,
                        help="checkpoint to resume from (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted config overrides: KEY VALUE ...")
    args = parser.parse_args(argv)
    if args.resume_from:
        raise NotImplementedError(
            "--resume-from is not ported yet (ROADMAP Queue A item 5)")

    from .config import get_default_cfg
    from .utils.logger import setup_logger
    from .utils.platform import require_cuda

    device = require_cuda(args.device)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    cfg.freeze()

    random.seed(cfg.SEED)
    np.random.seed(cfg.SEED)
    torch.manual_seed(cfg.SEED)

    output_dir = os.path.join(
        args.root, "output", "/".join(args.config_file.split("/")[-2:])[:-5])
    os.makedirs(output_dir, exist_ok=True)
    logger = setup_logger("PersonSearch", output_dir)
    logger.info("Using %s", device)
    logger.info("%s", args)
    logger.info("Running with config:\n%s", cfg)
    return train(cfg, output_dir, device)


if __name__ == "__main__":
    main()
