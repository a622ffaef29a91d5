"""Training CLI (counterpart of the JAX package's ``train_net.py``).

    python -m textreid_torch.train_net --root ROOT --config-file CFG.yaml \
        [--resume-from PATH|auto] [--use-tensorboard] [--device cuda|cpu] \
        [KEY VALUE ...]

The reference argument surface (``--root``, ``--config-file``,
``--resume-from``, ``--use-tensorboard``, trailing dotted config overrides)
plus ``--device`` (default ``cuda``, which raises when no card is
present).  Python, numpy and torch are seeded from ``cfg.SEED``; the output
directory is ``ROOT/output/<config dir>/<config name>``, as in the JAX
package.  In order:

1. The model, in train mode.  The CLIP archive of its visual tower, when it
   is under ``ROOT/pretrained/clip`` (``RN50.pt`` or ``RN101.pt`` for the
   ModifiedResNets, ``ViT-B-16.pt`` etc. for the ViTs), is loaded into it,
   BatchNorm running statistics included; otherwise the seeded
   initialisation is kept and logged.  A CLIP text transformer takes the
   text half of the same archive, its positional table resampled to
   ``CONTEXT_LENGTH``; when the visual tower has no CLIP archive there
   (a torchvision ResNet, or the file is absent), the first of
   ``ViT-B-16.pt``, ``ViT-B-32.pt``, ``RN50.pt``, ``RN101.pt``,
   ``ViT-L-14.pt`` found, the JAX ``train_net.py``'s order.  Then the
   optimizer and the MoCo state, whose key model is a copy of the query
   model, so both towers start from the archive.
2. ``MODEL.WEIGHT`` (other than ``imagenet``): a reference-layout ``.pth``
   installed as a warm start (``utils/bootstrap.py:
   install_reference_checkpoint``: the model, the key encoders, the queues
   and the pointer).
3. ``--resume-from``: a checkpoint of this package (``epoch_N.pth``,
   ``best.pth``, ``preempt.pth``) restored whole; ``auto`` takes the newest
   ``epoch_N.pth`` of the output directory, or ``preempt.pth`` when it is
   newer (``utils/checkpoint.py:auto_resume_path``).  The epoch budget is
   this run's ``SOLVER.NUM_EPOCHS``.
4. ``engine/trainer.py:do_train``: evaluation on the first of
   ``DATASETS.TEST`` every ``SOLVER.EVALUATE_PERIOD`` epochs with a
   ``best.pth`` on t2i R@1, ``epoch_N.pth`` every ``CHECKPOINT_PERIOD``
   epochs pruned to ``CHECKPOINT_KEEP``, and a ``preempt.pth`` on SIGTERM
   (``TPU.PREEMPT_SAVE``); writes in the background with
   ``TPU.ASYNC_CHECKPOINT``.

An orbax directory of the JAX package is not read, as ``MODEL.WEIGHT`` or
``--resume-from``: export it with ``tools/export_torch.py``.

The mesh (``parallel/mesh.py``): under ``torchrun --nproc-per-node N -m
textreid_torch.train_net ...`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, ``GROUP_RANK`` in the environment; or
another store with ``--init-method``) each process trains on
``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``) on the ``(slice,
data, model)`` mesh of ``TPU.NUM_SLICES``, ``TPU.DATA_PARALLEL`` (0: every
rank left) and ``TPU.MODEL_PARALLEL``, and the step is the one-process
step on the global batch ``SOLVER.IMS_PER_BATCH``, sharded over the data
axes.  ``TPU.MODEL_PARALLEL > 1`` splits every transformer FFN over the
model axis, ``TPU.OPTIMIZER_SHARDING`` shards the optimizer's moments
over the data axis (ZeRO-1), ``TPU.NUM_SLICES > 1`` groups the ranks by
node.  With ``TPU.PROCESS_SHARD_DATA`` each process decodes only its data
shard's rows of every global batch.  After the loads above, rank 0's state
is broadcast and each rank keeps its shard (``shard_state``).  Rank 0
logs, writes the checkpoints (in the single-process layout) and the
tensorboard files.  All ranks meet at an exit barrier before the group
ends.  Without that environment: one process on one card
(``TPU.OPTIMIZER_SHARDING`` has nothing to shard there; a model axis or
several slices raise).
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch

CLIP_VIT_ARCHIVES = {"clip_vit_b32": "ViT-B-32", "clip_vit_b16": "ViT-B-16",
                     "clip_vit_l14": "ViT-L-14"}


def load_clip_state_dict(path: str) -> dict:
    """A CLIP archive (TorchScript, as OpenAI ships them) or a plain
    state dict saved with ``torch.save``."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=True)


def clip_archive(cfg):
    """``ROOT/pretrained/clip/<archive>.pt`` of the visual tower (the JAX
    ``train_net.py``'s names), or ``None`` for a tower CLIP has none of."""
    name = cfg.MODEL.VISUAL_MODEL
    if name.startswith("m_resnet"):
        arch = "RN101" if name.endswith("101") else "RN50"
    elif name.startswith("clip_vit"):
        arch = CLIP_VIT_ARCHIVES.get(name, "ViT-B-16")
    else:
        return None
    return os.path.join(cfg.ROOT, "pretrained", "clip", f"{arch}.pt")


# any CLIP archive holds a text tower: the JAX train_net.py's search order
# when the visual tower's own archive is not there
CLIP_TEXT_ARCHIVES = ("ViT-B-16.pt", "ViT-B-32.pt", "RN50.pt", "RN101.pt",
                      "ViT-L-14.pt")


def _load_into(module, sd: dict, path: str, what: str) -> None:
    """``sd`` into ``module``; a key the module does not have, or lacks
    (``num_batches_tracked`` aside), raises."""
    missing, unexpected = module.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path} does not match the {what}: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")


def load_pretrained(cfg, model, logger) -> None:
    """The CLIP archive's visual tower into ``model.visual_model`` when the
    archive is under ``ROOT/pretrained/clip``, and the text half of a CLIP
    archive into a text transformer (see the module's docstring).  The
    archive is read once."""
    from .models.model import TEXT_TRANSFORMERS
    from .models.vit import VisionTransformer
    from .utils.weight_convert import (
        convert_clip_m_resnet,
        convert_clip_text,
        convert_clip_vit,
    )

    path, sd = clip_archive(cfg), None
    if path is not None and not os.path.isfile(path):
        logger.info("No CLIP archive at %s: the visual tower keeps its "
                    "seeded initialisation (SEED %d)", path, cfg.SEED)
        path = None
    if path is not None:
        logger.info("Loading CLIP visual weights from %s", path)
        sd = load_clip_state_dict(path)
        visual = model.visual_model
        if isinstance(visual, VisionTransformer):
            tower = convert_clip_vit(sd, visual.layers,
                                     final_grid=visual.grid, prefix="")
        else:
            tower = convert_clip_m_resnet(sd, visual.attnpool.spacial_dim)
        _load_into(visual, tower, path, "visual tower")
    if cfg.MODEL.TEXTUAL_MODEL not in TEXT_TRANSFORMERS:
        return
    if path is None:
        clip_dir = os.path.join(cfg.ROOT, "pretrained", "clip")
        path = next((os.path.join(clip_dir, name)
                     for name in CLIP_TEXT_ARCHIVES
                     if os.path.isfile(os.path.join(clip_dir, name))), None)
    if path is None:
        logger.info("No CLIP archive under ROOT/pretrained/clip: the text "
                    "tower keeps its seeded initialisation (SEED %d)",
                    cfg.SEED)
        return
    logger.info("Loading CLIP text weights from %s", path)
    if sd is None:
        sd = load_clip_state_dict(path)
    text = model.textual_model
    _load_into(text, convert_clip_text(sd, text.layers, text.context_length,
                                       prefix=""), path, "text tower")


def train(cfg, output_dir: str, device, resume_from: str = "",
          use_tensorboard: bool = False):
    """Build the model, optimizer and MoCo state, warm-start or resume it,
    and train.  Returns ``(state, meters)``."""
    from .data import make_data_loader
    from .engine import create_train_state, make_train_step
    from .engine.trainer import do_train
    from .models import build_model
    from .solver import make_lr_schedule, make_optimizer
    from .solver.build import apply_freeze
    from .utils.bootstrap import (
        install_reference_checkpoint,
        read_reference_checkpoint,
    )
    from .utils.checkpoint import Checkpointer, auto_resume_path
    from .parallel.mesh import (
        data_rank,
        data_size,
        make_mesh,
        rank,
        shard_state,
        world_size,
    )
    from .utils.meters import MetricLogger, TensorboardLogger
    from .utils.platform import compute_dtype

    logger = logging.getLogger("PersonSearch.train")
    process_shard, mesh = None, None
    if world_size() > 1:
        mesh = make_mesh(cfg.TPU.DATA_PARALLEL, cfg.TPU.MODEL_PARALLEL,
                         num_slices=cfg.TPU.NUM_SLICES)
        logger.info("Data parallel over %d ranks: %d of the %d rows of a "
                    "batch each (mesh %s%s)", world_size(),
                    cfg.SOLVER.IMS_PER_BATCH // data_size(),
                    cfg.SOLVER.IMS_PER_BATCH, mesh.shape,
                    ", ZeRO-1" if cfg.TPU.OPTIMIZER_SHARDING else "")
        if cfg.TPU.PROCESS_SHARD_DATA:
            process_shard = (data_rank(), data_size())
    elif cfg.TPU.MODEL_PARALLEL > 1 or cfg.TPU.NUM_SLICES > 1:
        raise ValueError(
            f"TPU.MODEL_PARALLEL={cfg.TPU.MODEL_PARALLEL}, "
            f"TPU.NUM_SLICES={cfg.TPU.NUM_SLICES}: a mesh of several ranks "
            "needs a process group (torchrun --nproc-per-node N)")
    train_step = make_train_step(cfg)
    model = build_model(cfg, device, torch.float32,
                        compute_dtype(cfg, device), train=True)
    load_pretrained(cfg, model, logger)
    if cfg.MODEL.FREEZE:
        apply_freeze(model)
        logger.info("MODEL.FREEZE: the text tower is frozen")
    optimizer = make_optimizer(cfg, model)
    state = create_train_state(cfg, model, optimizer,
                               cfg.SOLVER.IMS_PER_BATCH)
    data_loader = make_data_loader(cfg, is_train=True,
                                   process_shard=process_shard)
    data_loader_val = (make_data_loader(cfg, is_train=False)
                       if cfg.SOLVER.EVALUATE_PERIOD > 0 else [])
    arguments = {"iteration": 0, "epoch": 0,
                 "max_epoch": cfg.SOLVER.NUM_EPOCHS}
    checkpointer = Checkpointer(output_dir,
                                async_save=bool(cfg.TPU.ASYNC_CHECKPOINT))

    if cfg.MODEL.WEIGHT != "imagenet":
        if not os.path.exists(cfg.MODEL.WEIGHT):
            raise IOError(f"{cfg.MODEL.WEIGHT} is not a checkpoint file")
        logger.info("Warm start from %s", cfg.MODEL.WEIGHT)
        install_reference_checkpoint(
            state, read_reference_checkpoint(cfg.MODEL.WEIGHT))
    if resume_from == "auto":
        resume_from = auto_resume_path(output_dir)
        if resume_from:
            logger.info("Auto-resuming from %s", resume_from)
        else:
            logger.info("No prior checkpoint found; starting fresh")
    if resume_from:
        state, meta = checkpointer.resume(resume_from, state)
        arguments.update(meta)
        # progress comes from the checkpoint, the budget from this run
        arguments["max_epoch"] = cfg.SOLVER.NUM_EPOCHS
    if mesh is not None:
        shard_state(state, mesh,
                    optimizer_sharding=bool(cfg.TPU.OPTIMIZER_SHARDING))

    if use_tensorboard and rank() == 0:
        meters = TensorboardLogger(os.path.join(output_dir, "tensorboard"),
                                   start_iter=arguments["iteration"])
    else:
        meters = MetricLogger()
    try:
        do_train(cfg, state, train_step, data_loader, data_loader_val,
                 checkpointer, meters, make_lr_schedule(cfg), arguments,
                 device)
    finally:
        if isinstance(meters, TensorboardLogger):
            meters.close()
    return state, meters


def main(argv=None):
    parser = argparse.ArgumentParser(description="textreid_torch training")
    parser.add_argument("--root", default="./", type=str, help="root path")
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--resume-from", type=str,
                        help="checkpoint to resume from, or 'auto' (the "
                             "newest epoch_N.pth, or a newer preempt.pth, "
                             "of the output directory)")
    parser.add_argument("--use-tensorboard", action="store_true",
                        default=False,
                        help="also write the meters with tensorboardX "
                             "(when it is installed) under "
                             "OUTPUT/tensorboard")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    add_distributed_arguments(parser)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted config overrides: KEY VALUE ...")
    args = parser.parse_args(argv)

    from .config import get_default_cfg
    from .parallel.mesh import destroy_process_group, rank
    from .utils.logger import setup_logger
    from .utils.platform import require_cuda

    device = join_process_group(require_cuda(args.device), args)
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
    logger = setup_logger("PersonSearch", output_dir, rank())
    logger.info("Using %s", device)
    logger.info("%s", args)
    logger.info("Running with config:\n%s", cfg)
    result = train(cfg, output_dir, device, args.resume_from or "",
                   args.use_tensorboard)
    destroy_process_group()
    return result


def add_distributed_arguments(parser) -> None:
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed init method of the process "
                             "group (default env://: MASTER_ADDR and "
                             "MASTER_PORT); used when RANK and WORLD_SIZE "
                             "are in the environment, as torchrun sets them")
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend of that group: nccl "
                             "for cuda, gloo for cpu when not given (gloo "
                             "takes CUDA tensors too: several ranks on one "
                             "card, which NCCL refuses)")


def join_process_group(device, args):
    """This rank's device in the process group the environment names
    (``parallel/mesh.py:init_process_group``), or ``device`` when there is
    none."""
    from .parallel.mesh import init_process_group, launched_distributed

    if not launched_distributed():
        return device
    return init_process_group(device, args.init_method, args.backend)


if __name__ == "__main__":
    main()
