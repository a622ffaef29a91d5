"""Optimizer and learning-rate schedule (counterpart of
``textreid_tpu/solver/build.py``).

* Parameter groups: a parameter whose name contains "bias" trains at
  ``lr * BIAS_LR_FACTOR`` with ``WEIGHT_DECAY_BIAS``, every other one at
  ``lr`` with ``WEIGHT_DECAY``; parameters of the visual tower also take
  ``VISUAL_LR_FACTOR``.  Each group keeps its factor in ``"lr_factor"``.
* ``Adam`` is ``torch.optim.Adam`` with coupled L2 (``weight_decay`` is
  added to the gradient before the moments, as optax's
  ``add_decayed_weights`` ahead of ``scale_by_adam``), eps 1e-8 and betas
  (``ADAM_ALPHA``, ``ADAM_BETA``).  Every shipped config trains with
  Adam; ``AdamW`` and ``SGD`` are not ported yet.
* ``MODEL.FREEZE`` stops the text tower (and the ModifiedResNet stem and
  layers 1-3) with ``requires_grad=False``, the rules of ``freeze_mask``.
* The warmup + {step, exp, poly, cosine, linear} schedule is a function of
  the 0-based epoch, on the host.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable

import torch

_FROZEN_VISUAL = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "layer1",
                  "layer2", "layer3")


def make_lr_schedule(cfg) -> Callable[[int], float]:
    """``lr(epoch)`` for the 0-based epoch, as plain floats."""
    base_lr = cfg.SOLVER.BASE_LR
    milestones = sorted(cfg.SOLVER.STEPS)
    gamma = cfg.SOLVER.GAMMA
    mode = cfg.SOLVER.LRSCHEDULER
    warmup_factor = cfg.SOLVER.WARMUP_FACTOR
    warmup_epochs = cfg.SOLVER.WARMUP_EPOCHS
    warmup_method = cfg.SOLVER.WARMUP_METHOD
    total_epochs = cfg.SOLVER.NUM_EPOCHS
    target_lr = cfg.SOLVER.TARGET_LR
    power = cfg.SOLVER.POWER

    if mode not in ("step", "exp", "poly", "cosine", "linear"):
        raise ValueError(f"Unknown LR scheduler mode: {mode}")
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"Unknown warmup method: {warmup_method}")

    def schedule(epoch: int) -> float:
        if epoch < warmup_epochs:
            if warmup_method == "constant":
                factor = warmup_factor
            else:
                alpha = epoch / warmup_epochs
                factor = warmup_factor * (1 - alpha) + alpha
            return base_lr * factor
        if mode == "step":
            return base_lr * gamma ** bisect_right(milestones, epoch)
        ratio = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
        if mode == "exp":
            return base_lr * power**ratio
        if mode == "linear":
            return base_lr * (1 - ratio)
        if mode == "poly":
            return target_lr + (base_lr - target_lr) * power ** (1 - ratio)
        return target_lr + (base_lr - target_lr) * 0.5 * (
            1 + math.cos(math.pi * ratio))

    return schedule


def apply_freeze(model) -> None:
    """``MODEL.FREEZE``: the text tower, and the ModifiedResNet stem and
    layers 1-3, stop training (``freeze_mask``'s rules; the ViT has none
    of those names in the JAX package, so none of its parameters
    freeze)."""
    from ..models.m_resnet import ModifiedResNet

    resnet = isinstance(model.visual_model, ModifiedResNet)
    for name, p in model.named_parameters():
        if name.startswith("textual_model.") or (
                resnet and name.startswith("visual_model.")
                and name.split(".")[1].startswith(_FROZEN_VISUAL)):
            p.requires_grad_(False)


def param_groups(cfg, model) -> list:
    """Trainable parameters grouped by (lr factor, weight decay)."""
    bias_factor = float(cfg.SOLVER.BIAS_LR_FACTOR)
    visual_factor = float(cfg.SOLVER.VISUAL_LR_FACTOR)
    groups: dict = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        bias = "bias" in name
        factor = (bias_factor if bias else 1.0) * (
            visual_factor if name.startswith("visual_model.") else 1.0)
        wd = cfg.SOLVER.WEIGHT_DECAY_BIAS if bias else cfg.SOLVER.WEIGHT_DECAY
        groups.setdefault((factor, wd), []).append(p)
    return [{"params": ps, "lr_factor": f, "weight_decay": wd,
             "lr": cfg.SOLVER.BASE_LR * f} for (f, wd), ps in groups.items()]


def make_optimizer(cfg, model) -> torch.optim.Optimizer:
    """The solver over ``model``'s trainable parameters (call
    :func:`apply_freeze` first when ``MODEL.FREEZE``)."""
    if cfg.SOLVER.OPTIMIZER != "Adam":
        raise NotImplementedError(
            f"SOLVER.OPTIMIZER {cfg.SOLVER.OPTIMIZER!r} is not ported yet "
            "(ROADMAP Queue A item 3)")
    return torch.optim.Adam(
        param_groups(cfg, model), lr=cfg.SOLVER.BASE_LR, eps=1e-8,
        betas=(cfg.SOLVER.ADAM_ALPHA, cfg.SOLVER.ADAM_BETA))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group trains at ``lr`` times its factor."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]
