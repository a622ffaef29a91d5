"""Optimizer and learning-rate schedule (counterpart of
``textreid_tpu/solver/build.py``).

* Parameter groups: a parameter whose name contains "bias" trains at
  ``lr * BIAS_LR_FACTOR`` with ``WEIGHT_DECAY_BIAS``, every other one at
  ``lr`` with ``WEIGHT_DECAY``; parameters of the visual tower also take
  ``VISUAL_LR_FACTOR``.  Each group keeps its factor in ``"lr_factor"``.
* ``Adam`` is ``torch.optim.Adam`` with coupled L2 (``weight_decay`` is
  added to the gradient before the moments, as optax's
  ``add_decayed_weights`` ahead of ``scale_by_adam``), eps 1e-8 and betas
  (``ADAM_ALPHA``, ``ADAM_BETA``).  ``AdamW`` is ``torch.optim.AdamW``:
  the decay decoupled, ``p -= lr (adam + wd p)`` with the group's lr, as
  the JAX chain's ``add_decayed_weights`` after ``scale_by_adam`` and
  before the lr scale.  ``SGD`` is ``torch.optim.SGD`` with coupled L2,
  heavy-ball ``SGD_MOMENTUM`` (no dampening, no Nesterov: optax's
  ``trace``).  Every shipped config trains with Adam.
* ``MODEL.FREEZE`` stops the text tower (and a ResNet's stem and layers
  1-3, CLIP's or torchvision's) with ``requires_grad=False``, the rules of
  ``freeze_mask``.
* The warmup + {step, exp, poly, cosine, linear} schedule is a function of
  the 0-based epoch, on the host.
* ``TPU.OPTIMIZER_SHARDING`` (ZeRO-1, ``parallel/mesh.py:shard_state``):
  :class:`Zero1Optimizer` keeps each data rank's part of the moments.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Dict

import torch

from ..parallel.mesh import Axis, all_gather_along, shard_of

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
    """``MODEL.FREEZE``: the text tower, and a ResNet's stem and layers
    1-3, stop training (``freeze_mask``'s rules; the ViT has none of those
    names in the JAX package, so none of its parameters freeze)."""
    from ..models.m_resnet import ModifiedResNet
    from ..models.resnet import ResNet

    resnet = isinstance(model.visual_model, (ModifiedResNet, ResNet))
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
    name = cfg.SOLVER.OPTIMIZER
    groups, lr = param_groups(cfg, model), cfg.SOLVER.BASE_LR
    if name in ("Adam", "AdamW"):
        adam = torch.optim.Adam if name == "Adam" else torch.optim.AdamW
        return adam(groups, lr=lr, eps=1e-8,
                    betas=(cfg.SOLVER.ADAM_ALPHA, cfg.SOLVER.ADAM_BETA))
    if name == "SGD":
        return torch.optim.SGD(groups, lr=lr,
                               momentum=cfg.SOLVER.SGD_MOMENTUM)
    raise NotImplementedError(name)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group trains at ``lr`` times its factor."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]


class Zero1Optimizer:
    """ZeRO-1 over the data axis ``axis`` (JAX's ``zero1_spec`` placement
    of the ``opt_state`` leaves): the optimizer ``make_optimizer`` built,
    with each parameter named in ``dims`` (``id(param) -> dimension``)
    replaced by this rank's part of it along that dimension, so that its
    moments (Adam's, AdamW's, SGD's momentum) exist for that part alone.
    :meth:`step` gives each part its slice of the (already averaged)
    gradient, runs the same ``torch.optim`` class with the same groups on
    them, and all-gathers the parts over the data group into the whole
    parameters, one collective per dtype; a parameter not in ``dims`` is
    updated whole, on every rank.  The arithmetic on each element is the
    replicated optimizer's, so the parameters stay bit-equal to it.  Not
    ``ZeroRedundancyOptimizer``, which gives whole tensors to ranks.

    ``param_groups`` and ``state`` are the inner optimizer's (the learning
    rate is set on them); ``params`` are the model's parameters in the
    order its state dict numbers them; ``state_dict`` holds this rank's
    parts (``parallel/mesh.py:StateSharding`` gathers them)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 dims: Dict[int, int], axis: Axis):
        self.axis = axis
        self.params, self._parts = [], []
        groups = []
        for group in optimizer.param_groups:
            members = []
            for p in group["params"]:
                d = dims.get(id(p))
                part = None if d is None else shard_of(
                    p.detach(), d, axis).clone()
                self.params.append(p)
                self._parts.append((part, d))
                members.append(p if part is None else part)
            groups.append({**group, "params": members})
        self.inner = type(optimizer)(groups, **optimizer.defaults)
        # moments already there (a resume before the sharding): the part
        for p, (part, d) in zip(self.params, self._parts):
            if p not in optimizer.state:
                continue
            self.inner.state[p if part is None else part] = {
                k: shard_of(v, d, axis).clone()
                if part is not None and isinstance(v, torch.Tensor)
                and v.shape == p.shape else v
                for k, v in optimizer.state[p].items()}

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, (part, _) in zip(self.params, self._parts):
            for t in (p, part):
                if t is not None and t.grad is not None:
                    if set_to_none:
                        t.grad = None
                    else:
                        t.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        for p, (part, d) in zip(self.params, self._parts):
            if part is not None:
                part.copy_(shard_of(p, d, self.axis))
                part.grad = None if p.grad is None else shard_of(
                    p.grad, d, self.axis).clone()
        self.inner.step()
        by_dtype: dict = {}
        for p, (part, d) in zip(self.params, self._parts):
            if part is not None and part.grad is not None:
                by_dtype.setdefault((part.dtype, part.device), []).append(
                    (p, part, d))
        for items in by_dtype.values():
            whole = all_gather_along(
                torch.cat([part.reshape(-1) for _, part, _ in items]),
                self.axis)
            start = 0
            for p, part, d in items:
                n = part.numel()
                p.copy_(torch.cat([w[start:start + n].view_as(part)
                                   for w in whole], dim=d))
                start += n

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd)
