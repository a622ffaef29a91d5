"""Eval-time bootstrap (counterpart of ``textreid_tpu/utils/bootstrap.py``):
config + checkpoint -> a serving model on a device."""

from __future__ import annotations

import os

import torch

from ..models import build_model
from .platform import require_cuda
from .weight_convert import load_reference_state_dict


def build_eval_model(cfg, checkpoint_file: str = "", device="cuda",
                     dtype=torch.float32):
    """Seeded model for ``cfg`` on ``device`` in ``dtype``, with the
    reference-layout ``.pth`` at ``checkpoint_file`` loaded when given
    (``{"model": state_dict}``, as the reference and this package's
    ``epoch_N.pth`` have it, or a bare state dict), in eval mode.  Raises when CUDA is
    asked for and absent."""
    device = require_cuda(device)
    model = build_model(cfg, device, dtype)
    if checkpoint_file:
        if os.path.isdir(checkpoint_file):
            raise NotImplementedError(
                f"{checkpoint_file} is a directory (an orbax checkpoint of "
                "the JAX package?): reading one is not ported yet (ROADMAP "
                "Queue A item 5); export it to a reference .pth with "
                "tools/export_torch.py first")
        obj = torch.load(checkpoint_file, map_location="cpu",
                         weights_only=True)
        load_reference_state_dict(model, obj.get("model", obj))
    return model
