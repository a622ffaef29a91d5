"""Model and state bootstrap (counterpart of ``textreid_tpu/utils/
bootstrap.py``): config + checkpoint -> a serving model on a device, a
seeded training state, and a checkpoint of this package or a reference
``.pth`` installed into a training state (``MODEL.WEIGHT``,
``tools/export_torch.py``)."""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models import build_model
from .checkpoint import refuse_directory
from .platform import require_cuda
from .weight_convert import load_reference_state_dict

# reference key-encoder entries -> the key model's names (the port's key
# model is a copy of the whole query model, as the JAX package's
# ``key_params`` are)
_KEY_ENCODER_NAMES = (("embed_model.v_encoder_k.", "visual_model."),
                      ("embed_model.t_encoder_k.", "textual_model."),
                      ("embed_model.v_fc_k.", "embed_model.v_fc_q."),
                      ("embed_model.t_fc_k.", "embed_model.t_fc_q."))


def read_reference_checkpoint(path: str) -> dict:
    """The state dict of a reference-layout ``.pth`` (``{"model":
    state_dict}``, as the reference and this package's checkpoints have
    it, or a bare state dict), with a DataParallel ``module.`` prefix
    removed."""
    refuse_directory(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {re.sub(r"^module\.", "", k): v
            for k, v in obj.get("model", obj).items()}


def build_eval_model(cfg, checkpoint_file: str = "", device="cuda",
                     dtype=torch.float32):
    """Seeded model for ``cfg`` on ``device`` in ``dtype``, with the
    reference-layout ``.pth`` at ``checkpoint_file`` loaded when given (see
    :func:`read_reference_checkpoint`), in eval mode.  Raises when CUDA is
    asked for and absent."""
    device = require_cuda(device)
    model = build_model(cfg, device, dtype)
    if checkpoint_file:
        load_reference_state_dict(model,
                                  read_reference_checkpoint(checkpoint_file))
    return model


def build_train_state(cfg, device="cuda"):
    """Seeded f32 training state for ``cfg`` on ``device``: the model, its
    optimizer and, for the MoCo head, the key model and the queues
    (``engine/state.py:create_train_state`` at ``SOLVER.IMS_PER_BATCH``).
    Raises when CUDA is asked for and absent."""
    from ..engine.state import create_train_state
    from ..solver import make_optimizer

    device = require_cuda(device)
    model = build_model(cfg, device, torch.float32)
    return create_train_state(cfg, model, make_optimizer(cfg, model),
                              cfg.SOLVER.IMS_PER_BATCH)


def is_port_checkpoint(payload: dict) -> bool:
    """Whether a ``.pth``'s payload is a checkpoint of this package
    (``utils/checkpoint.py:Checkpointer``: ``step`` and ``meta`` beside the
    state) rather than a reference-layout ``{"model": ...}``."""
    return "step" in payload and "meta" in payload


def install_checkpoint(state, path: str) -> str:
    """Install ``path`` into a training state, in place: a checkpoint of
    this package restored whole (``TrainState.load_state_dict``, strict), or
    a reference-layout ``.pth`` through :func:`install_reference_checkpoint`.
    Returns which it was: ``"port"`` or ``"reference"``."""
    refuse_directory(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if is_port_checkpoint(payload):
        state.load_state_dict(payload)
        return "port"
    install_reference_checkpoint(state, {
        re.sub(r"^module\.", "", k): v
        for k, v in payload.get("model", payload).items()})
    return "reference"


def install_reference_checkpoint(state, sd: dict) -> None:
    """Install a reference-layout state dict into a training state, in
    place (the JAX package's ``install_torch_checkpoint``): the query model
    and, where both the state and ``sd`` have them, the MoCo key encoders
    (``embed_model.{v,t}_encoder_k.*``, ``{v,t}_fc_k.*``), the queues (the
    reference's ``[D, K]``, transposed to ``[K, D]``), ``id_queue`` and
    ``queue_ptr``.  The key model's other entries (its copies of the embed
    layers and the loss projection, which the key forward never reads)
    keep their values.  A queue whose shape does not match raises, naming
    it, before anything is installed."""
    queues = {}
    if state.key_model is not None and "embed_model.v_queue" in sd:
        for name, tr in (("v_queue", True), ("t_queue", True),
                         ("id_queue", False)):
            got = torch.as_tensor(np.asarray(sd[f"embed_model.{name}"]))
            got = got.T if tr else got.reshape(-1)
            want = getattr(state, name)
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"MoCo buffer shape mismatch at {name}: checkpoint "
                    f"{tuple(got.shape)} vs model {tuple(want.shape)}: the "
                    "checkpoint's MOCO.K or FEATURE_SIZE does not match the "
                    "configured model")
            queues[name] = got
    load_reference_state_dict(state.model, sd)
    if not queues:
        return
    key_sd = {}
    for key, value in sd.items():
        for ref, ours in _KEY_ENCODER_NAMES:
            if key.startswith(ref):
                key_sd[ours + key[len(ref):]] = torch.as_tensor(
                    np.asarray(value))
    expected = state.key_model.state_dict()
    towers = {k for k in expected if k.startswith(
        ("visual_model.", "textual_model."))
        and not k.endswith("frozen_token_table")}
    missing = sorted(towers - set(key_sd))
    unexpected = sorted(set(key_sd) - set(expected))
    if missing or unexpected:
        raise KeyError(f"the checkpoint's key encoders do not match the key "
                       f"model: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    state.key_model.load_state_dict(key_sd, strict=False)
    for name, value in queues.items():
        getattr(state, name).copy_(value)
    state.queue_ptr = int(np.asarray(sd["embed_model.queue_ptr"]).reshape(()))
