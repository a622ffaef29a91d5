"""Training state (counterpart of ``textreid_tpu/engine/state.py``).

The JAX package threads one immutable pytree through its jitted step; here
the same pieces are live objects the step updates in place:

* ``model`` — the query model (f32 master parameters) and ``optimizer``;
* ``key_model`` — the MoCo key encoders: a deep copy of the query model
  with ``requires_grad`` off, moved by the EMA over ``parameters()`` only
  (the frozen token table is a buffer, as it is a constant in JAX, and is
  never averaged);
* ``v_queue`` / ``t_queue`` ``[K, D]`` f32, ``id_queue [K]`` (init -1) and
  ``queue_ptr`` (a host int: the enqueue advances it by the batch size);
* ``sharding`` — set by ``parallel/mesh.py:shard_state`` when the rank
  holds parts of the leaves (a model axis, ZeRO-1): :meth:`state_dict`
  then gathers the single-process layout (a collective: every rank calls
  it) and :meth:`load_state_dict` takes the rank's parts of one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.losses import l2_normalize


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    key_model: Optional[torch.nn.Module] = None
    v_queue: Optional[torch.Tensor] = None
    t_queue: Optional[torch.Tensor] = None
    id_queue: Optional[torch.Tensor] = None
    queue_ptr: int = 0
    sharding: Optional[object] = None

    def load(self, pieces: dict) -> None:
        """Install ``utils.weight_convert.train_state_from_jax`` output:
        the model's weights (frozen token table included) and, for MoCo,
        the key model's, the queues and the pointer."""
        models = [(self.model, pieces["model"])]
        if self.key_model is not None:
            models.append((self.key_model, pieces["key_model"]))
        for model, sd in models:
            model.load_state_dict(
                {k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                strict=True)
        if self.key_model is None:
            return
        device = self.v_queue.device
        self.v_queue = torch.tensor(np.array(pieces["v_queue"]),
                                    dtype=torch.float32, device=device)
        self.t_queue = torch.tensor(np.array(pieces["t_queue"]),
                                    dtype=torch.float32, device=device)
        self.id_queue = torch.tensor(np.array(pieces["id_queue"]),
                                     dtype=torch.long, device=device)
        self.queue_ptr = int(pieces["queue_ptr"])

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, as a snapshot: every tensor
        (the optimizer's too) copied to the CPU, so that later in-place
        updates of the live state do not reach it.  Sharded, the
        single-process layout, gathered over the mesh."""
        if self.sharding is not None:
            return self.sharding.gather(self)
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.key_model is not None:
            out.update(key_model=self.key_model.state_dict(),
                       v_queue=self.v_queue, t_queue=self.t_queue,
                       id_queue=self.id_queue, queue_ptr=self.queue_ptr)
        return _cpu_copy(out)

    def load_state_dict(self, sd: dict) -> None:
        """Restore what :meth:`state_dict` gave, in place: both models, the
        optimizer, ``step``, the queues and the pointer (sharded: this
        rank's parts of them)."""
        if self.sharding is not None:
            sd = self.sharding.split(self, sd)
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        if self.key_model is not None:
            self.key_model.load_state_dict(sd["key_model"])
            for name in ("v_queue", "t_queue", "id_queue"):
                getattr(self, name).copy_(sd[name])
            self.queue_ptr = int(sd["queue_ptr"])


def _cpu_copy(obj):
    """``obj`` with every tensor in it copied to the CPU (a copy even of a
    CPU tensor)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


def create_train_state(cfg, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       batch_size: int) -> TrainState:
    """Wrap the query model and optimizer; for the MoCo head also the key
    model and the queues (L2-normalised uniform noise drawn from a
    ``torch.Generator`` seeded with ``cfg.SEED``, on the CPU so every
    device starts from the same queues).  ``K % batch_size != 0`` raises,
    as the reference's enqueue assert does."""
    state = TrainState(model=model, optimizer=optimizer)
    if cfg.MODEL.EMBEDDING.EMBED_HEAD != "moco":
        return state
    k = cfg.MODEL.MOCO.K
    dim = cfg.MODEL.EMBEDDING.FEATURE_SIZE
    if k % batch_size != 0:
        raise ValueError(
            f"MoCo queue size K={k} must be divisible by the global batch "
            f"size {batch_size} (reference head.py:103)")
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(cfg.SEED + 1)
    state.v_queue = l2_normalize(torch.rand(k, dim, generator=gen)).to(device)
    state.t_queue = l2_normalize(torch.rand(k, dim, generator=gen)).to(device)
    state.id_queue = torch.full((k,), -1, dtype=torch.long, device=device)
    state.key_model = copy.deepcopy(model).requires_grad_(False)
    return state
