"""Training state (counterpart of ``textreid_tpu/engine/state.py``).

The JAX package threads one immutable pytree through its jitted step; here
the same pieces are live objects the step updates in place:

* ``model`` — the query model (f32 master parameters) and ``optimizer``;
* ``key_model`` — the MoCo key encoders: a deep copy of the query model
  with ``requires_grad`` off, moved by the EMA over ``parameters()`` only
  (the frozen token table is a buffer, as it is a constant in JAX, and is
  never averaged);
* ``v_queue`` / ``t_queue`` ``[K, D]`` f32, ``id_queue [K]`` (init -1) and
  ``queue_ptr`` (a host int: the enqueue advances it by the batch size).
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

    def load(self, pieces: dict) -> None:
        """Install ``utils.weight_convert.train_state_from_jax`` output:
        both models' weights (frozen token table included), the queues and
        the pointer."""
        device = self.v_queue.device
        for model, sd in ((self.model, pieces["model"]),
                          (self.key_model, pieces["key_model"])):
            model.load_state_dict(
                {k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                strict=True)
        self.v_queue = torch.tensor(np.array(pieces["v_queue"]),
                                    dtype=torch.float32, device=device)
        self.t_queue = torch.tensor(np.array(pieces["t_queue"]),
                                    dtype=torch.float32, device=device)
        self.id_queue = torch.tensor(np.array(pieces["id_queue"]),
                                     dtype=torch.long, device=device)
        self.queue_ptr = int(pieces["queue_ptr"])

    def state_dict(self) -> dict:
        """Everything a checkpoint holds (CPU tensors)."""
        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}

        out = {"model": cpu(self.model.state_dict()),
               "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.key_model is not None:
            out.update(key_model=cpu(self.key_model.state_dict()),
                       v_queue=self.v_queue.cpu(), t_queue=self.t_queue.cpu(),
                       id_queue=self.id_queue.cpu(),
                       queue_ptr=self.queue_ptr)
        return out


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
