"""The MoCo train step (counterpart of ``textreid_tpu/engine/steps.py``).

Order is the JAX step's (``moco_train_step``), which is the reference's:

1. EMA of the key encoders from the *pre-update* query parameters;
2. key forward under ``no_grad`` with the updated key encoders; with
   ``MOCO.FC`` off the keys go through the *query* embed layers;
3. query forward and backward, the loss tail in f32 with same-identity
   queue negatives masked by an additive ``-inf``;
4. the optimizer step;
5. enqueue of the keys after the loss.

Mixed precision: parameters and the optimizer's moments are f32.  The
towers, embed layers and projectors run in the model's ``compute_dtype``
(bf16 on the card, ``cfg.DTYPE`` on the CPU) by casting each parameter on
use (``models/common.py``), the port's counterpart of ``flax``'s
``dtype=``; gradients flow back through the casts to the f32 masters.  No
autocast: the kernels K1, K5 and K6 get contiguous tensors of the one
dtype they check.  Unlike the JAX package, whose bi-GRU is built without a
dtype and so runs in f32, the port's text tower runs in the compute dtype
too.  Embeddings are cast to f32 before the losses, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import losses
from .state import TrainState

# InfoNCE temperature (reference moco_head/loss.py:18)
MOCO_TEMPERATURE = 0.07


def enqueue(state: TrainState, v_k: torch.Tensor, t_k: torch.Tensor,
            ids: torch.Tensor) -> None:
    """Write the batch's keys at ``queue_ptr`` and advance it (in place;
    ``K % batch == 0`` keeps every write inside the queue)."""
    ptr, n = state.queue_ptr, ids.shape[0]
    state.v_queue[ptr:ptr + n] = v_k
    state.t_queue[ptr:ptr + n] = t_k
    state.id_queue[ptr:ptr + n] = ids
    state.queue_ptr = (ptr + n) % state.id_queue.shape[0]


def moco_loss_tail(projection, v_embed, t_embed, v_q, t_q, v_k, t_k, ids,
                   id_queue, v_queue, t_queue, epsilon: float,
                   temperature: float) -> Dict[str, torch.Tensor]:
    """The MoCo losses on f32 embeddings.  A queue slot whose id matches
    any id of the batch is masked out of every row's negatives."""
    queue_is_pos = (id_queue[None, :] == ids[:, None]).any(dim=0)  # [K]
    neg_mask = torch.where(queue_is_pos, float("-inf"), 0.0)[None, :]
    v_pos = (v_q * t_k).sum(dim=1, keepdim=True)
    v_neg = v_q @ t_queue.T + neg_mask
    t_pos = (t_q * v_k).sum(dim=1, keepdim=True)
    t_neg = t_q @ v_queue.T + neg_mask
    return {
        "instance_loss": losses.instance_loss(
            projection, v_embed, t_embed, ids, epsilon=epsilon),
        "infonce_loss": losses.infonce_loss(v_pos, v_neg, t_pos, t_neg,
                                            temperature),
        "global_align_loss": losses.global_align_loss(v_embed, t_embed, ids),
    }


@torch.no_grad()
def moco_key_forward(model, key_model, use_fc: bool, batch):
    """L2-normalised f32 key embeddings ``(v_k, t_k)``."""
    v_feat = key_model.encode_image(batch["pixels"], batch.get("erase"))
    t_feat = key_model.encode_text(batch["token_ids"], batch["lengths"])
    if use_fc:
        v_k, t_k = key_model.project_image(v_feat), key_model.project_text(
            t_feat)
    else:
        v_k, t_k = model.embed_image(v_feat), model.embed_text(t_feat)
    return (losses.l2_normalize(v_k.float(), dim=1),
            losses.l2_normalize(t_k.float(), dim=1))


def moco_losses(model, state: TrainState, use_fc: bool, epsilon: float,
                batch, v_k, t_k) -> Dict[str, torch.Tensor]:
    """The query forward and the loss dict (differentiable)."""
    v_feat = model.encode_image(batch["pixels"], batch.get("erase"))
    t_feat = model.encode_text(batch["token_ids"], batch["lengths"])
    v_embed = model.embed_image(v_feat).float()
    t_embed = model.embed_text(t_feat).float()
    if use_fc:
        v_q, t_q = model.project_image(v_feat), model.project_text(t_feat)
    else:
        v_q, t_q = v_embed, t_embed
    v_q = losses.l2_normalize(v_q.float(), dim=1)
    t_q = losses.l2_normalize(t_q.float(), dim=1)
    return moco_loss_tail(
        model.projection.float(), v_embed, t_embed, v_q, t_q, v_k, t_k,
        batch["pids"].long(), state.id_queue, state.v_queue, state.t_queue,
        epsilon, MOCO_TEMPERATURE)


def moco_train_step(cfg) -> Callable[[TrainState, dict], dict]:
    """``step(state, batch) -> metrics``: one MoCo step, updating ``state``
    in place.  ``batch`` holds device tensors (``pixels`` uint8 NHWC,
    ``erase``, ``token_ids``, ``lengths``, ``pids``); ``metrics`` are 0-d
    device tensors (reading them syncs)."""
    momentum = float(cfg.MODEL.MOCO.M)
    use_fc = bool(cfg.MODEL.MOCO.FC)
    epsilon = float(cfg.MODEL.EMBEDDING.EPSILON)

    def step(state: TrainState, batch) -> dict:
        model, key_model = state.model, state.key_model
        with torch.no_grad():
            key_params = list(key_model.parameters())
            torch._foreach_mul_(key_params, momentum)
            torch._foreach_add_(key_params, list(model.parameters()),
                                alpha=1.0 - momentum)
        v_k, t_k = moco_key_forward(model, key_model, use_fc, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss_dict = moco_losses(model, state, use_fc, epsilon, batch, v_k,
                                t_k)
        total = sum(loss_dict.values())
        total.backward()
        state.optimizer.step()
        enqueue(state, v_k, t_k, batch["pids"].long())
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = total.detach()
        return metrics

    return step


def make_train_step(cfg) -> Callable[[TrainState, dict], dict]:
    if int(cfg.SOLVER.GRAD_ACCUM_STEPS) > 1:
        raise NotImplementedError(
            "SOLVER.GRAD_ACCUM_STEPS > 1 (engine/grad_cache.py) is not "
            "ported yet (ROADMAP Queue A item 8)")
    if cfg.MODEL.EMBEDDING.EMBED_HEAD != "moco":
        raise NotImplementedError(
            "the simple embedding head's train step is not ported yet "
            "(ROADMAP Queue A item 3)")
    if cfg.TPU.REMAT:
        raise NotImplementedError(
            "TPU.REMAT (recomputing the image tower in the backward) is not "
            "ported yet (ROADMAP Queue A item 3)")
    return moco_train_step(cfg)
