"""The train steps and the eval-path encode step (counterpart of
``textreid_tpu/engine/steps.py``).

The MoCo step's order is the JAX step's (``moco_train_step``), which is
the reference's:

1. EMA of the key encoders from the *pre-update* query parameters;
2. key forward under ``no_grad`` with the updated key encoders; with
   ``MOCO.FC`` off the keys go through the *query* embed layers;
3. query forward and backward, the loss tail in f32 with same-identity
   queue negatives masked by an additive ``-inf``;
4. the optimizer step;
5. enqueue of the keys after the loss.

The simple head's step (``simple_train_step``) is the query forward, the
instance and global-align losses and the optimizer step: no key model, no
queue.  ``SOLVER.GRAD_ACCUM_STEPS > 1`` takes the gradient-cache step of
``engine/grad_cache.py`` for either head.  ``TPU.REMAT`` runs the query
image tower under ``torch.utils.checkpoint``: its activations are dropped
after the forward and recomputed in the backward, with the BatchNorm
running statistics held still during the recompute
(``models/common.py:running_stats_frozen``), so they move once a step, as
JAX's ``jax.checkpoint`` leaves them.

Mixed precision: parameters and the optimizer's moments are f32.  The
towers, embed layers and projectors run in the model's ``compute_dtype``
(bf16 on the card, ``cfg.DTYPE`` on the CPU) by casting each parameter on
use (``models/common.py``), the port's counterpart of ``flax``'s
``dtype=``; gradients flow back through the casts to the f32 masters.  No
autocast: the kernels K1, K5 and K6 get contiguous tensors of the one
dtype they check.  Unlike the JAX package, whose bi-GRU is built without a
dtype and so runs in f32, the port's text tower runs in the compute dtype
too.  Embeddings are cast to f32 before the losses, as in JAX.

Data parallelism (``parallel/mesh.py``): each rank runs its rows of the
global batch (rank r holds rows ``r * ls ... (r + 1) * ls``) through the
towers, with BatchNorm on the global batch's statistics; the query
embeddings are gathered with their gradient and the keys and ids without
it, so that every rank computes the losses of the global batch, the
same-identity queue mask over the global ids, and enqueues the global keys
in global batch order; the bi-GRU's "batch" pool rule reads the global
batch's longest caption (``models/gru.py``).  The gradients are averaged
over the ranks before
the optimizer step (:func:`finish_step`).  Every rank's state stays the
single-process step's on the global batch; with one rank no collective is
issued.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models import losses
from ..models.common import running_stats_frozen
from ..parallel.mesh import all_reduce_grads, gather_columns, gather_ids
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


def simple_loss_tail(projection, v_embed, t_embed, labels,
                     epsilon: float) -> Dict[str, torch.Tensor]:
    """The simple head's losses on f32 embeddings (reference
    simple_head/head.py:33-47): instance and global-align."""
    return {
        "instance_loss": losses.instance_loss(
            projection, v_embed, t_embed, labels, epsilon=epsilon),
        "global_align_loss": losses.global_align_loss(v_embed, t_embed,
                                                      labels),
    }


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


def moco_ema(state: TrainState, momentum: float) -> None:
    """``key = m key + (1 - m) query`` over the parameters, in place."""
    with torch.no_grad():
        key_params = list(state.key_model.parameters())
        torch._foreach_mul_(key_params, momentum)
        torch._foreach_add_(key_params, list(state.model.parameters()),
                            alpha=1.0 - momentum)


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


def encode_image_train(model, pixels, erase, remat: bool) -> torch.Tensor:
    """The query image tower in train mode; with ``remat`` (and grad on)
    under ``torch.utils.checkpoint``, the recompute leaving the BatchNorm
    running statistics alone."""
    if remat and torch.is_grad_enabled():
        # context_fn: (the forward's context, the recompute's)
        return checkpoint(model.encode_image, pixels, erase,
                          use_reentrant=False,
                          context_fn=lambda: (nullcontext(),
                                              running_stats_frozen(model)))
    return model.encode_image(pixels, erase)


def query_forward(model, batch, use_fc: Optional[bool], remat: bool):
    """The query towers to f32 embeddings: ``(v_embed, t_embed)`` for the
    simple head (``use_fc`` None), else ``(v_embed, t_embed, v_q, t_q)``
    with the MoCo queries L2-normalised (``MOCO.FC``: through the
    projectors)."""
    v_feat = encode_image_train(model, batch["pixels"], batch.get("erase"),
                                remat)
    t_feat = model.encode_text(batch["token_ids"], batch["lengths"])
    v_embed = model.embed_image(v_feat).float()
    t_embed = model.embed_text(t_feat).float()
    if use_fc is None:
        return v_embed, t_embed
    if use_fc:
        v_q, t_q = model.project_image(v_feat), model.project_text(t_feat)
    else:
        v_q, t_q = v_embed, t_embed
    return (v_embed, t_embed, losses.l2_normalize(v_q.float(), dim=1),
            losses.l2_normalize(t_q.float(), dim=1))


def gather_keys(v_k, t_k, ids):
    """The global batch's keys and ids, rank-major, without a gradient."""
    v_k, t_k = gather_columns((v_k, t_k), grad=False)
    return v_k, t_k, gather_ids(ids)


def finish_step(state: TrainState, loss_dict) -> dict:
    """Optimizer step and the metrics: every loss and their sum, as 0-d
    device tensors.  The gradients are in ``.grad``; in a data-parallel
    group they are averaged over the ranks first."""
    all_reduce_grads(state.model.parameters())
    state.optimizer.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["loss"] = sum(metrics.values())
    return metrics


def simple_train_step(cfg) -> Callable[[TrainState, dict], dict]:
    """``step(state, batch) -> metrics``: one simple-head step (reference
    simple_head/head.py:33-47), updating ``state`` in place."""
    epsilon = float(cfg.MODEL.EMBEDDING.EPSILON)
    remat = bool(cfg.TPU.REMAT)

    def step(state: TrainState, batch) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        v_embed, t_embed = gather_columns(
            query_forward(state.model, batch, None, remat))
        loss_dict = simple_loss_tail(state.model.projection.float(),
                                     v_embed, t_embed,
                                     gather_ids(batch["pids"].long()),
                                     epsilon)
        sum(loss_dict.values()).backward()
        return finish_step(state, loss_dict)

    return step


def moco_train_step(cfg) -> Callable[[TrainState, dict], dict]:
    """``step(state, batch) -> metrics``: one MoCo step, updating ``state``
    in place.  ``batch`` holds device tensors (``pixels`` uint8 NHWC,
    ``erase``, ``token_ids``, ``lengths``, ``pids``); ``metrics`` are 0-d
    device tensors (reading them syncs)."""
    momentum = float(cfg.MODEL.MOCO.M)
    use_fc = bool(cfg.MODEL.MOCO.FC)
    epsilon = float(cfg.MODEL.EMBEDDING.EPSILON)
    remat = bool(cfg.TPU.REMAT)

    def step(state: TrainState, batch) -> dict:
        model = state.model
        moco_ema(state, momentum)
        v_k, t_k, ids = gather_keys(
            *moco_key_forward(model, state.key_model, use_fc, batch),
            batch["pids"].long())
        state.optimizer.zero_grad(set_to_none=True)
        loss_dict = moco_loss_tail(
            model.projection.float(),
            *gather_columns(query_forward(model, batch, use_fc, remat)),
            v_k, t_k, ids, state.id_queue, state.v_queue, state.t_queue,
            epsilon, MOCO_TEMPERATURE)
        sum(loss_dict.values()).backward()
        metrics = finish_step(state, loss_dict)
        enqueue(state, v_k, t_k, ids)
        return metrics

    return step


@torch.inference_mode()
def encode_step(model, batch):
    """Eval-path embeddings ``(v_embed, t_embed)``: backbone features
    through the plain embed layers (reference moco_head/head.py:178-183),
    with the model's own pool rule.  ``batch`` holds device tensors
    ``pixels``, ``token_ids`` and ``lengths``; the model is expected in
    eval mode."""
    v_embed = model.embed_image(model.encode_image(batch["pixels"]))
    t_embed = model.embed_text(
        model.encode_text(batch["token_ids"], batch["lengths"]))
    return v_embed, t_embed


def make_train_step(cfg) -> Callable[[TrainState, dict], dict]:
    """The step ``cfg`` trains with: the gradient-cache step when
    ``SOLVER.GRAD_ACCUM_STEPS > 1``, else the single-pass step of the
    embedding head (``textreid_tpu/engine/steps.py:make_train_step``)."""
    n_micro = int(cfg.SOLVER.GRAD_ACCUM_STEPS)
    if n_micro > 1:
        from .grad_cache import make_grad_cache_step
        return make_grad_cache_step(cfg, n_micro)
    if cfg.MODEL.EMBEDDING.EMBED_HEAD == "moco":
        return moco_train_step(cfg)
    return simple_train_step(cfg)
