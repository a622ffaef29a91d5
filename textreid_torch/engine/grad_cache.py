"""Exact large-batch contrastive training at microbatch activation memory
(counterpart of ``textreid_tpu/engine/grad_cache.py``):
``SOLVER.GRAD_ACCUM_STEPS = M > 1``, for either embedding head.

Summing per-microbatch losses would train another objective: the
global-align loss couples every pair of the batch, and the MoCo queue
mask is a function of all its ids.  So, as in the JAX step (the gradient
cache of Gao et al. 2021):

1. for MoCo, the EMA of the key encoders once a step, then the key
   forward of each microbatch in order (the key BatchNorm statistics
   advance from one to the next);
2. pass 1: each microbatch through the query towers under ``no_grad``,
   its f32 embeddings kept (the running statistics advance in order);
3. the full-batch loss tail (``steps.moco_loss_tail`` with all B ids in
   the queue mask, or ``steps.simple_loss_tail``), differentiated with
   respect to the embeddings and the loss projection;
4. pass 2: each microbatch's forward again, with autograd, its slice of
   the cached embedding gradients backpropagated into the parameters'
   ``.grad`` (summed over the microbatches);
5. one optimizer step and, for MoCo, one full-batch enqueue.

Its spans are the single-pass steps' (``engine/steps.py``): the root
``train.step``; ``train.ema`` and ``train.key_forward`` (1);
``train.query_forward`` pass 1 and the loss tail's forward (2, 3);
``train.backward`` the tail's backward and pass 2, whose replays exist for
the backward (3, 4); ``train.optimizer`` and ``train.enqueue`` (5).

Pass 2's replays leave the running statistics where pass 1 put them
(``models/common.py:running_stats_frozen``), as JAX keeps pass 1's; in
train mode a BatchNorm's output depends on the batch statistics alone,
so the replay computes pass 1's forward.  One difference from JAX: on the
card, pass 1 under ``no_grad`` runs K1's pooled-only kernel and pass 2
its training forward, which agree within K1's bf16 tolerance rather than
bit for bit (``ops/gru.py:_BigruPooled``); ``chip_smoke.py`` measures the
embeddings' largest difference and gates it.  BatchNorm towers normalise
each microbatch with its own statistics, so only LayerNorm towers compute
the single-pass step's objective (the JAX package's documented delta).

Data parallelism (``parallel/mesh.py``), as JAX composes the two: each
data shard splits its own rows into the M microbatches, and the global
microbatch i is every shard's microbatch i (BatchNorm on their joint
statistics).  The keys, ids and pass-1 embeddings are gathered a
microbatch at a time, so the global batch the loss sees is microbatch-major
(microbatch 0 of shard 0, of shard 1, ..., then microbatch 1); each rank
replays its own microbatches against its rows of the cached gradients,
scaled by the data-shard count as the gather's backward would sum them,
and the gradients are averaged in ``finish_step``.  The result is the
one-process step on the global batch in that order.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..models.common import running_stats_frozen
from ..parallel.mesh import data_rank, data_size, gather_columns, gather_ids
from ..utils.profiling import span
from .state import TrainState
from .steps import (
    MOCO_TEMPERATURE,
    enqueue,
    finish_step,
    gather_keys,
    moco_ema,
    moco_key_forward,
    moco_loss_tail,
    query_forward,
    simple_loss_tail,
)


def split_micro(batch: dict, n_micro: int) -> List[dict]:
    """``n_micro`` microbatches of ``B / n_micro`` rows each, in order."""
    micros: List[dict] = [{} for _ in range(n_micro)]
    for key, x in batch.items():
        if x.shape[0] % n_micro != 0:
            raise ValueError(
                f"SOLVER.GRAD_ACCUM_STEPS={n_micro} must divide the global "
                f"batch size {x.shape[0]}")
        for micro, part in zip(micros, x.chunk(n_micro)):
            micro[key] = part
    return micros


def cached_grads(model, micros: List[dict], remat: bool,
                 use_fc: Optional[bool], tail_fn: Callable) -> dict:
    """Passes 1-4 above: the gradients of ``tail_fn(embeds, projection)``
    (the full batch's loss dict) land in the parameters' ``.grad``;
    returns the loss dict."""
    with span("train.query_forward"):
        with torch.no_grad():
            outs = [gather_columns(query_forward(model, m, use_fc, remat),
                                   grad=False) for m in micros]
        embeds = tuple(torch.cat(o).requires_grad_(True)
                       for o in zip(*outs))
        loss_dict = tail_fn(embeds, model.projection.float())
        loss = sum(loss_dict.values())
    with span("train.backward"):
        loss.backward()
        cts = [own_rows(e.grad, len(micros)) for e in embeds]
        with running_stats_frozen(model):
            for i, micro in enumerate(micros):
                replay = query_forward(model, micro, use_fc, remat)
                pairs = [(out, ct[i]) for out, ct in zip(replay, cts)
                         if out.requires_grad]
                torch.autograd.backward([p[0] for p in pairs],
                                        [p[1] for p in pairs])
    return loss_dict


def own_rows(grad: torch.Tensor, n_micro: int) -> list:
    """This rank's rows of each microbatch of a microbatch-major global
    ``grad``, times the data-shard count (the sum the gather's backward
    would form over the shards' identical losses); ``grad``'s chunks with
    one shard."""
    chunks, shards = grad.chunk(n_micro), data_size()
    if shards == 1:
        return chunks
    return [c.chunk(shards)[data_rank()] * shards for c in chunks]


def make_grad_cache_step(cfg, n_micro: int):
    """``step(state, batch) -> metrics`` as ``steps.make_train_step``'s
    single-pass steps, in ``n_micro`` microbatches."""
    is_moco = cfg.MODEL.EMBEDDING.EMBED_HEAD == "moco"
    momentum = float(cfg.MODEL.MOCO.M)
    use_fc = bool(cfg.MODEL.MOCO.FC) if is_moco else None
    epsilon = float(cfg.MODEL.EMBEDDING.EPSILON)
    remat = bool(cfg.TPU.REMAT)

    def simple_step(state: TrainState, batch) -> dict:
        with span("train.step"):
            micros = split_micro(batch, n_micro)
            labels = torch.cat([gather_ids(m["pids"].long())
                                for m in micros])

            def tail_fn(embeds, projection):
                return simple_loss_tail(projection, *embeds, labels,
                                        epsilon)

            state.optimizer.zero_grad(set_to_none=True)
            loss_dict = cached_grads(state.model, micros, remat, use_fc,
                                     tail_fn)
            return finish_step(state, loss_dict)

    def moco_step(state: TrainState, batch) -> dict:
        with span("train.step"):
            micros = split_micro(batch, n_micro)
            with span("train.ema"):
                moco_ema(state, momentum)
            with span("train.key_forward"):
                keys = [gather_keys(*moco_key_forward(
                    state.model, state.key_model, use_fc, m),
                    m["pids"].long()) for m in micros]
                v_k, t_k, ids = (torch.cat(k) for k in zip(*keys))

            def tail_fn(embeds, projection):
                return moco_loss_tail(projection, *embeds, v_k, t_k, ids,
                                      state.id_queue, state.v_queue,
                                      state.t_queue, epsilon,
                                      MOCO_TEMPERATURE)

            state.optimizer.zero_grad(set_to_none=True)
            loss_dict = cached_grads(state.model, micros, remat, use_fc,
                                     tail_fn)
            metrics = finish_step(state, loss_dict)
            with span("train.enqueue"):
                enqueue(state, v_k, t_k, ids)
            return metrics

    return moco_step if is_moco else simple_step
