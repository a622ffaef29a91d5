"""Evaluation engine (counterpart of ``textreid_tpu/engine/inference.py``):
encode every (image, caption) pair with the eval path, assemble per-sample
embeddings ordered by dataset index, and hand them to the ranking
evaluator.  Eval batches have a fixed shape (the loader pads the last one
and marks the real rows in ``valid``); the similarity, CMC, mAP and
re-ranking math runs on the model's device (``evaluation/metrics.py``).
In a data-parallel group (``parallel/mesh.py``) each rank encodes every
world-th eval batch (``DataLoader.batch_shard``) and the ranks' embeddings
are gathered and put in dataset order, so every rank scores the one-process
embeddings; rank 0 alone writes the cache.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..evaluation.metrics import evaluation, format_results_table, rank_grid
from ..parallel.mesh import all_gather_object, is_distributed, rank, world_size
from .steps import encode_step


def compute_embeddings(model, data_loader) -> dict:
    """Encode the whole loader on the model's device (in a group, this
    rank's share of it, then every rank's gathered); per-sample numpy
    arrays ordered by dataset index."""
    device = next(model.parameters()).device
    chunks = {k: [] for k in ("v_embed", "t_embed", "index", "pids",
                              "image_ids")}
    if is_distributed():
        data_loader = data_loader.batch_shard(rank(), world_size())
    for batch in data_loader:
        valid = np.asarray(batch["valid"], bool)
        v, t = encode_step(model, {
            k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in ("pixels", "token_ids", "lengths")})
        chunks["v_embed"].append(v.float().cpu().numpy()[valid])
        chunks["t_embed"].append(t.float().cpu().numpy()[valid])
        for k in ("index", "pids", "image_ids"):
            chunks[k].append(np.asarray(batch[k])[valid])
    chunks = {k: [c for part in all_gather_object(chunks) for c in part[k]]
              for k in chunks}
    order = np.argsort(np.concatenate(chunks.pop("index")))
    return {k: np.concatenate(v)[order] for k, v in chunks.items()}


def inference(model, data_loader, dataset_name: str = "cuhkpedes-test",
              output_folder: str = "", save_data: bool = True,
              rerank: bool = True, topk=(1, 5, 10)) -> float:
    """Full eval protocol (reference inference.py:48-96).  Returns t2i
    CMC@1.

    When ``output_folder`` holds ``inference_data.npz``, embeddings are not
    computed again: the file is replayed, in this package's embedding
    format (which the JAX package writes too) or in the reference's
    similarity-matrix format.  A cache written here carries both.
    """
    logger = logging.getLogger("PersonSearch.inference")
    device = next(model.parameters()).device
    cache = (os.path.join(output_folder, "inference_data.npz")
             if output_folder else "")

    if cache and os.path.exists(cache):
        logger.info("Loading cached inference data from %s", cache)
        with np.load(cache) as data:
            data = {k: data[k] for k in data.files}
        if "similarity" in data and "v_embed" not in data:
            return _evaluate_reference_npz(data, topk, rerank, logger, device)
        embeds = {k: data[k] for k in
                  ("v_embed", "t_embed", "pids", "image_ids")}
    else:
        n = len(data_loader.dataset)
        logger.info("Start evaluation on %s (%d samples).", dataset_name, n)
        start = time.time()
        embeds = compute_embeddings(model, data_loader)
        total = time.time() - start
        logger.info("Total inference time: %.2fs (%.4f s/sample)", total,
                    total / n)

    results = evaluation(embeds["v_embed"], embeds["t_embed"], embeds["pids"],
                         embeds["pids"], embeds["image_ids"], topk=topk,
                         rerank=rerank, device=device)
    if cache and save_data and rank() == 0 and not os.path.exists(cache):
        save_inference_data(cache, embeds, results)
    logger.info("\n%s", format_results_table(results))
    return results["t2i"]["cmc"][0]


def save_inference_data(path: str, embeds: dict, results: dict) -> None:
    """The dual-format ``inference_data.npz``: the embeddings (replayable
    here and by the JAX package) plus the reference's ``{image_pid,
    text_pid, similarity[, rvn_mat, rtn_mat]}`` (replayable by the torch
    code's ``--load-result``)."""
    extra = {k: results[k] for k in ("image_pid", "text_pid", "similarity",
                                     "rvn_mat", "rtn_mat") if k in results}
    np.savez(path, **embeds, **extra)


@torch.inference_mode()
def _evaluate_reference_npz(data, topk, rerank, logger, device) -> float:
    """Score a similarity matrix cached by the reference torch code
    (``lib/data/metrics/evaluation.py:126-142`` save format)."""
    def tensor(name):
        return torch.as_tensor(data[name]).to(device)

    with_rerank = rerank and "rvn_mat" in data
    results = rank_grid(
        tensor("similarity"), tensor("text_pid"), tensor("image_pid"), topk,
        tensor("rvn_mat") if with_rerank else None,
        tensor("rtn_mat") if with_rerank else None)
    logger.info("\n%s", format_results_table(results))
    return results["t2i"]["cmc"][0]
