"""Plain reference of the CUHK-PEDES evaluation protocol: gallery dedupe
by image id, cosine similarity, CMC@k and mAP in both directions, and
k-reciprocal re-ranking (TextReID's ``lib/data/metrics/evaluation.py``:
the Jaccard overlap of the top-5 neighbour lists, weighted 0.05, added
to the similarity).

Everything runs in the ``dtype`` asked for: float64 for the similarity
and the grid, float32 (the configuration's precision) for the re-ranking
terms, whose top-5 lists turn on the last bits of near-equal
similarities; bfloat16 for the control.  Ties sort the lower index
first.  Imports nothing of the program."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

TOPK = (1, 5, 10)
NEIGHBOURS = 5
RERANK_WEIGHT = 0.05


def _order(sim: torch.Tensor) -> torch.Tensor:
    return torch.sort(sim, dim=1, descending=True, stable=True).indices


def rank(sim: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
         topk: Sequence[int] = TOPK) -> dict:
    """CMC at ``topk`` and mAP, in percent, summed in ``sim``'s dtype."""
    matches = (g_pids[_order(sim)] == q_pids[:, None]).to(sim.dtype)
    hit = matches.cumsum(dim=1).clamp_max(1.0).mean(dim=0) * 100.0
    cmc = [float(hit[min(k, hit.shape[0]) - 1]) for k in topk]
    relevant = matches.sum(dim=1)
    places = torch.arange(1, matches.shape[1] + 1, dtype=sim.dtype,
                          device=sim.device)
    precision = matches.cumsum(dim=1) / places
    ap = torch.where(relevant > 0, (precision * matches).sum(dim=1)
                     / relevant.clamp_min(1.0), torch.zeros_like(relevant))
    return {"cmc": cmc, "mAP": float(ap.mean() * 100.0)}


def _top_indicator(sim: torch.Tensor, k: int) -> torch.Tensor:
    idx = _order(sim)[:, :min(k, sim.shape[1])]
    return torch.zeros_like(sim).scatter_(1, idx, 1.0)


def k_reciprocal(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``RERANK_WEIGHT`` times the Jaccard overlap of each query's and each
    gallery item's top-``NEIGHBOURS`` gallery lists."""
    n = min(NEIGHBOURS, g.shape[0])
    a = _top_indicator(q @ g.T, n)
    b = _top_indicator(g @ g.T, n)
    both = a @ b.T
    return RERANK_WEIGHT * both / (2.0 * n - both)


def grid(sim, rvn, rtn, text_pid, image_pid) -> Dict:
    """The four columns of ``rank`` from a similarity ``[text, image]``
    and the re-ranking terms ``rvn [text, image]``, ``rtn [image, text]``,
    in their dtype."""
    return {"t2i": rank(sim, text_pid, image_pid),
            "i2t": rank(sim.T, image_pid, text_pid),
            "re_t2i": rank(rvn + sim, text_pid, image_pid),
            "re_i2t": rank(rtn + sim.T, image_pid, text_pid)}


def gallery(pids, image_ids, device):
    """``(keep, text_pid, image_pid)``: the first row of each image id,
    and the identities of the queries and of the deduped gallery."""
    _, first = np.unique(np.asarray(image_ids), return_index=True)
    keep = np.sort(first)
    pid = torch.as_tensor(np.asarray(pids), device=device)
    return keep, pid, pid[torch.as_tensor(keep, device=device)]


def evaluate(image_embeds, text_embeds, pids, image_ids, device,
             dtype=torch.float64) -> Dict:
    """The grid of ``grid``, ``similarity [text, deduped image]`` and
    the re-ranking terms ``rvn_mat``, ``rtn_mat``, all computed in
    ``dtype`` (float64; a lower one for the control)."""
    keep, text_pid, image_pid = gallery(pids, image_ids, device)

    def unit(x):
        x = torch.as_tensor(np.asarray(x), device=device).to(dtype)
        return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)

    images = unit(np.asarray(image_embeds)[keep])
    texts = unit(text_embeds)
    sim = texts @ images.T
    rvn, rtn = k_reciprocal(texts, images), k_reciprocal(images, texts)
    out = grid(sim, rvn, rtn, text_pid, image_pid)
    out.update(similarity=sim, rvn_mat=rvn, rtn_mat=rtn)
    return out
