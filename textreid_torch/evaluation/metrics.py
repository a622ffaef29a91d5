"""Retrieval metrics: CMC@k, mAP, and k-reciprocal re-ranking (counterpart
of ``textreid_tpu/evaluation/metrics.py``).

* ``rank`` — CMC@topk + mAP from a similarity matrix (reference
  evaluation.py:11-37).
* ``k_reciprocal`` — the Jaccard overlap between the top-``n`` neighbor
  lists of every (query, gallery) pair.  Both lists are index sets of fixed
  size ``n``, so the intersection counts for all pairs at once are one
  matrix product of one-hot neighbor indicators: ``I = A @ B.T``;
  Jaccard = ``I / (2n - I)``.
* ``evaluation`` — gallery dedupe by image id (first occurrence wins),
  L2-normalize, ``similarity = text @ image.T``, and the t2i/i2t +/- rerank
  metric grid.

Tensors live on the device of the embeddings handed in (the model's); at
CUHK-PEDES test size (6,156 captions x 3,074 images) the re-ranking
matrices are ~150 MB in float32.  Sorts are stable, so equal scores keep
the lower index first, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.losses import l2_normalize


def _descending_order(similarity: torch.Tensor) -> torch.Tensor:
    return torch.sort(similarity, dim=1, descending=True, stable=True).indices


def _stable_topk(similarity: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of each row's k largest entries, the lower index first among
    equals (``torch.topk`` promises no tie order)."""
    return _descending_order(similarity)[:, :k]


def rank(similarity: torch.Tensor, q_pids: torch.Tensor,
         g_pids: torch.Tensor, topk: Sequence[int] = (1, 5, 10),
         get_map: bool = True):
    """CMC@topk (percent) and mAP from a ``[Q, G]`` similarity matrix.
    Returns ``(cmc_at, mean_ap, indices)``, or ``(cmc_at, indices)``
    without mAP."""
    topk = tuple(int(k) for k in topk)
    max_rank = max(topk)
    indices = _descending_order(similarity)
    if not get_map:
        indices = indices[:, :max_rank]

    pred_labels = g_pids[indices]  # [Q, G or max_rank]
    matches = (pred_labels == q_pids[:, None]).float()

    cmc_curve = matches[:, :max_rank].cumsum(dim=1).clamp_max(1.0)
    all_cmc = cmc_curve.mean(dim=0) * 100.0
    # a gallery smaller than a rank reads its last entry: CMC is flat there
    at = (torch.as_tensor(topk, device=all_cmc.device) - 1).clamp_max(
        all_cmc.shape[0] - 1)
    cmc_at = all_cmc[at]
    if not get_map:
        return cmc_at, indices

    num_rel = matches.sum(dim=1)
    ranks = torch.arange(1, matches.shape[1] + 1, dtype=torch.float32,
                         device=matches.device)
    precision_at = matches.cumsum(dim=1) / ranks[None, :]
    # a query with no relevant gallery item scores AP = 0 (the reference
    # divides unguarded and would give NaN)
    ap = torch.where(num_rel > 0,
                     (precision_at * matches).sum(dim=1)
                     / num_rel.clamp_min(1.0), 0.0)
    return cmc_at, ap.mean() * 100.0, indices


def _topk_onehot(sim: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, M]`` similarity -> ``[N, M]`` float indicator of each row's
    top-k columns (k clamped to M)."""
    idx = _stable_topk(sim, min(k, sim.shape[1]))
    return torch.zeros_like(sim).scatter_(1, idx, 1.0)


def k_reciprocal(q_feats: torch.Tensor, g_feats: torch.Tensor,
                 neighbor_num: int = 5, alpha: float = 0.05) -> torch.Tensor:
    """``alpha * J`` where ``J[i, j]`` is the Jaccard similarity between the
    top-n gallery neighbors of query ``i`` (by q->g similarity) and of
    gallery item ``j`` (by g->g similarity)."""
    qg_sim = q_feats @ g_feats.T  # [Q, G]
    gg_sim = g_feats @ g_feats.T  # [G, G]
    n_eff = min(neighbor_num, g_feats.shape[0])
    a = _topk_onehot(qg_sim, n_eff)
    b = _topk_onehot(gg_sim, n_eff)
    intersection = a @ b.T
    union = 2.0 * n_eff - intersection
    return alpha * intersection / union


def get_unique_indices(image_ids: np.ndarray) -> np.ndarray:
    """First occurrence of each image id, preserving order."""
    _, first = np.unique(np.asarray(image_ids), return_index=True)
    return np.sort(first)


def _pack(cmc, mean_ap, topk) -> dict:
    return {"topk": list(topk), "cmc": [float(c) for c in cmc],
            "mAP": float(mean_ap)}


def rank_grid(similarity, text_pid, image_pid, topk, rvn=None,
              rtn=None) -> dict:
    """The t2i / i2t metric columns of ``similarity [text, image]``, and the
    re-ranked ones when the re-rank terms ``rvn [text, image]`` and ``rtn
    [image, text]`` are given."""
    results = {}
    t2i = rank(similarity, text_pid, image_pid, topk)
    i2t = rank(similarity.T, image_pid, text_pid, topk)
    results["t2i"] = _pack(t2i[0], t2i[1], topk)
    results["i2t"] = _pack(i2t[0], i2t[1], topk)
    if rvn is not None:
        re_t2i = rank(rvn + similarity, text_pid, image_pid, topk)
        re_i2t = rank(rtn + similarity.T, image_pid, text_pid, topk)
        results["re_t2i"] = _pack(re_t2i[0], re_t2i[1], topk)
        results["re_i2t"] = _pack(re_i2t[0], re_i2t[1], topk)
    return results


@torch.inference_mode()
def evaluation(image_embeds, text_embeds, image_pids, text_pids, image_ids,
               topk: Sequence[int] = (1, 5, 10), rerank: bool = True,
               device=None) -> dict:
    """Full evaluation protocol (reference evaluation.py:76-173).

    Args:
      image_embeds: ``[N, D]`` raw gallery embeddings (one per sample,
        before the dedupe), numpy or tensor.
      text_embeds: ``[N, D]`` query embeddings.
      image_pids / text_pids: ``[N]`` person ids.
      image_ids: ``[N]`` image ids used to dedupe the gallery.
      device: where the matrices are computed (default: the embeddings'
        device when they are tensors, else the CPU).

    Returns a dict with CMC/mAP for t2i and i2t, with re-ranked variants
    when ``rerank``; ``results["t2i"]["cmc"][0]`` is the headline Rank-1.
    The matrices come back as numpy arrays.
    """
    if device is None:
        device = (image_embeds.device if isinstance(image_embeds, torch.Tensor)
                  else "cpu")

    def tensor(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device)

    keep = torch.as_tensor(get_unique_indices(np.asarray(image_ids)),
                           device=device)
    image_n = l2_normalize(tensor(image_embeds).float()[keep], dim=-1)
    text_n = l2_normalize(tensor(text_embeds).float(), dim=-1)
    image_pid = tensor(image_pids)[keep]
    text_pid = tensor(text_pids)
    similarity = text_n @ image_n.T

    rvn = rtn = None
    if rerank:
        # reference naming: rtn_mat reranks i2t, rvn_mat reranks t2i
        rtn = k_reciprocal(image_n, text_n)
        rvn = k_reciprocal(text_n, image_n)
    results = rank_grid(similarity, text_pid, image_pid, topk, rvn, rtn)
    results["similarity"] = similarity.cpu().numpy()
    # deduped-gallery pids, exported so callers can write reference-format
    # replay files
    results["image_pid"] = image_pid.cpu().numpy()
    results["text_pid"] = text_pid.cpu().numpy()
    if rerank:
        results["rvn_mat"] = rvn.cpu().numpy()
        results["rtn_mat"] = rtn.cpu().numpy()
    return results


def format_results_table(results: dict) -> str:
    """Render the t2i/i2t metric grid like reference evaluation.py:164-172."""
    cols = ["t2i", "re_t2i", "i2t", "re_i2t"]
    present = [c for c in cols if c in results]
    lines = ["topk  " + "  ".join(f"{c:>8}" for c in present)]
    for row, k in enumerate(results["t2i"]["topk"]):
        vals = "  ".join(f"{results[c]['cmc'][row]:8.2f}" for c in present)
        lines.append(f"{k:<5} {vals}")
    vals = "  ".join(f"{results[c]['mAP']:8.2f}" for c in present)
    lines.append(f"{'mAP':<5} {vals}")
    return "\n".join(lines)
