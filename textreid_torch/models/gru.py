"""Bi-directional GRU text encoder (counterpart of ``textreid_tpu/models/gru.py``).

Each direction is a masked scan over a fixed ``[B, T]`` token grid.  The
backward direction reads a per-sample reversed sequence (position ``t``
reads token ``len-1-t``), which reproduces packed-sequence semantics.  The
input-side projections of all three gates for every step are one
``[B*T, E] x [E, 3H]`` matmul; only the recurrence runs step by step.  Gate
math is ``torch.nn.GRU`` with ``bias=False``: ``r = sigma(W_ir x + W_hr h)``,
``z = sigma(W_iz x + W_hz h)``, ``n = tanh(W_in x + r * (W_hn h))``,
``h' = (1-z) n + z h``.

A 1-layer encoder (every shipped config) runs the fused scan of
``ops/gru.py``: on CUDA the hand-written kernel, on the CPU its plain
version.  Deeper encoders run the plain per-direction scan on the CPU only,
until the one-direction scan kernel is ported.

Parameter names follow the reference torch layout (``embed.*``,
``gru.weight_ih_l0``, ``gru.weight_hh_l0`` and their ``_reverse`` pair);
the frozen token table is the buffer ``frozen_token_table``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gru import bigru_pooled_scan, zero_participation
from .common import linear


def gru_scan(x_gates: torch.Tensor, w_h: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """One direction over precomputed input gates ``[B, T, 3H]`` with the
    recurrent weight ``[H, 3H]``; returns every hidden state ``[B, T, H]``."""
    hidden = h0.shape[-1]
    h = h0
    outs = []
    for t in range(x_gates.shape[1]):
        hg = h @ w_h
        xg = x_gates[:, t]
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)


def masked_max_pool(x: torch.Tensor, lengths: torch.Tensor,
                    mode: str = "batch") -> torch.Tensor:
    """Max over valid time steps with torch pad-packed semantics: steps
    ``t >= len_b`` are excluded, and a zero participates for every sample
    shorter than the batch max (``"batch"``, the reference's rule, which
    depends on the batch's make-up) or shorter than the padded grid
    (``"always"``, the packing-invariant rule serving uses)."""
    seq = x.shape[1]
    valid = (torch.arange(seq, device=x.device)[None, :]
             < lengths[:, None])[..., None]
    m = torch.where(valid, x, float("-inf")).amax(dim=1)
    return zero_participation(m, lengths, seq, mode)


def reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-sample reversal of the valid prefix: ``out[b, t] = x[b, len_b-1-t]``.
    Positions ``t >= len_b`` hold out-of-prefix values; callers mask them."""
    seq = x.shape[1]
    t_idx = torch.arange(seq, device=x.device)[None, :]
    src = (lengths.long()[:, None] - 1 - t_idx).clamp(0, seq - 1)
    return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[-1]))


class _GRUWeights(nn.Module):
    """``torch.nn.GRU(bias=False, bidirectional=True)``'s parameters, by its
    names and in its layout (``weight_ih_l{n}`` ``[3H, in]``,
    ``weight_hh_l{n}`` ``[3H, H]``), with its U(-1/sqrt(H), 1/sqrt(H)) init.
    Only a holder: the scans read the weights directly."""

    def __init__(self, input_size: int, hidden: int, num_layers: int):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * hidden
            for suffix in ("", "_reverse"):
                for name, cols in (("ih", in_dim), ("hh", hidden)):
                    w = torch.empty(3 * hidden, cols).uniform_(-bound, bound)
                    self.register_parameter(
                        f"weight_{name}_l{layer}{suffix}", nn.Parameter(w))


class BiGRUEncoder(nn.Module):
    """Bi-GRU over embedded tokens with masked max-over-time pooling."""

    def __init__(self, hidden_dim: int = 512, vocab_size: int = 12000,
                 embed_size: int = 512, num_layers: int = 1,
                 use_onehot: str = "yes",
                 frozen_table: Optional[np.ndarray] = None,
                 allow_random_table: bool = False, pool_mode: str = "batch"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.pool_mode = pool_mode
        self.embed: Optional[nn.Module] = None
        if use_onehot == "yes":
            self.embed = nn.Embedding(vocab_size, embed_size, padding_idx=0)
            self.frozen_token_table = None
        else:
            if frozen_table is not None:
                table = torch.as_tensor(np.asarray(frozen_table),
                                        dtype=torch.float32)
            elif allow_random_table:
                # explicitly requested (synthetic runs): a seeded table
                table = torch.randn(vocab_size, embed_size)
            else:
                raise ValueError(
                    f"use_onehot={use_onehot!r} needs a frozen token table "
                    "(frozen_table), or allow_random_table=True for "
                    "synthetic runs.")
            self.register_buffer("frozen_token_table", table)
            if table.shape[1] != embed_size:
                self.embed = nn.Linear(table.shape[1], embed_size)
        self.gru = _GRUWeights(embed_size, hidden_dim, num_layers)

    @property
    def out_channels(self) -> int:
        return 2 * self.hidden_dim

    def embed_tokens(self, token_ids: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Token embeddings in ``dtype`` (default: the table's)."""
        if self.frozen_token_table is None:
            x = F.embedding(token_ids, self.embed.weight, padding_idx=0)
            return x if dtype is None else x.to(dtype)
        x = self.frozen_token_table[token_ids]
        if dtype is not None:
            x = x.to(dtype)
        return x if self.embed is None else linear(x, self.embed)

    def forward(self, token_ids: torch.Tensor, lengths: torch.Tensor,
                pool_mode: Optional[str] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """token_ids ``[B, T]``, lengths ``[B]`` -> ``[B, 2H]``, computed in
        ``dtype`` (default: the token table's).  ``pool_mode`` overrides
        the module's rule for this call."""
        pool_mode = pool_mode or self.pool_mode
        x = self.embed_tokens(token_ids, dtype)
        batch, seq, _ = x.shape
        lengths = lengths.clamp(1, seq).to(torch.int32)
        gru = self.gru

        def weight(name):
            return getattr(gru, name).to(x.dtype)

        def input_gates(inputs, w_ih):
            return (inputs.reshape(batch * seq, -1) @ w_ih.T).reshape(
                batch, seq, -1)

        if self.num_layers == 1:
            return bigru_pooled_scan(
                input_gates(x, weight("weight_ih_l0")),
                input_gates(reverse_padded(x, lengths),
                            weight("weight_ih_l0_reverse")),
                weight("weight_hh_l0").T.contiguous(),
                weight("weight_hh_l0_reverse").T.contiguous(),
                lengths, pool_mode)
        if x.is_cuda:
            raise NotImplementedError(
                "a multi-layer GRU needs the one-direction scan kernel "
                "(textreid_tpu/ops/gru_pallas.py:gru_scan_pallas), which is "
                "not ported yet (ROADMAP Queue B item 2)")
        h0 = x.new_zeros(batch, self.hidden_dim)
        layer_in = x
        for layer in range(self.num_layers):
            w_ih = weight(f"weight_ih_l{layer}")
            w_hh = weight(f"weight_hh_l{layer}")
            w_ih_r = weight(f"weight_ih_l{layer}_reverse")
            w_hh_r = weight(f"weight_hh_l{layer}_reverse")
            out_f = gru_scan(input_gates(layer_in, w_ih), w_hh.T, h0)
            rev = reverse_padded(layer_in, lengths)
            out_b = reverse_padded(
                gru_scan(input_gates(rev, w_ih_r), w_hh_r.T, h0), lengths)
            layer_in = torch.cat([out_f, out_b], dim=-1)
        return masked_max_pool(layer_in, lengths, pool_mode)


def build_bigru(cfg, frozen_table=None) -> BiGRUEncoder:
    """Constructor mirroring ``textreid_tpu/models/gru.py:build_bigru``."""
    return BiGRUEncoder(
        hidden_dim=cfg.MODEL.GRU.NUM_UNITS,
        vocab_size=cfg.MODEL.GRU.VOCABULARY_SIZE,
        embed_size=cfg.MODEL.GRU.EMBEDDING_SIZE,
        num_layers=cfg.MODEL.GRU.NUM_LAYER,
        use_onehot=cfg.MODEL.GRU.ONEHOT,
        frozen_table=frozen_table,
        allow_random_table=bool(cfg.TPU.ALLOW_RANDOM_VOCAB),
    )
