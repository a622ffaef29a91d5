"""Bi-directional GRU text encoder (counterpart of ``textreid_tpu/models/gru.py``).

Each direction is a masked scan over a fixed ``[B, T]`` token grid.  The
backward direction reads a per-sample reversed sequence (position ``t``
reads token ``len-1-t``), which reproduces packed-sequence semantics.  The
input-side projections of all three gates for every step are one
``[B*T, E] x [E, 3H]`` matmul; only the recurrence runs step by step.  Gate
math is ``torch.nn.GRU`` with ``bias=False``: ``r = sigma(W_ir x + W_hr h)``,
``z = sigma(W_iz x + W_hz h)``, ``n = tanh(W_in x + r * (W_hn h))``,
``h' = (1-z) n + z h``.

The last layer runs the fused scan with pooling of ``ops/gru.py``
(``bigru_pooled_scan``), every layer before it the one-direction scan
(``gru_scan``) once per direction, the composition of the JAX encoder with
``use_pallas=True``: on CUDA the hand-written kernels, on the CPU their
plain versions.  ``MODEL.GRU.DROPOUT_KEEP_PROB`` (inter-layer dropout) is
never applied, in training either, as in the JAX step:
``textreid_tpu/models/model.py:152-153`` calls the tower with
``deterministic`` left at its default ``True``
(``textreid_tpu/models/gru.py:208``, the dropout at ``:275-277``), and no
dropout RNG is passed anywhere in that package.  So a multi-layer tower in
train mode computes its eval output.

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

from ..ops.gru import bigru_pooled_scan, gru_scan, zero_participation
from ..parallel.mesh import data_distributed, global_max
from .common import linear


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

        # K3 does not mask by length: positions t >= len are dealt with by
        # reverse_padded's clipped gather and by the last layer's t < len
        h0 = x.new_zeros(batch, self.hidden_dim)
        layer_in = x
        for layer in range(self.num_layers - 1):
            out_f = gru_scan(
                input_gates(layer_in, weight(f"weight_ih_l{layer}")),
                weight(f"weight_hh_l{layer}").T.contiguous(), h0)
            out_b = reverse_padded(gru_scan(
                input_gates(reverse_padded(layer_in, lengths),
                            weight(f"weight_ih_l{layer}_reverse")),
                weight(f"weight_hh_l{layer}_reverse").T.contiguous(), h0),
                lengths)
            layer_in = torch.cat([out_f, out_b], dim=-1)
        last = self.num_layers - 1
        batch_max = None
        if pool_mode == "batch" and self.training and data_distributed():
            # a data-parallel step's rows are its rank's share of the global
            # batch, whose longest caption the "batch" rule reads
            batch_max = global_max(lengths.max())
        return bigru_pooled_scan(
            input_gates(layer_in, weight(f"weight_ih_l{last}")),
            input_gates(reverse_padded(layer_in, lengths),
                        weight(f"weight_ih_l{last}_reverse")),
            weight(f"weight_hh_l{last}").T.contiguous(),
            weight(f"weight_hh_l{last}_reverse").T.contiguous(),
            lengths, pool_mode, batch_max)


def build_bigru(cfg, frozen_table=None) -> BiGRUEncoder:
    """Constructor mirroring ``textreid_tpu/models/gru.py:build_bigru``
    (``DROPOUT_KEEP_PROB`` is read by nothing: see the module's
    docstring)."""
    return BiGRUEncoder(
        hidden_dim=cfg.MODEL.GRU.NUM_UNITS,
        vocab_size=cfg.MODEL.GRU.VOCABULARY_SIZE,
        embed_size=cfg.MODEL.GRU.EMBEDDING_SIZE,
        num_layers=cfg.MODEL.GRU.NUM_LAYER,
        use_onehot=cfg.MODEL.GRU.ONEHOT,
        frozen_table=frozen_table,
        allow_random_table=bool(cfg.TPU.ALLOW_RANDOM_VOCAB),
    )
