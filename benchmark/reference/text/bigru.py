"""The bi-GRU text tower of the reference (TextReID, arXiv:2110.10807)
over the frozen token table: no biases (``torch.nn.GRU(bias=False)``'s
gate math), the reverse direction reading each caption's valid prefix
reversed, the pooled state the max over valid steps, and a zero joining
the max of every caption shorter than the longest of its batch."""

from __future__ import annotations

import torch

from ..layers import Params, Precision, Spec


def out_dim(cfg: dict) -> int:
    return 2 * cfg["MODEL"]["GRU"]["NUM_UNITS"]


def spec(cfg: dict) -> Spec:
    g = cfg["MODEL"]["GRU"]
    h, e = g["NUM_UNITS"], g["EMBEDDING_SIZE"]
    out = [("textual_model.frozen_token_table", (g["VOCABULARY_SIZE"], e),
            "table")]
    for suffix in ("", "_reverse"):
        out += [(f"textual_model.gru.weight_ih_l0{suffix}", (3 * h, e),
                 "matrix"),
                (f"textual_model.gru.weight_hh_l0{suffix}", (3 * h, h),
                 "matrix")]
    return out


def forward(P: Params, cfg: dict, token_ids: torch.Tensor,
            lengths: torch.Tensor, batch_max: torch.Tensor,
            q: Precision) -> torch.Tensor:
    """Max-pooled states of both directions; ``batch_max``: the longest
    caption of each row's batch (a scalar, or one a row)."""
    hidden = cfg["MODEL"]["GRU"]["NUM_UNITS"]
    x = P["textual_model.frozen_token_table"][token_ids]
    batch, seq, _ = x.shape
    lengths = lengths.long().clamp(1, seq)
    steps = torch.arange(seq, device=x.device)
    reverse = (lengths[:, None] - 1 - steps[None, :]).clamp(0, seq - 1)
    x_rev = torch.gather(x, 1, reverse[..., None].expand(-1, -1, x.shape[-1]))
    valid = steps[None, :] < lengths[:, None]
    pooled = []
    for suffix, inputs in (("", x), ("_reverse", x_rev)):
        w_ih = P[f"textual_model.gru.weight_ih_l0{suffix}"]
        w_hh = P[f"textual_model.gru.weight_hh_l0{suffix}"]
        gates_in = (q(inputs).reshape(batch * seq, -1) @ q(w_ih).T).reshape(
            batch, seq, 3 * hidden)
        h = x.new_zeros(batch, hidden)
        best = torch.full_like(h, float("-inf"))
        for t in range(seq):
            g_in = gates_in[:, t]
            g_h = q(h) @ q(w_hh).T
            r = torch.sigmoid(g_in[:, :hidden] + g_h[:, :hidden])
            z = torch.sigmoid(g_in[:, hidden:2 * hidden]
                              + g_h[:, hidden:2 * hidden])
            n = torch.tanh(g_in[:, 2 * hidden:] + r * g_h[:, 2 * hidden:])
            h = (1.0 - z) * n + z * h
            best = torch.where(valid[:, t, None], torch.maximum(best, h), best)
        pooled.append(best)
    out = torch.cat(pooled, dim=1)
    shorter = lengths < batch_max
    return torch.where(shorter[:, None], out.clamp_min(0.0), out)


def forward_ops(cfg: dict, n: int = 1) -> int:
    """Both directions over the padded grid: the input gates of every
    position and the recurrent product of every step."""
    g = cfg["MODEL"]["GRU"]
    seq, h = cfg["INPUT"]["MAX_TEXT_LENGTH"], g["NUM_UNITS"]
    return 2 * (2 * n * seq * g["EMBEDDING_SIZE"] * 3 * h
                + 2 * n * seq * h * 3 * h)
