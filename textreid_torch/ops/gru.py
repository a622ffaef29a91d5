"""Fused 1-layer bidirectional GRU scan with masked max-over-time pooling.

Counterpart of ``textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan``.  On a
CUDA tensor :func:`bigru_pooled_scan` launches the hand-written kernel
``csrc/bigru_pooled.cu`` (forward only); on a CPU tensor it runs
:func:`bigru_pooled_scan_plain`, the kernel's contract.  Nothing falls back
from one to the other.

Layouts are the JAX package's: input gates ``[B, T, 3H]`` (gate order r, z,
n; the backward direction's gates already reversed per sample, see
``models.gru.reverse_padded``), recurrent weights ``[H, 3H]``.
"""

from __future__ import annotations

import torch

from . import _build


def bigru_pooled_scan_plain(xf: torch.Tensor, xb: torch.Tensor,
                            w_f: torch.Tensor, w_b: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Both directions' GRU scans in float32, then the max over ``t < len``
    (``-inf`` where a row has no valid step).  Returns ``[B, 2H]`` in the
    input dtype.  The kernel computes exactly this."""
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    valid = (torch.arange(seq, device=xf.device)[None, :]
             < lengths.to(xf.device)[:, None])  # [B, T]
    pooled = []
    for x, w in ((xf, w_f), (xb, w_b)):
        x = x.float()
        w = w.float()
        h = x.new_zeros(batch, hidden)
        m = x.new_full((batch, hidden), float("-inf"))
        for t in range(seq):
            hg = h @ w
            xg = x[:, t]
            r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
            z = torch.sigmoid(xg[:, hidden:2 * hidden]
                              + hg[:, hidden:2 * hidden])
            n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
            h = (1.0 - z) * n + z * h
            m = torch.where(valid[:, t:t + 1], torch.maximum(m, h), m)
        pooled.append(m)
    return torch.cat(pooled, dim=1).to(xf.dtype)


def _check_inputs(xf, xb, w_f, w_b, lengths) -> None:
    if xf.dim() != 3 or xf.shape != xb.shape:
        raise ValueError(f"xf/xb must be equal [B, T, 3H]; got "
                         f"{tuple(xf.shape)} and {tuple(xb.shape)}")
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    if (three_h != 3 * hidden or hidden % 32 or hidden > 2048 or seq < 1
            or batch < 1):
        raise ValueError(f"bigru_pooled_fwd needs H % 32 == 0, H <= 2048, "
                         f"T >= 1, B >= 1; got {tuple(xf.shape)}")
    for name, w in (("w_f", w_f), ("w_b", w_b)):
        if tuple(w.shape) != (hidden, three_h):
            raise ValueError(f"{name} must be [{hidden}, {three_h}]; got "
                             f"{tuple(w.shape)}")
    if tuple(lengths.shape) != (batch,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{batch}]; got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if xf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bigru_pooled_fwd takes f32 or bf16, not {xf.dtype}")
    for name, t in (("xf", xf), ("xb", xb), ("w_f", w_f), ("w_b", w_b),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != xf.device:
            raise ValueError(f"{name} must be on {xf.device}")
        if t is not lengths and t.dtype != xf.dtype:
            raise TypeError(f"{name} is {t.dtype}, xf is {xf.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bigru_pooled_cuda(xf, xb, w_f, w_b, lengths) -> torch.Tensor:
    _check_inputs(xf, xb, w_f, w_b, lengths)
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    out = torch.empty(batch, 2 * hidden, dtype=xf.dtype, device=xf.device)
    lib = _build.library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bigru_pooled_fwd(
            xf.data_ptr(), xb.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), batch, seq, hidden,
            int(xf.dtype == torch.bfloat16), stream)
    _build.check(err, "bigru_pooled_fwd")
    bigru_pooled_scan.launches += 1
    return out


def bigru_pooled_scan(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                      w_b: torch.Tensor, lengths: torch.Tensor,
                      pool_mode: str = "batch") -> torch.Tensor:
    """Fused 1-layer bi-GRU: scan both directions and max-pool over valid
    time steps, then apply the zero-participation rule of
    ``models.gru.masked_max_pool`` (``pool_mode`` "batch" or "always").
    Returns ``[B, 2H]`` in the input dtype.

    A CUDA tensor launches ``bigru_pooled_fwd`` (counted in
    ``bigru_pooled_scan.launches``); a CPU tensor runs the plain version.
    """
    if xf.is_cuda:
        pooled = _bigru_pooled_cuda(xf, xb, w_f, w_b, lengths)
    else:
        pooled = bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
    return zero_participation(pooled, lengths, xf.shape[1], pool_mode)


def zero_participation(pooled: torch.Tensor, lengths: torch.Tensor, seq: int,
                       pool_mode: str) -> torch.Tensor:
    """Let a zero join the max of every row with a padded position: rows
    shorter than the batch max (``"batch"``) or than ``seq``
    (``"always"``), as ``models.gru.masked_max_pool`` does."""
    if pool_mode == "batch":
        has_pad = lengths < lengths.max()
    elif pool_mode == "always":
        has_pad = lengths < seq
    else:
        raise ValueError(f"Unknown pool mode: {pool_mode}")
    return torch.where(has_pad[:, None], pooled.clamp_min(0.0), pooled)


bigru_pooled_scan.launches = 0
