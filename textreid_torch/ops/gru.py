"""Fused 1-layer bidirectional GRU scan with masked max-over-time pooling.

Counterpart of ``textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan``.  On a
CUDA tensor :func:`bigru_pooled_scan` launches the hand-written kernel
``csrc/bigru_pooled.cu`` through an autograd Function whose backward
differentiates the plain scan (the JAX package's custom VJP does the same;
it has no backward kernel either); on a CPU tensor it runs
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
    input dtype.  The kernel computes exactly this.

    It is also the backward's recompute (autograd through it), so it is
    written for that: the two directions run as one batched loop (``bmm``
    over a leading axis of 2), and the steps and gates are taken with
    ``unbind`` and ``chunk``, whose backward assembles the input gradient
    once, where indexing would fill and add a zero tensor of the input's
    size at every step."""
    batch, seq, _ = xf.shape
    valid = (torch.arange(seq, device=xf.device)[None, :]
             < lengths.to(xf.device)[:, None]).unbind(1)  # T x [B]
    steps = torch.stack([xf, xb]).float().unbind(2)  # T x [2, B, 3H]
    w = torch.stack([w_f, w_b]).float()  # [2, H, 3H]
    h = steps[0].new_zeros(2, batch, w.shape[1])
    m = torch.full_like(h, float("-inf"))
    for t in range(seq):
        x_r, x_z, x_n = steps[t].chunk(3, dim=-1)
        h_r, h_z, h_n = torch.bmm(h, w).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * h_n)
        h = (1.0 - z) * n + z * h
        m = torch.where(valid[t][None, :, None], torch.maximum(m, h), m)
    return torch.cat([m[0], m[1]], dim=1).to(xf.dtype)


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


class _BigruPooled(torch.autograd.Function):
    """Kernel forward; the backward reruns :func:`bigru_pooled_scan_plain`
    on the saved inputs with autograd on and backpropagates through it,
    the recompute VJP of ``bigru_pooled_scan`` in ``gru_pallas.py`` (its
    ``bwd``).  The recompute runs in f32, as the plain version does (JAX
    recomputes in the input dtype); each gradient comes back in its
    input's dtype."""

    @staticmethod
    def forward(ctx, xf, xb, w_f, w_b, lengths):
        ctx.save_for_backward(xf, xb, w_f, w_b, lengths)
        return _bigru_pooled_cuda(xf, xb, w_f, w_b, lengths)

    @staticmethod
    def backward(ctx, g):
        *inputs, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in inputs]
            out = bigru_pooled_scan_plain(*inputs, lengths)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def bigru_pooled_scan(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                      w_b: torch.Tensor, lengths: torch.Tensor,
                      pool_mode: str = "batch") -> torch.Tensor:
    """Fused 1-layer bi-GRU: scan both directions and max-pool over valid
    time steps, then apply the zero-participation rule of
    ``models.gru.masked_max_pool`` (``pool_mode`` "batch" or "always").
    Returns ``[B, 2H]`` in the input dtype; differentiable on both paths.

    A CUDA tensor launches ``bigru_pooled_fwd`` (counted in
    ``bigru_pooled_scan.launches``, forward launches only); a CPU tensor
    runs the plain version.
    """
    if xf.is_cuda:
        pooled = _BigruPooled.apply(xf, xb, w_f, w_b, lengths)
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
