"""The GRU recurrences: the fused 1-layer bidirectional scan with masked
max-over-time pooling, and the one-direction scan that returns every hidden
state.

Counterpart of ``textreid_tpu/ops/gru_pallas.py``: :func:`bigru_pooled_scan`
of ``bigru_pooled_scan`` there, :func:`gru_scan` of ``gru_scan_pallas``
behind ``gru_scan_auto``.  On a CUDA tensor each launches its hand-written
kernel through an autograd Function: the fused scan's forward in bf16 the
W-resident kernel of ``csrc/bigru_resident.cu`` (W held in registers
across a cluster of H / 32 blocks, the tensor cores' ``mma.sync``), in f32
the streamed kernels of ``csrc/bigru_pooled.cu`` and
``csrc/bigru_pooled_bwd.cu``; the one-direction scan in bf16 the same
design, ``csrc/gru_scan_resident.cu``, in f32 the streamed
``csrc/gru_scan.cu`` (:func:`scan_kernel` is the rule).
The fused scan's backward is a kernel too, fed by a training forward that
keeps each step's state (the JAX package's custom VJP differentiates its
XLA scan instead: it has no backward kernel): in bf16 the W-resident
``csrc/bigru_resident_bwd.cu``, in f32 the streamed
``csrc/bigru_pooled_bwd.cu`` (:func:`bwd_kernel` is the rule); the
one-direction scan's backward
differentiates its plain version, as the JAX package's does.  On a CPU
tensor each runs its plain versions (``*_plain``), the kernels' contracts.
Nothing falls back from one to the other.

Layouts are the JAX package's: input gates ``[B, T, 3H]`` (gate order r, z,
n; the backward direction's gates already reversed per sample, see
``models.gru.reverse_padded``), recurrent weights ``[H, 3H]``.  Kernels and
plain versions keep ``h`` and the gates in float32 whatever the input dtype
and round only the result.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# The backward kernels' bound, and so the training forward's (it feeds only
# them): the bf16 kernel's cluster has H / 32 blocks, at most 16
# (csrc/bigru_resident_bwd.cu); the f32 kernel's blocks run H / 2 threads,
# at most 256 so that two fit an SM (csrc/bigru_pooled_bwd.cu)
MAX_TRAIN_HIDDEN = 512
# The bf16 forward's cluster has H / 32 blocks, at most 16
# (csrc/bigru_resident.cu)
MAX_RESIDENT_HIDDEN = 512
# rows a cluster of the bf16 forward and backward takes, in order of
# preference
RESIDENT_ROWS = (32, 16)
# Shared memory a block can use (H100: 227 KB)
MAX_SHARED_BYTES = 232448


def resident_plan(batch: int, capacity: dict, directions: int = 2) -> tuple:
    """The W-resident bf16 kernels' launch plan for ``batch`` rows, as
    ``csrc/gru_resident.cuh:plan_rows`` computes it: ``capacity`` maps rows a
    cluster (32, 16) to the clusters of that size the card holds at once.
    Each direction's rows go in groups of ``rows``, one (direction, group)
    item a cluster at a time; the rows that take the fewest rounds of
    ``rows``-row steps (waves x rows) win, 32 on a tie.  K1 runs both
    directions in one launch (``directions=2``), K3 one.  Returns ``(rows,
    clusters, items, waves)``."""
    best = None
    for rows in RESIDENT_ROWS:
        items = directions * -(-batch // rows)
        waves = -(-items // capacity[rows])
        if best is None or waves * rows < best[0]:
            best = (waves * rows, rows, min(items, capacity[rows]), items,
                    waves)
    return best[1:]


def scan_kernel(dtype: torch.dtype, hidden: int) -> str:
    """The entry point K3 launches for ``dtype`` and ``H``: bf16 with
    ``H % 32 == 0`` and ``H <= MAX_RESIDENT_HIDDEN`` runs the W-resident
    kernel (``csrc/gru_scan_resident.cu``: W in registers across H / 32
    blocks, at most 16); f32 (whose W slice does not fit the registers) and
    a wider bf16 H run the streamed kernel (``csrc/gru_scan.cu``)."""
    if (dtype == torch.bfloat16 and hidden % 32 == 0
            and hidden <= MAX_RESIDENT_HIDDEN):
        return "gru_scan_fwd_resident"
    return "gru_scan_fwd"


def bwd_kernel(dtype: torch.dtype) -> str:
    """The entry point K1's backward launches for ``dtype`` (every H the
    backward admits, ``H % 32 == 0`` and ``H <= MAX_TRAIN_HIDDEN``, fits
    both kernels): bf16 runs the W-resident kernel
    (``csrc/bigru_resident_bwd.cu``: W in registers across H / 32 blocks,
    dh reduce-scattered between them); f32 (whose W slice does not fit the
    registers) runs the streamed kernel (``csrc/bigru_pooled_bwd.cu``,
    which takes W transposed)."""
    if dtype == torch.bfloat16:
        return "bigru_resident_bwd"
    return "bigru_pooled_bwd"


def resident_bwd_smem(hidden: int, rows: int) -> int:
    """Shared memory of a block of the W-resident backward, as
    ``csrc/bigru_resident_bwd.cu:resident_bwd_smem`` computes it: the
    receive buffers ``[2][H / 32 peers][rows][32]`` f32, the A tile ``[2
    planes][rows][96 + 8]`` bf16 and two mbarriers (chip_smoke.py holds it
    against the library's ``bigru_resident_bwd_smem`` on the card)."""
    return 4 * 2 * (hidden // 32) * rows * 32 + 2 * 2 * rows * 104 + 16


def bigru_pooled_scan_plain(xf: torch.Tensor, xb: torch.Tensor,
                            w_f: torch.Tensor, w_b: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Both directions' GRU scans in float32, then the max over ``t < len``
    (``-inf`` where a row has no valid step).  Returns ``[B, 2H]`` in the
    input dtype.  The kernel computes exactly this.

    It is also the plain path of the training step, differentiated by
    autograd, so it is written for that: the two directions run as one
    batched loop (``bmm`` over a leading axis of 2), and the steps and
    gates are taken with ``unbind`` and ``chunk``, whose backward assembles
    the input gradient once, where indexing would fill and add a zero
    tensor of the input's size at every step."""
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


def bigru_pooled_fwd_train_plain(xf: torch.Tensor, xb: torch.Tensor,
                                 w_f: torch.Tensor, w_b: torch.Tensor,
                                 lengths: torch.Tensor):
    """The training forward: the pooled ``[B, 2H]`` of
    :func:`bigru_pooled_scan_plain` (the same arithmetic) and what the
    backward needs, in float32: ``hp [2, B, T, H]`` (``h_{t-1}`` of step
    ``t``, ``h_{-1} = 0``), ``gates [2, B, T, 4, H]`` (``r, z, n`` and
    ``h_n = (h_{t-1} W)_n``), and ``argmax [B, 2H]`` int32: per (row, unit)
    the first step ``t < len`` whose ``h_t`` reached the max, ``-1`` where
    the row has no valid step.  The kernel's training mode computes exactly
    this."""
    batch, seq, _ = xf.shape
    valid = (torch.arange(seq, device=xf.device)[None, :]
             < lengths.to(xf.device)[:, None])  # [B, T]
    x = torch.stack([xf, xb]).float()  # [2, B, T, 3H]
    w = torch.stack([w_f, w_b]).float()  # [2, H, 3H]
    hidden = w.shape[1]
    hp = x.new_empty(2, batch, seq, hidden)
    gates = x.new_empty(2, batch, seq, 4, hidden)
    h = x.new_zeros(2, batch, hidden)
    m = torch.full_like(h, float("-inf"))
    am = torch.full(h.shape, -1, dtype=torch.int32, device=xf.device)
    for t in range(seq):
        x_r, x_z, x_n = x[:, :, t].chunk(3, dim=-1)
        h_r, h_z, h_n = torch.bmm(h, w).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * h_n)
        hp[:, :, t] = h
        gates[:, :, t] = torch.stack([r, z, n, h_n], dim=2)
        h = (1.0 - z) * n + z * h
        up = valid[None, :, t, None] & (h > m)  # strictly greater: first max
        m = torch.where(up, h, m)
        am.masked_fill_(up, t)
    pooled = torch.cat([m[0], m[1]], dim=1).to(xf.dtype)
    return pooled, hp, gates, torch.cat([am[0], am[1]], dim=1)


def bigru_pooled_bwd_plain(g: torch.Tensor, w_f: torch.Tensor,
                           w_b: torch.Tensor, lengths: torch.Tensor,
                           hp: torch.Tensor, gates: torch.Tensor,
                           argmax: torch.Tensor):
    """The gradient of the pooled scan (before the zero-participation rule)
    from the training forward's saved state: ``g [B, 2H]`` ->
    ``(dxf, dxb, dw_f, dw_b)``, ``dx`` in ``g``'s dtype and ``dw`` in the
    weights', computed in float32.  Per direction and row, for ``t = T-1 ..
    0``::

        dh   += [t == argmax] g
        a_z   = dh (h_{t-1} - n) z (1 - z),  a_n = dh (1 - z) (1 - n^2)
        a_r   = a_n h_n r (1 - r)
        dx_t  = [a_r, a_z, a_n],  dhg_t = [a_r, a_z, a_n r]
        dh    = dh z + dhg_t W^T
        dW    = sum_t h_{t-1}^T dhg_t

    Steps at ``t >= len`` get exactly zero, and so does a row with no valid
    step.  Ties: the whole pool gradient goes to the first step ``t < len``
    at the max (``argmax``).  Autograd through
    :func:`bigru_pooled_scan_plain` splits an exact tie 0.5/0.5 at each
    ``torch.maximum``, and JAX's ``jnp.max`` (``_xla_pooled_forward``, the
    VJP of ``bigru_pooled_scan``) splits it evenly; all three agree wherever
    no two valid steps hold exactly the same maximum.  Not autograd: this is
    the backward kernel's contract and the backward of the CPU path."""
    _, batch, seq, hidden = hp.shape
    wt = torch.stack([w_f, w_b]).float().transpose(1, 2)  # [2, 3H, H]
    pool_g = g.float().view(batch, 2, hidden).transpose(0, 1)  # [2, B, H]
    hit = argmax.view(batch, 2, hidden).transpose(0, 1)
    dx = hp.new_zeros(2, batch, seq, 3 * hidden)
    dhg = hp.new_zeros(2, batch, seq, 3 * hidden)
    dh = hp.new_zeros(2, batch, hidden)
    top = min(seq, int(lengths.max())) if batch else 0  # later steps: zero
    for t in range(top - 1, -1, -1):
        dh = dh + torch.where(hit == t, pool_g, 0.0)
        r, z, n, h_n = gates[:, :, t].unbind(2)
        a_z = dh * (hp[:, :, t] - n) * z * (1.0 - z)
        a_n = dh * (1.0 - z) * (1.0 - n * n)
        a_r = a_n * h_n * r * (1.0 - r)
        dx[:, :, t] = torch.cat([a_r, a_z, a_n], dim=-1)
        dhg[:, :, t] = torch.cat([a_r, a_z, a_n * r], dim=-1)
        dh = dh * z + torch.bmm(dhg[:, :, t], wt)
    dw = torch.bmm(hp.view(2, -1, hidden).transpose(1, 2),
                   dhg.view(2, -1, 3 * hidden))
    return (dx[0].to(g.dtype), dx[1].to(g.dtype), dw[0].to(w_f.dtype),
            dw[1].to(w_b.dtype))


def _check_inputs(xf, xb, w_f, w_b, lengths, train=False) -> None:
    if xf.dim() != 3 or xf.shape != xb.shape:
        raise ValueError(f"xf/xb must be equal [B, T, 3H]; got "
                         f"{tuple(xf.shape)} and {tuple(xb.shape)}")
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    if (three_h != 3 * hidden or hidden % 32 or hidden > 2048 or seq < 1
            or batch < 1):
        raise ValueError(f"bigru_pooled_fwd needs H % 32 == 0, H <= 2048, "
                         f"T >= 1, B >= 1; got {tuple(xf.shape)}")
    if train and hidden > MAX_TRAIN_HIDDEN:
        raise ValueError(f"bigru_pooled_bwd needs H <= {MAX_TRAIN_HIDDEN} "
                         f"(the backward kernels' bound); got H={hidden}")
    if xf.dtype == torch.bfloat16 and hidden > MAX_RESIDENT_HIDDEN:
        raise ValueError(f"bigru_pooled_fwd in bf16 needs H <= "
                         f"{MAX_RESIDENT_HIDDEN} (H / 32 blocks a cluster); "
                         f"got H={hidden}")
    for name, w in (("w_f", w_f), ("w_b", w_b)):
        if tuple(w.shape) != (hidden, three_h):
            raise ValueError(f"{name} must be [{hidden}, {three_h}]; got "
                             f"{tuple(w.shape)}")
    if tuple(lengths.shape) != (batch,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{batch}]; got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if xf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bigru_pooled_fwd takes f32 or bf16, not {xf.dtype}")
    _check_on_card(xf, (("xf", xf), ("xb", xb), ("w_f", w_f), ("w_b", w_b)),
                   (("lengths", lengths),))
    if any(t.data_ptr() % 16 for t in (xf, xb)):
        # the bf16 kernel reads each thread's input gates as one vector
        raise ValueError("xf and xb must start on a 16-byte boundary")


def _check_on_card(ref, same_dtype, other) -> None:
    """Each tensor on ``ref``'s CUDA device and contiguous; those of
    ``same_dtype`` in ``ref``'s dtype."""
    for name, t in (*same_dtype, *other):
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name} must be on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in same_dtype:
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, {same_dtype[0][0]} is "
                            f"{ref.dtype}")


def _launch(name, *args):
    """Call the C entry point ``name`` on the current stream of the first
    tensor's device (tensors pass as pointers); raise on a launch error."""
    lib = _build.library()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(a.data_ptr() if isinstance(
            a, torch.Tensor) else a for a in args), stream)
    _build.check(err, name)


def _bigru_pooled_cuda(xf, xb, w_f, w_b, lengths) -> torch.Tensor:
    _check_inputs(xf, xb, w_f, w_b, lengths)
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    out = torch.empty(batch, 2 * hidden, dtype=xf.dtype, device=xf.device)
    _launch("bigru_pooled_fwd", xf, xb, w_f, w_b, lengths, out, batch, seq,
            hidden, int(xf.dtype == torch.bfloat16))
    bigru_pooled_scan.launches += 1
    return out


def bigru_pooled_fwd_train(xf: torch.Tensor, xb: torch.Tensor,
                           w_f: torch.Tensor, w_b: torch.Tensor,
                           lengths: torch.Tensor):
    """The training forward: ``(pooled, hp, gates, argmax)`` as
    :func:`bigru_pooled_fwd_train_plain` returns them.  A CUDA tensor
    launches ``bigru_pooled_fwd_train`` (counted in
    ``bigru_pooled_scan.launches``, with the pooled-only forward); a CPU
    tensor runs the plain version."""
    if not xf.is_cuda:
        return bigru_pooled_fwd_train_plain(xf, xb, w_f, w_b, lengths)
    _check_inputs(xf, xb, w_f, w_b, lengths, train=True)
    batch, seq, three_h = xf.shape
    hidden = three_h // 3
    f32 = dict(dtype=torch.float32, device=xf.device)
    out = torch.empty(batch, 2 * hidden, dtype=xf.dtype, device=xf.device)
    hp = torch.empty(2, batch, seq, hidden, **f32)
    gates = torch.empty(2, batch, seq, 4, hidden, **f32)
    argmax = torch.empty(batch, 2 * hidden, dtype=torch.int32,
                         device=xf.device)
    _launch("bigru_pooled_fwd_train", xf, xb, w_f, w_b, lengths, out, hp,
            gates, argmax, batch, seq, hidden, int(xf.dtype == torch.bfloat16))
    bigru_pooled_scan.launches += 1
    return out, hp, gates, argmax


def bigru_pooled_bwd(g: torch.Tensor, w_f: torch.Tensor, w_b: torch.Tensor,
                     lengths: torch.Tensor, hp: torch.Tensor,
                     gates: torch.Tensor, argmax: torch.Tensor):
    """The gradient of the pooled scan from the training forward's state:
    ``(dxf, dxb, dw_f, dw_b)`` as :func:`bigru_pooled_bwd_plain` returns
    them.  A CUDA tensor launches the kernel :func:`bwd_kernel` names
    (counted in ``bigru_pooled_bwd.launches``), which writes ``dx`` and the
    f32 ``dhg``; ``dW = hp^T dhg`` is then one f32 product over ``B T``
    rows, as the JAX package leaves it to XLA.  A CPU tensor runs the plain
    version."""
    if not g.is_cuda:
        return bigru_pooled_bwd_plain(g, w_f, w_b, lengths, hp, gates, argmax)
    two, batch, seq, hidden = hp.shape
    if (g.dim() != 2 or two != 2 or tuple(g.shape) != (batch, 2 * hidden)
            or hidden % 32 or hidden > MAX_TRAIN_HIDDEN or seq < 1):
        raise ValueError(f"bigru_pooled_bwd needs g [B, 2H] and hp "
                         f"[2, B, T, H] with H % 32 == 0, H <= "
                         f"{MAX_TRAIN_HIDDEN}; got {tuple(g.shape)} and "
                         f"{tuple(hp.shape)}")
    for name, t, shape, dtype in (
            ("w_f", w_f, (hidden, 3 * hidden), g.dtype),
            ("w_b", w_b, (hidden, 3 * hidden), g.dtype),
            ("lengths", lengths, (batch,), torch.int32),
            ("hp", hp, (2, batch, seq, hidden), torch.float32),
            ("gates", gates, (2, batch, seq, 4, hidden), torch.float32),
            ("argmax", argmax, (batch, 2 * hidden), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}; got "
                             f"{t.dtype} {list(t.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bigru_pooled_bwd takes f32 or bf16, not {g.dtype}")
    _check_on_card(g, (("g", g),), (("w_f", w_f), ("w_b", w_b),
                                    ("lengths", lengths), ("hp", hp),
                                    ("gates", gates), ("argmax", argmax)))
    dxf, dxb, dhg = launch_bigru_pooled_bwd(g, w_f, w_b, lengths, hp, gates,
                                           argmax)
    dw = torch.bmm(hp.view(2, -1, hidden).transpose(1, 2),
                   dhg.view(2, -1, 3 * hidden))
    return dxf, dxb, dw[0].to(w_f.dtype), dw[1].to(w_b.dtype)


def launch_bigru_pooled_bwd(g, w_f, w_b, lengths, hp, gates, argmax):
    """The launch of :func:`bigru_pooled_bwd` alone, on CUDA inputs it has
    checked: the kernel :func:`bwd_kernel` names -> ``(dxf, dxb, dhg)``,
    counted in ``bigru_pooled_bwd.launches``."""
    _, batch, seq, hidden = hp.shape
    dxf = torch.empty(batch, seq, 3 * hidden, dtype=g.dtype, device=g.device)
    dxb = torch.empty_like(dxf)
    dhg = torch.empty(2, batch, seq, 3 * hidden, dtype=torch.float32,
                      device=g.device)
    entry = bwd_kernel(g.dtype)
    if entry == "bigru_resident_bwd":
        if any(t.data_ptr() % 16 for t in (g, w_f, w_b)):
            # the kernel reads a thread's pool gradients as one vector and
            # W's columns as 32-bit words
            raise ValueError("g, w_f and w_b must start on a 16-byte "
                             "boundary")
        _launch(entry, g, w_f, w_b, lengths, hp, gates, argmax, dxf, dxb,
                dhg, batch, seq, hidden)
    else:
        _launch(entry, g, w_f.t().contiguous(), w_b.t().contiguous(),
                lengths, hp, gates, argmax, dxf, dxb, dhg, batch, seq,
                hidden, int(g.dtype == torch.bfloat16))
    bigru_pooled_bwd.launches += 1
    return dxf, dxb, dhg


class _BigruPooled(torch.autograd.Function):
    """The fused scan with its hand-written gradient.  With ``train`` set
    (grad mode on and an input that needs a gradient) the forward keeps
    what the backward needs (:func:`bigru_pooled_fwd_train`) and the
    backward is :func:`bigru_pooled_bwd`; otherwise the forward is the
    pooled-only scan and saves nothing.  On CUDA tensors both launch
    kernels, on CPU tensors both run the plain versions.  The JAX package
    has no backward kernel: its custom VJP differentiates the XLA scan
    (``gru_pallas.py``, ``bwd``); this computes the same gradient but at
    exact ties (:func:`bigru_pooled_bwd_plain`)."""

    @staticmethod
    def forward(ctx, xf, xb, w_f, w_b, lengths, train):
        if not train:
            if xf.is_cuda:
                return _bigru_pooled_cuda(xf, xb, w_f, w_b, lengths)
            return bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        pooled, *state = bigru_pooled_fwd_train(xf, xb, w_f, w_b, lengths)
        ctx.save_for_backward(w_f, w_b, lengths, *state)
        return pooled

    @staticmethod
    def backward(ctx, g):
        return (*bigru_pooled_bwd(g.contiguous(), *ctx.saved_tensors), None,
                None)


def bigru_pooled_scan(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                      w_b: torch.Tensor, lengths: torch.Tensor,
                      pool_mode: str = "batch",
                      batch_max: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Fused 1-layer bi-GRU: scan both directions and max-pool over valid
    time steps, then apply the zero-participation rule of
    ``models.gru.masked_max_pool`` (``pool_mode`` "batch" or "always").
    Returns ``[B, 2H]`` in the input dtype; differentiable on both paths.

    A CUDA tensor launches ``bigru_pooled_fwd``, or under autograd
    ``bigru_pooled_fwd_train`` (both counted in
    ``bigru_pooled_scan.launches``) and later ``bigru_pooled_bwd``; a CPU
    tensor runs their plain versions.
    """
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xf, xb, w_f, w_b))
    pooled = _BigruPooled.apply(xf, xb, w_f, w_b, lengths, train)
    return zero_participation(pooled, lengths, xf.shape[1], pool_mode,
                              batch_max)


def zero_participation(pooled: torch.Tensor, lengths: torch.Tensor, seq: int,
                       pool_mode: str,
                       batch_max: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Let a zero join the max of every row with a padded position: rows
    shorter than the batch max (``"batch"``; ``batch_max`` when given, the
    global batch's under data parallelism, else ``lengths.max()``) or than
    ``seq`` (``"always"``), as ``models.gru.masked_max_pool`` does."""
    if pool_mode == "batch":
        has_pad = lengths < (lengths.max() if batch_max is None
                             else batch_max)
    elif pool_mode == "always":
        has_pad = lengths < seq
    else:
        raise ValueError(f"Unknown pool mode: {pool_mode}")
    return torch.where(has_pad[:, None], pooled.clamp_min(0.0), pooled)


bigru_pooled_scan.launches = 0
bigru_pooled_bwd.launches = 0


# -- the one-direction scan --------------------------------------------------

def gru_scan_plain(x_gates: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """One direction over precomputed input gates ``[B, T, 3H]`` with the
    recurrent weight ``[H, 3H]`` from ``h0 [B, H]``; every hidden state
    ``[B, T, H]`` in the input dtype, computed in float32.  ``reverse``
    scans the time axis back to front (``out[:, t]`` is still step ``t``'s
    state).  No masking by length.  The kernel computes exactly this; it is
    also the backward's recompute, hence ``unbind`` and ``chunk`` (see
    :func:`bigru_pooled_scan_plain`)."""
    seq = x_gates.shape[1]
    steps = x_gates.float().unbind(1)  # T x [B, 3H]
    w = w_h.float()
    h = h0.float()
    outs = [None] * seq
    for t in (range(seq - 1, -1, -1) if reverse else range(seq)):
        x_r, x_z, x_n = steps[t].chunk(3, dim=-1)
        h_r, h_z, h_n = (h @ w).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * h_n)
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1).to(x_gates.dtype)


def _check_scan_inputs(x_gates, w_h, h0) -> None:
    if x_gates.dim() != 3:
        raise ValueError(f"x_gates must be [B, T, 3H]; got "
                         f"{tuple(x_gates.shape)}")
    batch, seq, three_h = x_gates.shape
    hidden = three_h // 3
    if (three_h != 3 * hidden or hidden % 32 or hidden > 2048 or seq < 1
            or batch < 1):
        raise ValueError(f"gru_scan_fwd needs H % 32 == 0, H <= 2048, "
                         f"T >= 1, B >= 1; got {tuple(x_gates.shape)}")
    if tuple(w_h.shape) != (hidden, three_h):
        raise ValueError(f"w_h must be [{hidden}, {three_h}]; got "
                         f"{tuple(w_h.shape)}")
    if tuple(h0.shape) != (batch, hidden):
        raise ValueError(f"h0 must be [{batch}, {hidden}]; got "
                         f"{tuple(h0.shape)}")
    if x_gates.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_scan_fwd takes f32 or bf16, not {x_gates.dtype}")
    for name, t in (("x_gates", x_gates), ("w_h", w_h), ("h0", h0)):
        if not t.is_cuda or t.device != x_gates.device:
            raise ValueError(f"{name} must be on {x_gates.device}")
        if t.dtype != x_gates.dtype:
            raise TypeError(f"{name} is {t.dtype}, x_gates is {x_gates.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _gru_scan_cuda(x_gates, w_h, h0, reverse) -> torch.Tensor:
    _check_scan_inputs(x_gates, w_h, h0)
    batch, seq, three_h = x_gates.shape
    hidden = three_h // 3
    out = torch.empty(batch, seq, hidden, dtype=x_gates.dtype,
                      device=x_gates.device)
    entry = scan_kernel(x_gates.dtype, hidden)
    if entry == "gru_scan_fwd_resident":
        if any(t.data_ptr() % 16 for t in (x_gates, h0)):
            # the kernel moves each thread's units as one vector
            raise ValueError("x_gates and h0 must start on a 16-byte "
                             "boundary")
        _launch(entry, x_gates, w_h, h0, out, batch, seq, hidden,
                int(bool(reverse)))
    else:
        _launch(entry, x_gates, w_h, h0, out, batch, seq, hidden,
                int(bool(reverse)), int(x_gates.dtype == torch.bfloat16))
    gru_scan.launches += 1
    return out


class _GruScan(torch.autograd.Function):
    """Kernel forward; the backward reruns :func:`gru_scan_plain` on the
    saved inputs with autograd on and backpropagates through it, the
    recompute VJP of ``make_hybrid_scan`` in ``gru_pallas.py`` (in f32, as
    the plain version computes)."""

    @staticmethod
    def forward(ctx, x_gates, w_h, h0, reverse):
        ctx.save_for_backward(x_gates, w_h, h0)
        ctx.reverse = reverse
        return _gru_scan_cuda(x_gates, w_h, h0, reverse)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = gru_scan_plain(*inputs, ctx.reverse)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def gru_scan(x_gates: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """One-direction GRU scan, ``[B, T, 3H]`` -> every hidden state
    ``[B, T, H]`` in the input dtype; differentiable on both paths.

    A CUDA tensor launches the kernel :func:`scan_kernel` names (counted
    in ``gru_scan.launches``, forward launches only); a CPU tensor runs the
    plain version."""
    if x_gates.is_cuda:
        return _GruScan.apply(x_gates, w_h, h0, reverse)
    return gru_scan_plain(x_gates, w_h, h0, reverse)


gru_scan.launches = 0
