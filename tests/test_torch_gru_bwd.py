"""K1's backward contract against autograd and against JAX, on the CPU in
float32.

``bigru_pooled_bwd_plain`` (the backward kernel's contract, and the
backward of the CPU path) is held against autograd through
``bigru_pooled_scan_plain`` and against ``jax.vjp`` of the JAX package's
``bigru_pooled_scan`` (its Pallas forward in interpret mode, its XLA
backward), in both pool modes, at tiny shapes with ragged lengths: a full
row, a length-1 row and a length-0 row.  Tolerance atol/rtol 1e-5: the
same float32 arithmetic in another summation order.  Also: the
first-step rule at an exact tie, where autograd and JAX split the
gradient, and what the Function keeps under autograd and under
``no_grad``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.ops.gru_pallas import bigru_pooled_scan as jax_bigru_pooled
from textreid_torch.ops import gru

torch.set_num_threads(2)

T = 7
LENGTHS = {3: np.array([7, 1, 0], np.int32),
           5: np.array([7, 3, 1, 0, 5], np.int32)}


def _inputs(batch, hidden, seed):
    rng = np.random.RandomState(seed)
    xf = (rng.randn(batch, T, 3 * hidden) * 0.6).astype(np.float32)
    xb = (rng.randn(batch, T, 3 * hidden) * 0.6).astype(np.float32)
    w_f = (rng.randn(hidden, 3 * hidden) * 0.3).astype(np.float32)
    w_b = (rng.randn(hidden, 3 * hidden) * 0.3).astype(np.float32)
    g = rng.randn(batch, 2 * hidden).astype(np.float32)
    return (xf, xb, w_f, w_b), LENGTHS[batch], g


def _port_grads(arrays, lengths, g, pool_mode, scan):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    lens = torch.from_numpy(lengths)
    out = scan(*leaves, lens, pool_mode)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(g))


def _autograd_scan(xf, xb, w_f, w_b, lengths, pool_mode):
    pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
    return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode)


@pytest.mark.parametrize("pool_mode", ["batch", "always"])
@pytest.mark.parametrize("batch,hidden", [(5, 32), (3, 64)])
def test_plain_backward_matches_autograd(batch, hidden, pool_mode):
    arrays, lengths, g = _inputs(batch, hidden, seed=batch + hidden)
    out, got = _port_grads(arrays, lengths, g, pool_mode,
                           gru.bigru_pooled_scan)
    ref, want = _port_grads(arrays, lengths, g, pool_mode, _autograd_scan)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for name, a, b in zip(("xf", "xb", "w_f", "w_b"), got, want):
        assert torch.isfinite(a).all(), name
        assert a.abs().max() > 0, name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("pool_mode", ["batch", "always"])
@pytest.mark.parametrize("batch,hidden", [(5, 32), (3, 64)])
def test_plain_backward_matches_jax_vjp(batch, hidden, pool_mode):
    arrays, lengths, g = _inputs(batch, hidden, seed=10 * batch + hidden)
    out, vjp = jax.vjp(
        lambda *a: jax_bigru_pooled(*a, jnp.asarray(lengths), interpret=True,
                                    pool_mode=pool_mode),
        *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g))
    got_out, got = _port_grads(arrays, lengths, g, pool_mode,
                               gru.bigru_pooled_scan)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("xf", "xb", "w_f", "w_b"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_steps_past_the_length_get_exactly_zero():
    arrays, lengths, g = _inputs(5, 32, seed=3)
    _, (dxf, dxb, _, _) = _port_grads(arrays, lengths, g, "always",
                                      gru.bigru_pooled_scan)
    for dx in (dxf, dxb):
        for b, n in enumerate(lengths):
            assert torch.count_nonzero(dx[b, n:]) == 0
            assert (torch.count_nonzero(dx[b, :n]) > 0) == (n > 0)


def _tie_inputs(hidden=32):
    """Gates for which ``h_t = tanh(x_n)`` exactly: ``z = sigmoid(-200)`` is
    0 in float32 and the ``n`` columns of W are zero, so ``h_n = 0``.  Steps
    1 and 3 of row 0 then hold the same, largest value of every unit."""
    rng = np.random.RandomState(4)
    xf = (rng.randn(2, T, 3 * hidden) * 0.3).astype(np.float32)
    xf[:, :, hidden:2 * hidden] = -200.0
    xf[0, 3, 2 * hidden:] = xf[0, 1, 2 * hidden:] = 2.5
    w = (rng.randn(hidden, 3 * hidden) * 0.3).astype(np.float32)
    w[:, 2 * hidden:] = 0.0
    lengths = np.array([T, 5], np.int32)
    g = rng.randn(2, 2 * hidden).astype(np.float32)
    return (xf, xf.copy(), w, w.copy()), lengths, g


def test_an_exact_tie_goes_to_the_first_step():
    """The pool gradient of a unit whose max is reached at steps 1 and 3
    all goes to step 1 (the running max moves only on a strictly greater
    value); autograd through the plain scan splits it 0.5/0.5 (JAX's
    ``jnp.max`` splits evenly too)."""
    hidden = 32
    arrays, lengths, g = _tie_inputs(hidden)
    _, hp, gates, argmax = gru.bigru_pooled_fwd_train_plain(
        *map(torch.from_numpy, arrays), torch.from_numpy(lengths))
    assert (argmax[0] == 1).all()
    h1 = gates[0, 0, 1, 2]  # n of step 1 = h_1, bitwise
    assert torch.equal(h1, hp[0, 0, 4]) and torch.equal(hp[0, 0, 2], h1)

    _, got = _port_grads(arrays, lengths, g, "always", gru.bigru_pooled_scan)
    _, want = _port_grads(arrays, lengths, g, "always", _autograd_scan)
    n_slice = slice(2 * hidden, 3 * hidden)
    full = torch.from_numpy(g[0, :hidden]) * (1.0 - h1 * h1)
    torch.testing.assert_close(got[0][0, 1, n_slice], full)
    assert torch.count_nonzero(got[0][0, 3, n_slice]) == 0
    for t in (1, 3):
        torch.testing.assert_close(want[0][0, t, n_slice], 0.5 * full)


def test_the_function_keeps_state_only_under_autograd(monkeypatch):
    """Under autograd the CPU path runs the training forward and ends in
    ``bigru_pooled_bwd_plain``; under ``no_grad`` it runs the pooled-only
    plain scan, as a frozen key tower does."""
    calls = []
    for name in ("bigru_pooled_fwd_train_plain", "bigru_pooled_bwd_plain",
                 "bigru_pooled_scan_plain"):
        real = getattr(gru, name)
        monkeypatch.setattr(gru, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    arrays, lengths, g = _inputs(5, 32, seed=8)
    with torch.no_grad():
        pooled = gru.bigru_pooled_scan(*map(torch.from_numpy, arrays),
                                       torch.from_numpy(lengths))
    assert calls == ["bigru_pooled_scan_plain"] and pooled.grad_fn is None
    calls.clear()
    _port_grads(arrays, lengths, g, "batch", gru.bigru_pooled_scan)
    assert calls == ["bigru_pooled_fwd_train_plain", "bigru_pooled_bwd_plain"]


def test_the_hidden_limit_is_the_kernels():
    """``MAX_TRAIN_HIDDEN`` mirrors the backward kernel's bound on H (its
    blocks run H / 2 threads under ``__launch_bounds__``)."""
    import re
    from pathlib import Path

    src = (Path(gru.__file__).parent.parent / "csrc" /
           "bigru_pooled_bwd.cu").read_text()
    (limit,) = re.findall(r"constexpr int kBwdMaxHidden = (\d+);", src)
    assert int(limit) == gru.MAX_TRAIN_HIDDEN
    assert "__launch_bounds__(kBwdThreads, 2)" in src
