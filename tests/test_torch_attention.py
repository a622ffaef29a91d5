"""The port's fused attention (``textreid_torch/ops/attention.py``) against
the JAX Pallas kernels, on the CPU.

The plain versions of K5 and K6 (the CUDA kernels' contract) are held
against ``fused_attention`` and ``fused_attention_bwd`` run in interpret
mode, on the same numpy inputs.  Tolerances: f32 1e-5 (same f32
arithmetic, another summation order); bf16 1.6e-2, two bf16 ulps at
values in [1, 2): both sides round p (or ds) and the output to bf16 at
the same points, and a last-bit difference of the f32 sums before a
rounding can move the result by one ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.ops.attention_pallas import (
    fused_attention as jax_fused_attention,
    fused_attention_bwd as jax_fused_attention_bwd,
)
from textreid_torch.ops import attention as A

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# (batch, seq, heads, head_dim): odd S, S=33, one head of 8
SHAPES = [(2, 17, 2, 16), (3, 33, 4, 8), (1, 8, 1, 8)]


def _inputs(batch, seq, heads, head_dim, seed):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(batch, seq, 3 * heads * head_dim) * 0.5).astype(
        np.float32)
    g = rng.randn(batch, seq, heads * head_dim).astype(np.float32)
    return qkv, g


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_the_pallas_kernel(shape, causal, dtype):
    batch, seq, heads, head_dim = shape
    qkv, _ = _inputs(*shape, seed=seq)
    scale = 0.3  # an explicit scale, not head_dim ** -0.5
    want = jax_fused_attention(_jax(qkv, dtype), heads=heads, causal=causal,
                               scale=scale, interpret=True)
    got = A.fused_attention_plain(_torch(qkv, dtype), heads, causal, scale)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (batch, seq, heads * head_dim)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_pallas_kernel(shape, causal, dtype):
    batch, seq, heads, head_dim = shape
    qkv, g = _inputs(*shape, seed=seq + 1)
    scale = 0.3
    want = jax_fused_attention_bwd(_jax(qkv, dtype), _jax(g, dtype),
                                   heads=heads, causal=causal, scale=scale,
                                   interpret=True)
    got = A.fused_attention_bwd_plain(_torch(qkv, dtype), _torch(g, dtype),
                                      heads, causal, scale)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_function_backward_is_autograd_of_the_plain_forward(causal):
    """The autograd Function's CPU path (K6's plain version) against
    autograd through the plain forward, in f32."""
    qkv_np, g_np = _inputs(2, 17, 2, 16, seed=3)
    qkv = torch.from_numpy(qkv_np).requires_grad_(True)
    g = torch.from_numpy(g_np)
    out = A.attention(qkv, 2, causal)
    (got,) = torch.autograd.grad(out, qkv, g)
    ref_in = torch.from_numpy(qkv_np).requires_grad_(True)
    (want,) = torch.autograd.grad(
        A.fused_attention_plain(ref_in, 2, causal), ref_in, g)
    np.testing.assert_allclose(out.detach().numpy(),
                               A.fused_attention_plain(ref_in, 2, causal)
                               .detach().numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_causal_rows_ignore_later_positions():
    qkv_np, _ = _inputs(1, 9, 1, 8, seed=5)
    qkv = torch.from_numpy(qkv_np)
    base = A.fused_attention_plain(qkv, 1, causal=True)
    moved = qkv.clone()
    moved[:, 5:] += 3.0  # rows 0-4 must not see positions 5-8
    out = A.fused_attention_plain(moved, 1, causal=True)
    torch.testing.assert_close(out[:, :5], base[:, :5], atol=0, rtol=0)


def test_misaligned_qkv_raises():
    qkv = torch.zeros(2, 5, 3 * 10)
    with pytest.raises(ValueError, match="3\\*heads"):
        A.fused_attention_plain(qkv, 4)
    with pytest.raises(ValueError, match="3\\*heads"):
        A.attention(qkv, 4)
