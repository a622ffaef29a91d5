"""``textreid_torch/ops/requant.py`` against the JAX package, on the CPU.

The port's plain version of K9 (which ``fused_requant`` runs on a CPU tensor)
against the Pallas kernel ``fused_requant(..., interpret=True)`` and against
the XLA composition it stands for (``_norm_no_affine`` / ``_quick_gelu`` then
``_requant_rowdyn``), on the same numpy inputs from fixed seeds.

Tolerances: the int8 values are equal, or one step apart on at most 0.1% of
the elements (a row sum, an ``exp`` or an ``rsqrt`` that differs in its last
bit moves a value that lies on a rounding boundary); the row scales agree to
rtol 1e-6 (a few f32 ulps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.models.int8_vit import (
    _norm_no_affine,
    _quick_gelu,
    _requant_rowdyn,
)
from textreid_tpu.ops.quant_pallas import fused_requant as jax_fused_requant
from textreid_torch.ops import requant

torch.set_num_threads(2)

STEP_SHARE = 1e-3
SCALE_RTOL = 1e-6
SEEDS = {"ln": 1, "gelu": 2, "none": 3}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + 0.2).astype(np.float32)
    s = ((rng.rand(shape[-1]) + 0.05) / 127.0).astype(np.float32)
    return x, s


def _agree(got, want):
    q, r = got[0].numpy(), got[1].numpy()
    wq, wr = np.asarray(want[0]), np.asarray(want[1])
    assert q.dtype == np.int8 and q.shape == wq.shape and r.shape == wr.shape
    step = np.abs(q.astype(np.int32) - wq.astype(np.int32))
    assert step.max() <= 1
    assert (step > 0).mean() <= STEP_SHARE
    np.testing.assert_allclose(r, wr, rtol=SCALE_RTOL)


def _composition(x, s, op):
    xj = jnp.asarray(x)
    if op == "ln":
        xj = _norm_no_affine(xj)
    elif op == "gelu":
        xj = _quick_gelu(xj.astype(jnp.float32))
    return _requant_rowdyn(xj.astype(jnp.float32), jnp.asarray(s))


@pytest.mark.parametrize("rows", [32, 37])
@pytest.mark.parametrize("op", ["ln", "gelu", "none"])
def test_plain_matches_the_pallas_kernel(op, rows):
    x, s = _inputs((rows, 128), SEEDS[op] + rows)
    got = requant.fused_requant(torch.from_numpy(x), torch.from_numpy(s), op)
    _agree(got, jax_fused_requant(jnp.asarray(x), s, op=op, interpret=True))
    assert got[1].shape == (rows, 1)


@pytest.mark.parametrize("op", ["ln", "gelu", "none"])
def test_plain_matches_the_xla_composition(op):
    x, s = _inputs((24, 128), SEEDS[op] + 10)
    got = requant.requant_plain(torch.from_numpy(x), torch.from_numpy(s), op)
    _agree(got, _composition(x, s, op))


@pytest.mark.parametrize("op", ["ln", "gelu", "none"])
def test_bf16_input_is_cast_up_first(op):
    x, s = _inputs((16, 128), SEEDS[op] + 20)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = requant.fused_requant(xb, torch.from_numpy(s), op)
    want = jax_fused_requant(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), s, op=op, interpret=True)
    _agree(got, want)


def test_leading_shape_is_kept():
    x, s = _inputs((2, 5, 128), 31)
    q, r = requant.fused_requant(torch.from_numpy(x), torch.from_numpy(s),
                                 "ln")
    assert q.shape == (2, 5, 128) and r.shape == (2, 5, 1)
    _agree((q, r), jax_fused_requant(jnp.asarray(x), s, op="ln",
                                     interpret=True))


def test_unknown_op_raises():
    x, s = _inputs((4, 128), 32)
    with pytest.raises(ValueError, match="op must be one of"):
        requant.fused_requant(torch.from_numpy(x), torch.from_numpy(s), "relu")
    with pytest.raises(ValueError, match="op must be one of"):
        requant.requant_plain(torch.from_numpy(x), torch.from_numpy(s), "LN")


def test_rounding_is_half_away_from_zero_and_floored():
    """Exact halves round away from zero, the clip holds, and an all-zero
    row takes the 1e-6 floor of the row scale."""
    s = torch.ones(4)
    x = torch.tensor([[127.0, 63.5, -63.5, 0.4], [0.0, 0.0, 0.0, 0.0]])
    q, r = requant.requant_plain(x, s, "none")
    assert q[0].tolist() == [127, 64, -64, 0]
    assert q[1].tolist() == [0, 0, 0, 0]
    np.testing.assert_allclose(r[:, 0].numpy(), [1.0, 1e-6 / 127.0],
                               rtol=1e-6)


def test_cpu_tensors_launch_nothing():
    before = requant.fused_requant.launches
    x, s = _inputs((4, 128), 33)
    requant.fused_requant(torch.from_numpy(x), torch.from_numpy(s), "ln")
    assert requant.fused_requant.launches == before


def _register_ln_requant(x, s, vec, eps=1e-5):
    """The LayerNorm requant as the register design orders it, in numpy
    f32: lane l of a warp owns the 16-byte pieces (32 j + l) vec on, sums
    its channels four at a time ((a + b) + (c + d)) piece after piece, the
    warp adds the 32 partial sums by a butterfly of xor shuffles; the rsqrt
    is numpy's, not the card's rsqrtf."""
    f32 = np.float32
    rows, c = x.shape
    loads = -(-c // (32 * vec))
    idx = (np.arange(loads)[None, :, None] * 32
           + np.arange(32)[:, None, None]) * vec + np.arange(vec)
    live = idx < c
    v = np.where(live[None], x[:, np.minimum(idx, c - 1)], f32(0))
    sums = np.zeros((rows, 32), f32)
    for j in range(loads):
        for e in range(0, vec, 4):
            quad = v[:, :, j, e:e + 4]
            sums = sums + ((quad[..., 0] + quad[..., 1])
                           + (quad[..., 2] + quad[..., 3]))

    def warp_sum(part):
        for o in (16, 8, 4, 2, 1):
            part = part + part[:, np.arange(32) ^ o]
        return part[:, :1]

    mean = warp_sum(sums) / f32(c)
    sq = np.zeros((rows, 32), f32)
    for j in range(loads):
        for e in range(0, vec, 4):
            d = v[:, :, j, e:e + 4] - mean[:, :, None]
            d = np.where(live[None, :, j, e:e + 4], d, f32(0))
            sq = sq + ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                       + (d[..., 2] * d[..., 2] + d[..., 3] * d[..., 3]))
    var = warp_sum(sq) / f32(c)
    rstd = f32(1) / np.sqrt(var + f32(eps))
    xn = ((x - mean) * rstd) * (f32(1) / s)
    r = np.maximum(np.abs(xn).max(axis=1, keepdims=True), f32(1e-6)) * f32(
        1.0 / 127.0)
    t = xn * (f32(1) / r)
    t = t + np.where(t >= 0, f32(0.5), f32(-0.5))
    return np.clip(t, -127, 127).astype(np.int8), r.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [512, 768])
def test_register_design_order_agrees_with_the_plain_version(c, dtype):
    """The register design sums a row in another order than torch (its own
    lane mapping, 8 bf16 or 4 f32 channels a piece): its LayerNorm requant
    still agrees with ``requant_plain`` within the gate."""
    x, s = _inputs((48, c), 40 + c)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    vec = 8 if dtype == "bfloat16" else 4
    got = _register_ln_requant(xt.float().numpy(), s, vec)
    want = requant.requant_plain(xt, torch.from_numpy(s), "ln")
    _agree((torch.from_numpy(got[0]), torch.from_numpy(got[1])), want)
