"""The plain versions of the int8 trunk's elementwise work
(``textreid_torch/ops/int8_conv.py``) against the JAX package's, on the CPU.

``requant_static`` and ``avg_pool_int8`` equal ``_requant`` and
``_avg_pool_int8`` of ``textreid_tpu/models/int8_tower.py`` bit for bit,
values at exactly +-x.5, negatives and the clip edges included, in f32 and
bf16 (JAX run op by op, so each bf16 result is rounded as eager PyTorch
rounds it).  E1's plain version equals the chain ``int8_trunk_apply``
builds around a convolution, in each of its modes, bit for bit.
``int8_conv2d`` (im2col + the int8 product) equals ``F.conv2d`` on
integer-valued f32 inputs exactly (every sum is an integer below 2^24).
On CPU tensors the wrappers run the plain versions and launch nothing.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from textreid_tpu.models import int8_tower as jax_tower
from textreid_torch.ops import int8_conv
from textreid_torch.ops.int8_conv import (avg_pool_int8, conv_epilogue_plain,
                                          flatten_weight, im2col_int8,
                                          int8_conv2d, requant_static)

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _edge_values(seed, n=4096, scale=300.0):
    """Scaled normal values with exact halves, negatives and values past
    both clip edges mixed in."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(n) * scale / 3).astype(np.float32)
    v[:64] = np.arange(-32, 32) + 0.5
    v[64:80] = [-127.5, 127.5, -128.5, 126.5, 254.5, 253.5, 0.5, -0.5,
                -0.0, 0.0, 300.0, -300.0, 1e6, -1e6, 254.0, -127.0]
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("asym", [False, True])
def test_requant_static_equals_jax_bit_for_bit(dtype, asym):
    tdt, jdt = DTYPES[dtype]
    y = _edge_values(0).reshape(-1, 16)
    scale = np.random.RandomState(1).uniform(0.5, 2.0, 16).astype(np.float32)
    scale[:4] = 1.0  # the exact halves stay exact
    want = np.asarray(jax_tower._requant(jnp.asarray(y, jdt),
                                         jnp.asarray(scale, jdt), asym))
    inv = torch.reciprocal(torch.from_numpy(scale).to(tdt))
    got = requant_static(torch.from_numpy(y).to(tdt), inv, asym)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the edges themselves
    assert got.min().item() == (-128 if asym else -127)
    assert got.max().item() == (126 if asym else 127)


@pytest.mark.parametrize("shape", [(2, 6, 4, 8), (1, 7, 5, 4), (3, 2, 2, 16)])
def test_avg_pool_int8_equals_jax_bit_for_bit(shape):
    rng = np.random.RandomState(2)
    xq = rng.randint(-128, 128, shape).astype(np.int8)
    xq.reshape(-1)[:8] = [-128, -128, -128, -128, 127, 127, 127, 127]
    want = np.asarray(jax_tower._avg_pool_int8(jnp.asarray(xq)))
    got = avg_pool_int8(torch.from_numpy(xq))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_chain(acc, s_w, b, res, s_res, res_mode, relu, scale, out, ep):
    """The chain int8_trunk_apply builds around a convolution, op by op."""
    v = acc.astype(ep) * s_w.astype(ep) + b.astype(ep) if s_w is not None \
        else acc.astype(ep)
    if res_mode == "asym":
        v = v + (res.astype(ep) + jnp.asarray(128.0, ep)) * s_res.astype(ep)
    elif res_mode == "sym":
        v = v + res.astype(ep) * s_res.astype(ep)
    if relu:
        v = jnp.maximum(v, 0)
    if out in ("sym", "asym"):
        return jax_tower._requant(v, scale.astype(ep), out == "asym")
    return v.astype(getattr(jnp, out))


EPILOGUE_MODES = [  # (residual, relu, out): every epilogue of the trunk
    (None, True, "sym"),      # stem, a block's conv1
    (None, True, "asym"),     # a block's conv2, the stem's conv3
    (None, False, "sym"),     # a downsample branch
    ("asym", True, "asym"),   # a block's conv3 on its identity
    ("sym", True, "asym"),    # ... on its downsample branch
    ("asym", True, "float32"),  # the last block
    ("sym", True, "bfloat16"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res_mode,relu,out", EPILOGUE_MODES)
def test_epilogue_equals_the_jax_chain(dtype, res_mode, relu, out):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    m, n = 40, 24
    acc = rng.randint(-60000, 60000, (m, n)).astype(np.int32)
    s_w = rng.uniform(1e-4, 3e-3, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    res = rng.randint(-128, 127, (m, n)).astype(np.int8)
    s_res = rng.uniform(0.01, 0.05, n).astype(np.float32)
    scale = rng.uniform(0.02, 0.2, n).astype(np.float32)
    want = np.asarray(_jax_chain(
        jnp.asarray(acc), jnp.asarray(s_w), jnp.asarray(b), jnp.asarray(res),
        jnp.asarray(s_res), res_mode, relu, jnp.asarray(scale), out,
        jdt).astype(jnp.float32))
    t = torch.from_numpy
    inv = torch.reciprocal(t(scale).to(tdt)).float()
    got = conv_epilogue_plain(t(acc), inv, t(s_w), t(b), t(res), t(s_res),
                              res_mode, relu, out, tdt)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_input_requant_equals_jax(dtype):
    """The pixel quantize and the float -> int8 boundary: a float input,
    no affine."""
    tdt, jdt = DTYPES[dtype]
    x = _edge_values(4, scale=3.0).reshape(-1, 4)
    scale = np.float32([0.02, 0.03, 0.025, 0.5])
    for asym in (False, True):
        want = np.asarray(jax_tower._requant(
            jnp.asarray(x).astype(jdt), jnp.asarray(scale, jdt), asym))
        inv = torch.reciprocal(torch.from_numpy(scale).to(tdt)).float()
        got = int8_conv.int8_conv_epilogue(
            torch.from_numpy(x), inv, out="asym" if asym else "sym", ep=tdt)
        np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = [  # (ci, co, kernel, stride)
    (8, 16, 1, 1), (8, 16, 1, 2), (16, 8, 3, 1), (16, 24, 3, 2),
    (3, 8, 3, 2),  # K = 27, padded to 32 (the stem)
    (3, 16, 7, 2),  # the torchvision stem
    (5, 12, 3, 1),  # K = 45 -> 48, N = 12 -> 16
]


@pytest.mark.parametrize("ci,co,kernel,stride", CONV_CASES)
def test_int8_conv2d_equals_conv2d_on_integers(ci, co, kernel, stride):
    rng = np.random.RandomState(5)
    x = rng.randint(-127, 128, (2, 11, 9, ci)).astype(np.int8)
    w = rng.randint(-127, 128, (co, ci, kernel, kernel)).astype(np.int8)
    pad = kernel // 2
    got = int8_conv2d(torch.from_numpy(x),
                      flatten_weight(torch.from_numpy(w)), (kernel, kernel),
                      (stride, stride), (pad, pad))
    want = F.conv2d(torch.from_numpy(x).float().permute(0, 3, 1, 2),
                    torch.from_numpy(w).float(), stride=stride, padding=pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  want.permute(0, 2, 3, 1).numpy())


def test_im2col_takes_any_strides_and_pads_k():
    """A channels-last view of an NCHW tensor (the interceptor's input)
    unfolds as its contiguous copy does; K's zero columns are zero."""
    x = torch.randint(-127, 128, (2, 3, 6, 5), dtype=torch.int8)
    view = x.permute(0, 2, 3, 1)
    cols = im2col_int8(view, (3, 3), (1, 1), (1, 1))
    assert cols.shape == (2 * 6 * 5, 32)
    assert torch.equal(cols, im2col_int8(view.contiguous(), (3, 3), (1, 1),
                                         (1, 1)))
    assert not cols[:, 27:].any()
    # the centre tap of each output pixel is the pixel itself
    assert torch.equal(cols[:, 4 * 3:5 * 3], view.reshape(-1, 3))


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    before = (int8_conv.int8_conv_epilogue.launches,
              int8_conv.int8_avg_pool.launches)
    acc = torch.randint(-1000, 1000, (6, 8), dtype=torch.int32)
    vec = torch.full((8,), 0.1)
    got = int8_conv.int8_conv_epilogue(acc, vec, vec, vec, relu=True)
    assert torch.equal(got, conv_epilogue_plain(acc, vec, vec, vec,
                                                relu=True))
    xq = torch.randint(-128, 128, (1, 4, 4, 8), dtype=torch.int8)
    assert torch.equal(int8_conv.int8_avg_pool(xq), avg_pool_int8(xq))
    assert (int8_conv.int8_conv_epilogue.launches,
            int8_conv.int8_avg_pool.launches) == before
    with pytest.raises(ValueError, match="out must be"):
        int8_conv.int8_conv_epilogue(acc, vec, vec, vec, out="int8")
    with pytest.raises(ValueError, match="res_mode"):
        int8_conv.int8_conv_epilogue(acc, vec, vec, vec, res_mode="zero")
    with pytest.raises(ValueError, match="f32 or bf16"):
        int8_conv.int8_conv_epilogue(acc, vec, vec, vec, ep=torch.float16)
