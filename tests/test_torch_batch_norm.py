"""E3 (``textreid_torch/ops/batch_norm.py``): train-mode BatchNorm with its
ReLU and residual add.

On the CPU the entry points run the plain version, held here against the
path ``models/common.py:batch_norm`` keeps for everything the kernels do not
take (``native_batch_norm``, flax's running update, then the add and the
ReLU): outputs, running statistics, frozen statistics and the gradients of
the input, the scale, the bias and the residual.  The tests marked ``gpu``
need a card and skip without one; they hold the kernels against the plain
version at RN50's extreme shapes.  This file imports no JAX, so on a machine
without it the card tests run with:

    python -m pytest -m gpu --noconftest tests/test_torch_batch_norm.py
"""

from __future__ import annotations

import pytest
import torch
from torch import nn

from textreid_torch.models import common
from textreid_torch.ops import batch_norm as bn_ops

torch.set_num_threads(2)

ENTRIES = (bn_ops.bn_fw_stats, bn_ops.bn_fw_apply, bn_ops.bn_bw_reduce,
           bn_ops.bn_bw_elemt)
# relu, residual: the downsample's BatchNorm, the ReLU after one, a
# bottleneck's last BatchNorm with the identity, and the add alone
VARIANTS = ((False, False), (True, False), (True, True), (False, True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from textreid_torch.utils.platform import require_cuda

    return require_cuda("cuda")


def _counts():
    return [f.launches for f in ENTRIES]


def _module(c: int, seed: int, device="cpu") -> nn.BatchNorm2d:
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.to(device).train()


def _inputs(shape, seed, dtype=torch.float32, device="cpu",
            channels_last=True):
    n, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    scale = torch.rand(1, c, 1, 1, generator=g) * 2 + 0.1
    shift = torch.randn(1, c, 1, 1, generator=g)
    x = torch.randn(shape, generator=g) * scale + shift
    r = torch.randn(shape, generator=g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return (x.to(device, dtype).contiguous(memory_format=fmt),
            r.to(device, dtype).contiguous(memory_format=fmt))


def _todays_path(x, bn, relu, residual):
    out = common._batch_norm(x, bn)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("relu,with_res", VARIANTS)
def test_plain_forward_equals_todays_path(relu, with_res, channels_last):
    x, r = _inputs((6, 12, 5, 4), 0, channels_last=channels_last)
    residual = r if with_res else None
    want_bn, got_bn = _module(12, 1), _module(12, 1)
    before = _counts()
    want = _todays_path(x, want_bn, relu, residual)
    got = bn_ops.batch_norm_act(x, got_bn, relu, residual)
    assert _counts() == before  # CPU tensors launch nothing
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the running statistics move as flax's do: towards the biased variance
    torch.testing.assert_close(got_bn.running_mean, want_bn.running_mean,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_bn.running_var, want_bn.running_var,
                               rtol=1e-6, atol=1e-6)
    biased = x.double().var(dim=(0, 2, 3), unbiased=False)
    start = _module(12, 1).running_var.double()
    torch.testing.assert_close(got_bn.running_var.double(),
                               0.9 * start + 0.1 * biased, rtol=1e-6,
                               atol=1e-6)


def test_frozen_statistics_stay_and_the_output_does_not_change():
    x, r = _inputs((4, 16, 3, 5), 2)
    bn = _module(16, 3)
    moved = bn_ops.batch_norm_act(x, _module(16, 3), True, r)
    before = (bn.running_mean.clone(), bn.running_var.clone())
    with common.running_stats_frozen(bn):
        got = bn_ops.batch_norm_act(x, bn, True, r)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    assert torch.equal(got, moved)


@pytest.mark.parametrize("relu,with_res", VARIANTS)
def test_plain_gradients_equal_todays_path(relu, with_res):
    x0, r0 = _inputs((5, 8, 4, 6), 4)
    dy = torch.randn(5, 8, 4, 6, generator=torch.Generator().manual_seed(5))
    grads = []
    for run in (_todays_path, bn_ops.batch_norm_act):
        bn = _module(8, 6)
        x = x0.clone().requires_grad_(True)
        r = r0.clone().requires_grad_(True) if with_res else None
        run(x, bn, relu, r).backward(dy)
        grads.append((x.grad, bn.weight.grad, bn.bias.grad,
                      r.grad if with_res else None))
    for want, got in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_the_plain_backward_is_autograd_of_the_plain_forward():
    """reduce_plain / elemt_plain (the kernels' contract) against autograd
    through stats_plain and apply_plain, the mask read from y."""
    x0, r0 = _inputs((3, 6, 4, 4), 7, dtype=torch.float64)
    bn = _module(6, 8).double()
    dy = torch.randn(x0.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(9))
    x = x0.clone().requires_grad_(True)
    r = r0.clone().requires_grad_(True)
    w = bn.weight.detach().clone().requires_grad_(True)
    b = bn.bias.detach().clone().requires_grad_(True)
    dims = (0, 2, 3)
    mean = x.mean(dims)
    var = (x - bn_ops._c(mean)).square().mean(dims)
    invstd = torch.rsqrt(var + bn.eps)
    y = torch.relu((x - bn_ops._c(mean)) * bn_ops._c(invstd * w)
                   + bn_ops._c(b) + r)
    y.backward(dy)
    stats = torch.stack([mean, invstd, w * invstd, b - mean * w * invstd]
                        ).detach()
    grads = bn_ops.reduce_plain(dy, x0, y.detach(), stats, True)
    dx, g = bn_ops.elemt_plain(dy, x0, y.detach(), stats, grads, True)
    torch.testing.assert_close(grads[0].double(), w.grad, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(grads[1].double(), b.grad, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(dx.double(), x.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g.double(), r.grad)


def test_dispatch_by_the_input():
    """common.batch_norm takes E3 only where takes() holds: never on the
    CPU; and it applies the add and the ReLU itself on today's path."""
    x, r = _inputs((2, 8, 3, 3), 10)
    assert not bn_ops.takes(x)
    before = _counts()
    out = common.batch_norm(x, _module(8, 11), relu=True, residual=r)
    assert _counts() == before
    torch.testing.assert_close(
        out, _todays_path(x, _module(8, 11), True, r))
    bn = _module(8, 11).eval()
    torch.testing.assert_close(
        common.batch_norm(x, bn, relu=True, residual=r),
        torch.relu(common._batch_norm(x, bn) + r))


# -- on the card -------------------------------------------------------------

# RN50's extreme BatchNorms at 384 x 128, batch 128 (the stem's first: C =
# 32 over 128 x 192 x 64 rows; layer4's: C = 2048 over 128 x 24 x 8), f32 at
# layer4's width, and the smallest C of one 16-byte access each dtype
CARD_CASES = [
    ((128, 32, 192, 64), torch.bfloat16),
    ((128, 2048, 24, 8), torch.bfloat16),
    ((6, 8, 7, 5), torch.bfloat16),
    ((16, 2048, 24, 8), torch.float32),
    ((5, 4, 9, 7), torch.float32),
]


def _card_forward(shape, dtype, device, relu, with_res, seed=0):
    x, r = _inputs(shape, seed, dtype, device)
    residual = r if with_res else None
    bn = _module(shape[1], seed + 1, device)
    stats = bn_ops.bn_fw_stats(x, bn.weight, bn.bias, bn)
    y = bn_ops.bn_fw_apply(x, stats, relu, residual)
    return x, residual, bn, stats, y


def _close_to_sum(got, want, terms, what):
    """f32 sums in another order: within 1e-5 of the sum of |terms|."""
    err = (got - want).abs()
    bound = 1e-5 * terms + 1e-30
    assert bool((err <= bound).all()), (
        f"{what}: worst {(err / bound).max().item():.3g} of its bound")


@pytest.mark.gpu
@pytest.mark.parametrize("relu,with_res", VARIANTS[:3])
@pytest.mark.parametrize("shape,dtype", CARD_CASES)
def test_e3_forward_matches_plain(cuda, shape, dtype, relu, with_res):
    x, residual, bn, stats, y = _card_forward(shape, dtype, cuda, relu,
                                              with_res)
    plain_bn = _module(shape[1], 1, cuda)
    want, var = bn_ops.stats_plain(x, plain_bn.weight, plain_bn.bias,
                                   plain_bn.eps)
    bn_ops.running_update_plain(plain_bn, want[0], var)
    torch.cuda.synchronize()
    std = var.sqrt()
    assert bool(((stats[0] - want[0]).abs()
                 <= 1e-5 * (std + want[0].abs())).all())
    torch.testing.assert_close(stats[1], want[1], rtol=1e-4, atol=0)
    torch.testing.assert_close(bn.running_mean, plain_bn.running_mean,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_var, plain_bn.running_var,
                               rtol=1e-4, atol=1e-6)
    # given the kernel's statistics the output is the plain one bit for bit
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, bn_ops.apply_plain(x, stats, relu, residual))


@pytest.mark.gpu
@pytest.mark.parametrize("relu,with_res", VARIANTS[:3])
@pytest.mark.parametrize("shape,dtype", CARD_CASES)
def test_e3_backward_matches_plain(cuda, shape, dtype, relu, with_res):
    x, residual, bn, stats, y = _card_forward(shape, dtype, cuda, relu,
                                              with_res)
    mask_y = y if relu and with_res else None
    g = torch.Generator().manual_seed(3)
    dy = torch.randn(shape, generator=g).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    grads = bn_ops.bn_bw_reduce(dy, x, mask_y, stats, relu)
    dx, gk = bn_ops.bn_bw_elemt(dy, x, mask_y, stats, grads, relu, True,
                                True)
    want = bn_ops.reduce_plain(dy, x, mask_y, stats, relu)
    torch.cuda.synchronize()
    gp = bn_ops._masked(dy, x, mask_y, stats, relu)
    dims = (0, 2, 3)
    xm = (x.float() - bn_ops._c(stats[0])).abs()
    n = x.numel() // x.shape[1]
    abs_g = gp.abs().sum(dims)
    abs_gx = (gp.abs() * xm).sum(dims)
    _close_to_sum(grads[1], want[1], abs_g, "d bias")
    _close_to_sum(grads[0], want[0], abs_gx * stats[1], "d weight")
    _close_to_sum(grads[2], want[2], abs_g / n, "sum g / n")
    _close_to_sum(grads[3], want[3], abs_gx * stats[1] ** 2 / n,
                  "invstd^2 sum g (x - mean) / n")
    # the masked gradient bit for bit; dx within a rounding of x's dtype
    assert torch.equal(gk, gp.to(dtype))
    dx_plain, _ = bn_ops.elemt_plain(dy, x, mask_y, stats, grads, relu)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    scale = (bn_ops._c(stats[2]).abs() * (gp.abs() + bn_ops._c(grads[2].abs())
             + xm * bn_ops._c(grads[3].abs())))
    assert bool(((dx.float() - dx_plain.float()).abs()
                 <= ulp * dx_plain.float().abs() + 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", CARD_CASES[:2])
def test_e3_is_bit_equal_across_calls_and_counts_two_launches_a_way(
        cuda, shape, dtype):
    x, r = _inputs(shape, 12, dtype, cuda)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(13)).to(
        cuda, dtype).contiguous(memory_format=torch.channels_last)
    runs = []
    for _ in range(2):
        bn = _module(shape[1], 14, cuda)
        xg = x.clone().requires_grad_(True)
        rg = r.clone().requires_grad_(True)
        before = _counts()
        y = common.batch_norm(xg, bn, relu=True, residual=rg)
        fw = [a - b for a, b in zip(_counts(), before)]
        y.backward(dy)
        bw = [a - b for a, b in zip(_counts(), before)]
        assert fw == [1, 1, 0, 0] and bw == [1, 1, 1, 1]
        runs.append((y, xg.grad, rg.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # under no_grad (the key tower): the forward's two launches alone, the
    # same output; frozen statistics stay bit for bit
    bn = _module(shape[1], 14, cuda)
    before = _counts()
    with torch.no_grad(), common.running_stats_frozen(bn):
        y = common.batch_norm(x, bn, relu=True, residual=r)
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 0, 0]
    assert torch.equal(y, runs[0][0])
    fresh = _module(shape[1], 14, cuda)
    assert torch.equal(bn.running_mean, fresh.running_mean)
    assert torch.equal(bn.running_var, fresh.running_var)


@pytest.mark.gpu
@pytest.mark.parametrize("relu,with_res", VARIANTS)
def test_e3_through_common_matches_todays_path(cuda, relu, with_res):
    """The kernels in f32 against native_batch_norm + the add + the ReLU
    on the card (TF32 plays no part: no product here)."""
    shape = (16, 256, 12, 8)
    x0, r0 = _inputs(shape, 15, torch.float32, cuda)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(16)).to(
        cuda).contiguous(memory_format=torch.channels_last)
    runs = []
    for fused in (False, True):
        bn = _module(shape[1], 17, cuda)
        x = x0.clone().requires_grad_(True)
        r = r0.clone().requires_grad_(True) if with_res else None
        before = _counts()
        y = (common.batch_norm(x, bn, relu, r) if fused
             else _todays_path(x, bn, relu, r))
        y.backward(dy)
        assert (_counts() != before) == fused
        runs.append((y, x.grad, bn.weight.grad, bn.bias.grad,
                     r.grad if with_res else None, bn.running_mean,
                     bn.running_var))
    for want, got in zip(*runs):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset", [
    ((6, 20, 7, 5), torch.bfloat16, 0),  # C not a multiple of 8
    ((5, 6, 9, 7), torch.float32, 0),  # C not a multiple of 4
    ((4, 64, 6, 5), torch.bfloat16, 1),  # x 2 bytes off a 16-byte address
])
def test_e3_leaves_what_it_does_not_take_on_todays_path(cuda, shape, dtype,
                                                        offset):
    """A C that is not a multiple of one 16-byte access, or an x off a
    16-byte address, keeps common.batch_norm's eager path (no launch, the
    eager result); the launching entry points refuse it with a message."""
    n, c, h, w = shape
    x0, r = _inputs(shape, 18, dtype, cuda)
    store = torch.empty(x0.numel() + offset, dtype=dtype, device=cuda)
    x = store[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    x.copy_(x0)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert not bn_ops.takes(x)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(19)).to(
        cuda, dtype)
    runs = []
    for fused in (False, True):
        bn = _module(c, 20, cuda)
        xg = x.detach().requires_grad_(True)  # the same storage and offset
        before = _counts()
        y = (common.batch_norm(xg, bn, relu=True, residual=r) if fused
             else _todays_path(xg, bn, True, r))
        y.backward(dy)
        assert _counts() == before
        runs.append((y, xg.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var))
    for want, got in zip(*runs):
        torch.testing.assert_close(got, want)
    bn = _module(c, 20, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bn_ops.bn_fw_stats(x, bn.weight, bn.bias, bn)
