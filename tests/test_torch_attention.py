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


# -- the launch plan: what csrc/fused_attention.cu launches for a shape -------

PLAN_SEQS = [1, 16, 77, 100, 193, 257, 288]


@pytest.mark.parametrize("head_dim", A.HEAD_DIMS)
@pytest.mark.parametrize("seq", PLAN_SEQS)
def test_bf16_launch_plan(seq, head_dim):
    """bf16: one block per (head, sample), one launch each way, no scratch
    in device memory, whole groups of 16-key tiles staged, and every
    kernel within the shared memory a block may use."""
    batch, heads = 5, 3
    plan = A.launch_plan(batch, seq, heads, head_dim, torch.bfloat16)
    live = -(-seq // 16)
    assert plan["key_tiles"] == min(n for n in (7, 13, 18) if n >= live)
    assert plan["s_pad"] % 16 == 0 and plan["s_pad"] >= seq
    assert plan["s_pad"] // 16 <= plan["key_tiles"]
    assert plan["s_pad"] // 16 - live < A.TILE_GROUP
    assert plan["s_pad"] // 16 % A.TILE_GROUP == 0 or (
        plan["s_pad"] // 16 == plan["key_tiles"])
    assert plan["scratch_floats"] == 0
    (fwd,), (bwd,) = plan["fwd"], plan["bwd"]
    assert fwd["grid"] == bwd["grid"] == (heads, batch)
    assert fwd["smem"] == 3 * plan["s_pad"] * head_dim * 2
    assert bwd["smem"] == 4 * plan["s_pad"] * head_dim * 2 + 12 * plan["s_pad"]
    assert fwd["threads"] == 128
    assert bwd["threads"] == (256 if plan["key_tiles"] == 18 else 128)
    for launch in (fwd, bwd):
        assert launch["smem"] <= A.SMEM_LIMIT == 232_448


def test_bf16_plan_fits_two_blocks_an_sm_at_the_vit_shape():
    """S=193, head_dim 64: 80 KB forward and 109 KB backward, so two blocks
    share an SM's 228 KB (1 KB of it reserved per block)."""
    plan = A.launch_plan(128, 193, 12, 64, torch.bfloat16)
    assert plan["s_pad"] == 208 and plan["key_tiles"] == 13
    assert plan["fwd"][0]["smem"] == 79_872
    assert plan["bwd"][0]["smem"] == 108_992
    for launch in (plan["fwd"][0], plan["bwd"][0]):
        assert 2 * (launch["smem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("head_dim", A.HEAD_DIMS)
@pytest.mark.parametrize("seq", PLAN_SEQS)
def test_f32_launch_plan_is_the_first_version(seq, head_dim):
    """f32 keeps the FP32-core kernels: a block per 64-row query tile, rows
    padded to 32 at an odd-word stride, two backward launches that share a
    [B, H, S, 4] scratch."""
    batch, heads = 5, 3
    plan = A.launch_plan(batch, seq, heads, head_dim, torch.float32)
    s_pad = -(-seq // 32) * 32
    staged = 2 * s_pad * (head_dim + 1) * 4
    grid = (-(-seq // 64), heads, batch)
    assert plan["s_pad"] == s_pad
    assert plan["scratch_floats"] == batch * heads * seq * 4
    assert plan["fwd"] == [{"grid": grid, "threads": 256,
                            "smem": staged + 64 * head_dim * 4}]
    assert [b["smem"] for b in plan["bwd"]] == [
        staged + 2 * 64 * head_dim * 4,
        staged + 2 * 64 * head_dim * 4 + 3 * s_pad * 4]
    assert all(b["grid"] == grid and b["smem"] <= A.SMEM_LIMIT
               for b in plan["bwd"])


def test_launch_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="f32 or bf16"):
        A.launch_plan(1, 8, 1, 32, torch.float16)


def test_plan_constants_match_the_cuda_source():
    """The plan mirrors constants of the .cu file; hold them together."""
    import re
    from pathlib import Path

    src = (Path(A.__file__).parent.parent / "csrc"
           / "fused_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kKeyTile") == A.KEY_TILE
    assert const("kTileGroup") == A.TILE_GROUP
    assert const("kChunks") * 32 == A.S_MAX == A.KEY_TILE_COUNTS[-1] * 16
    for tiles in A.KEY_TILE_COUNTS:
        assert f"launch_fwd_mma<D, {tiles}>" in src
        assert f"launch_bwd_mma<D, {tiles}, " in src
    # every bf16 product is an mma on the tensor cores, every copy async
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cp.async.cg.shared.global" in src
    assert "<__nv_bfloat16, 64>" not in src  # no second bf16 path


class _FakeLibrary:
    """Records the arguments of the C entry points; launches nothing."""

    def __init__(self):
        self.calls = []

    def fused_attention_fwd(self, *args):
        self.calls.append(("fwd", args))
        return 0

    def fused_attention_bwd(self, *args):
        self.calls.append(("bwd", args))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The CUDA-side wrappers on CPU tensors: the checks that need a card
    are bypassed and the library is a recorder."""
    import contextlib
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(A, "_check", lambda *a, **k: None)
    monkeypatch.setattr(A._build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    counts = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    yield lib
    A.fused_attention.launches, A.fused_attention_bwd.launches = counts


def test_bf16_backward_allocates_no_stats(fake_card, monkeypatch):
    """K6 in bf16 hands the library a null scratch pointer and allocates
    one tensor, the gradient; in f32 the two launches still share one."""
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a) or
                        real_empty(*a, **k))
    qkv = torch.zeros(2, 20, 3 * 64, dtype=torch.bfloat16)
    g = torch.zeros(2, 20, 64, dtype=torch.bfloat16)
    out = A._fused_attention_bwd_cuda(qkv, g, 2, True, None)
    (name, args), = fake_card.calls
    assert name == "bwd" and args[3] is None and made == []
    assert args[:3] == (qkv.data_ptr(), g.data_ptr(), out.data_ptr())
    assert args[4:11] == (2, 20, 64, 2, 32 ** -0.5, 1, 1)
    assert out.shape == qkv.shape and out.dtype == torch.bfloat16

    fake_card.calls.clear()
    A._fused_attention_bwd_cuda(qkv.float(), g.float(), 2, False, 0.5)
    (name, args), = fake_card.calls
    assert args[3] is not None and made == [(2 * 2 * 20 * 4,)]
    assert args[8:11] == (0.5, 0, 0)


def test_each_wrapper_call_is_one_counted_launch(fake_card):
    qkv = torch.zeros(1, 5, 3 * 32, dtype=torch.bfloat16)
    g = torch.zeros(1, 5, 32, dtype=torch.bfloat16)
    before = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    A._fused_attention_cuda(qkv, 1, False, None)
    A._fused_attention_bwd_cuda(qkv, g, 1, False, None)
    assert [name for name, _ in fake_card.calls] == ["fwd", "bwd"]
    assert (A.fused_attention.launches,
            A.fused_attention_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shape,heads,dtype,error,match", [
    ((1, 289, 3 * 64), 1, torch.bfloat16, ValueError, "S <= 288"),
    ((2, 5, 3 * 96), 2, torch.bfloat16, ValueError, "head_dim"),
    ((2, 5, 3 * 96), 2, torch.float32, ValueError, "head_dim"),
    ((2, 5, 3 * 64), 2, torch.float16, TypeError, "f32 or bf16"),
    ((2, 5, 64), 2, torch.bfloat16, ValueError, "3\\*heads"),
    ((5, 3 * 64), 2, torch.bfloat16, ValueError, "qkv \\[B, S, 3W\\]"),
])
def test_check_refuses_what_the_kernels_do_not_take(shape, heads, dtype,
                                                    error, match):
    with pytest.raises(error, match=match):
        A._check("fused_attention_fwd", torch.zeros(shape, dtype=dtype),
                 heads)


def test_check_refuses_a_cpu_tensor_and_mixed_dtypes():
    qkv = torch.zeros(2, 5, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be on"):
        A._check("fused_attention_fwd", qkv, 2)
    g = torch.zeros(2, 5, 64)
    with pytest.raises(TypeError, match="g is torch.float32"):
        A._fused_attention_bwd_cuda(qkv, g, 2, False, None)
    with pytest.raises(ValueError, match="g must be"):
        A._fused_attention_bwd_cuda(qkv, g.bfloat16()[:, :4], 2, False, None)
    with pytest.raises(ValueError, match="must be on"):
        A._fused_attention_bwd_cuda(qkv, g.bfloat16(), 2, False, None)
