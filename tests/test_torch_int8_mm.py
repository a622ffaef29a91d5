"""``textreid_torch/ops/int8_mm.py`` against the JAX package, on the CPU.

The plain versions of K8 and K7 (which the wrappers run on CPU tensors)
against the Pallas kernels ``fused_int8_matmul_requant(..., interpret=True)``
and ``fused_int8_ffn(..., interpret=True, block_rows=32)``, on the same
numpy inputs from fixed seeds, and the ``fused_ffn`` gate of the blocks.

Tolerances: int8 values equal, or one step apart on at most 0.1% of the
elements; row scales rtol 1e-6; K7's f32 output rtol 1e-5 (XLA on the CPU
may contract ``z * r + b`` into an FMA, one ulp), its bf16 output within one
bf16 ulp (2^-7 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textreid_tpu.ops.int8_mm_pallas import (
    fused_int8_ffn as jax_ffn,
    fused_int8_matmul_requant as jax_matmul_requant,
)
from textreid_torch.models.int8_vit import resolve_fused_ffn
from textreid_torch.ops import int8_mm

torch.set_num_threads(2)

STEP_SHARE = 1e-3
SCALE_RTOL = 1e-6


def _site(rows, k, n, seed):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (rows, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s_w = ((rng.rand(n) + 0.1) * 1e-3).astype(np.float32)
    b = (rng.randn(n) * 0.05).astype(np.float32)
    r_row = ((rng.rand(rows, 1) + 0.05) / 127.0).astype(np.float32)
    s_next = ((rng.rand(n) + 0.05) / 127.0).astype(np.float32)
    return xq, wq, s_w, b, r_row, s_next


def _ffn_site(rows, k, n, seed):
    site = _site(rows, k, n, seed)
    rng = np.random.RandomState(seed + 100)
    w2 = rng.randint(-127, 128, (n, k)).astype(np.int8)
    s_w2 = ((rng.rand(k) + 0.1) * 1e-3).astype(np.float32)
    b2 = (rng.randn(k) * 0.05).astype(np.float32)
    return site + (w2, s_w2, b2)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _agree(got, want):
    q, r = got[0].numpy(), got[1].numpy()
    wq, wr = np.asarray(want[0]), np.asarray(want[1])
    assert q.dtype == np.int8 and q.shape == wq.shape and r.shape == wr.shape
    step = np.abs(q.astype(np.int32) - wq.astype(np.int32))
    assert step.max() <= 1 and (step > 0).mean() <= STEP_SHARE
    np.testing.assert_allclose(r, wr, rtol=SCALE_RTOL)


@pytest.mark.parametrize("rows", [64, 37])
@pytest.mark.parametrize("op", ["gelu", "none"])
def test_matmul_requant_matches_the_pallas_kernel(op, rows):
    site = _site(rows, 128, 256, seed=rows + len(op))
    want = jax_matmul_requant(jnp.asarray(site[0]), *site[1:], op=op,
                              block_rows=32, interpret=True)
    got = int8_mm.fused_int8_matmul_requant(*_torch(site), op=op)
    _agree(got, want)
    assert got[1].shape == (rows, 1)


def test_matmul_requant_keeps_the_leading_shape_and_takes_a_transposed_weight():
    xq, wq, s_w, b, r_row, s_next = _site(12, 128, 128, seed=5)
    want = jax_matmul_requant(jnp.asarray(xq), wq, s_w, b, r_row, s_next,
                              block_rows=32, interpret=True)
    w_t = torch.from_numpy(np.ascontiguousarray(wq.T))  # [N, K], as a tower
    q, r = int8_mm.fused_int8_matmul_requant(
        torch.from_numpy(xq).reshape(3, 4, 128), w_t.T, *_torch((s_w, b)),
        torch.from_numpy(r_row).reshape(3, 4, 1), torch.from_numpy(s_next))
    assert q.shape == (3, 4, 128) and r.shape == (3, 4, 1)
    _agree((q.reshape(12, 128), r.reshape(12, 1)), want)


@pytest.mark.parametrize("rows", [70, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_the_pallas_kernel(dtype, rows):
    site = _ffn_site(rows, 128, 256, seed=11 + rows)
    want = jax_ffn(jnp.asarray(site[0]), *site[1:],
                   out_dtype=getattr(jnp, dtype), block_rows=32,
                   interpret=True)
    got = int8_mm.fused_int8_ffn(*_torch(site),
                                 out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, 128)
    want = np.asarray(want.astype(jnp.float32))
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5)


def test_int_matmul_is_the_exact_integer_product():
    xq, wq = _site(9, 128, 64, seed=7)[:2]
    acc = int8_mm.int_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))


def test_int8_matmul_casts_before_the_bias():
    xq, wq, s_w, b, r_row, _ = _site(8, 128, 64, seed=8)
    y = int8_mm.int8_matmul(*_torch((xq, wq, s_w, b, r_row)),
                            out_dtype=torch.bfloat16)
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    want = (torch.from_numpy(acc * s_w * r_row).to(torch.bfloat16)
            + torch.from_numpy(b).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def test_unknown_op_raises():
    site = _site(4, 128, 128, seed=9)
    with pytest.raises(ValueError, match="op must be one of"):
        int8_mm.fused_int8_matmul_requant(*_torch(site), op="ln")


def test_cpu_tensors_launch_nothing():
    before = (int8_mm.fused_int8_matmul_requant.launches,
              int8_mm.fused_int8_ffn.launches)
    site = _ffn_site(4, 128, 128, seed=10)
    int8_mm.fused_int8_matmul_requant(*_torch(site[:6]))
    int8_mm.fused_int8_ffn(*_torch(site))
    assert (int8_mm.fused_int8_matmul_requant.launches,
            int8_mm.fused_int8_ffn.launches) == before


def test_shared_memory_of_the_towers_fits_the_card():
    """K7's cluster tile at both towers' FFN shapes: a 64-row tile over 4
    and 6 blocks within the card's 227 KB (the f32 middle slice, the int8
    input, the consumer scales and the row statistics; the s32 partials and
    the int8 middle reuse the first two); 32 rows where 64 do not fit; a
    refusal where no tile fits and on a shape the split does not take.
    K8's 16-row tile fits at the ViT's c_fc (its plan: the next test)."""
    assert int8_mm.ffn_shared_bytes(512, 2048, 512, 64) == 174848
    assert int8_mm.ffn_shared_bytes(768, 3072, 768, 64) == 191232
    assert int8_mm.ffn_plan(512, 2048, 512) == (4, 64)
    assert int8_mm.ffn_plan(768, 3072, 768) == (6, 64)
    assert int8_mm.ffn_shared_bytes(2048, 2048, 512, 64) > int8_mm.SMEM_MAX
    assert int8_mm.ffn_plan(2048, 2048, 512) == (4, 32)
    assert int8_mm.ffn_plan(64, 64, 64) == (1, 64)
    with pytest.raises(ValueError, match="shared memory"):
        int8_mm.ffn_plan(16384, 2048, 512)
    with pytest.raises(ValueError, match="K % 64"):
        int8_mm.ffn_plan(32, 128, 32)
    with pytest.raises(ValueError, match="M / C"):
        int8_mm.ffn_plan(512, 2048, 1024)  # 256 output columns a block
    assert int8_mm.shared_bytes(768, 3072) <= int8_mm.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        int8_mm._check_dims("fused_int8_matmul_requant", 4096, 4096)


def _cluster_ffn(xq, w1, s_w1, b1, r_row, s_mid, w2, s_w2, b2, blocks, rng,
                 out_dtype):
    """K7 as the cluster kernel decomposes it, in numpy (integers) and f32
    elementwise torch steps: block c's middle columns from its slice of w1,
    its partial row maxima of |xn| merged in a shuffled order, its slice
    rounded with the merged row scale, and the exact s32 partial sums
    ``q[:, slice c] @ w2[slice c, :]`` added up in a shuffled order."""
    from textreid_torch.ops.requant import quick_gelu

    n = w1.shape[1]
    s = n // blocks
    cols = [slice(c * s, (c + 1) * s) for c in range(blocks)]
    xn, part_max = [], []
    for c in cols:
        acc = xq.astype(np.int64) @ w1[:, c].astype(np.int64)
        y = torch.from_numpy(acc.astype(np.int32)).float() * torch.from_numpy(
            s_w1[c].copy())
        y = y * torch.from_numpy(r_row) + torch.from_numpy(b1[c].copy())
        x_c = quick_gelu(y) * torch.reciprocal(torch.from_numpy(
            s_mid[c].copy()))
        xn.append(x_c)
        part_max.append(x_c.abs().amax(dim=-1, keepdim=True))
    order = rng.permutation(blocks)
    m = part_max[order[0]]
    for c in order[1:]:
        m = torch.maximum(m, part_max[c])
    r = m.clamp_min(1e-6) * (1.0 / 127.0)
    total = np.zeros((xq.shape[0], w2.shape[1]), np.int64)
    for c in rng.permutation(blocks):
        v = xn[c] * torch.reciprocal(r)
        v = v + torch.where(v >= 0, 0.5, -0.5)
        q = v.clamp(-127.0, 127.0).to(torch.int8).numpy()
        total += q.astype(np.int64) @ w2[cols[c], :].astype(np.int64)
    z = torch.from_numpy(total.astype(np.int32)).float() * torch.from_numpy(
        s_w2)
    z = z * r
    return z.to(out_dtype) + torch.from_numpy(b2).to(out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(37, 2048), (130, 2048), (37, 3072),
                                    (130, 3072)])
def test_cluster_decomposition_equals_the_plain_ffn(rows, n, out_dtype):
    """The cluster kernel's arithmetic (C = N / 512 blocks, the middle
    split by columns, the row max exchanged, the second product summed by
    slices) equals ``int8_ffn_plain`` bit for bit: a max and integer sums
    are exact in any order."""
    k = n // 4
    site = _ffn_site(rows, k, n, seed=rows + n)
    blocks = n // 512
    got = _cluster_ffn(*site, blocks, np.random.RandomState(rows), out_dtype)
    want = int8_mm.int8_ffn_plain(*_torch(site), out_dtype=out_dtype)
    assert int8_mm.ffn_plan(k, n, k) == (blocks, 64)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_matmul_plan_of_the_towers():
    """K8 at both towers' c_fc goes to the cluster kernel: 16 blocks of 192
    (ViT) or 128 (text) columns, two consumers with 3 or 8 stages each,
    within the card's 227 KB; shapes it does not take go to the 16-row
    kernel, and shapes neither takes raise."""
    vit, text = int8_mm.matmul_plan(768, 3072), int8_mm.matmul_plan(512, 2048)
    assert vit == ("cluster", 16, 192, 64, 3, 216456)
    assert text == ("cluster", 16, 128, 64, 8, 215848)
    for plan, (k, n) in ((vit, (768, 3072)), (text, (512, 2048))):
        assert plan.cluster * plan.cols == n and plan.smem <= int8_mm.SMEM_MAX
        assert plan.smem == int8_mm.matmul_shared_bytes(k, plan.cols,
                                                        plan.cluster,
                                                        plan.stages)
        # one stage more would not fit, unless the plan is at the cap
        assert (plan.stages == int8_mm.MM_STAGES_MAX
                or int8_mm.matmul_shared_bytes(k, plan.cols, plan.cluster,
                                               plan.stages + 1)
                > int8_mm.SMEM_MAX)
    # K not a multiple of 128, N not split by 192 or 128 into <= 16, W's
    # slice past the budget: the 16-row kernel
    for k, n in ((64, 64), (192, 512), (768, 1088), (1024, 3072)):
        assert int8_mm.matmul_plan(k, n) == (
            "rows16", 1, n, 16, 0, int8_mm.shared_bytes(k, n))
    assert int8_mm.matmul_plan(768, 768) == (
        "cluster", 4, 192, 64, 4, int8_mm.matmul_shared_bytes(768, 192, 4, 4))
    with pytest.raises(ValueError, match="shared memory"):
        int8_mm.matmul_plan(512, 4096)
    with pytest.raises(ValueError, match="K % 64"):
        int8_mm.matmul_plan(96, 256)


def test_both_k8_entry_points_take_the_same_arguments():
    """The wrapper hands either library entry the same arguments."""
    from textreid_torch.ops import _build

    assert (_build.SIGNATURES["int8_matmul_requant"]
            == _build.SIGNATURES["int8_matmul_requant_rows16"])


@pytest.mark.parametrize("kernel", ["k7", "k8", "k9"])
def test_every_variant_edits_text_of_its_source(kernel):
    """``tools/int8_variants.py`` builds each variant by replacing text of
    the kernel's source: every text it replaces is in that source, once per
    edit at least, and the entry point it times is a signature of the
    library (the variants build only on the card, so a stale edit would show
    only there)."""
    from textreid_torch.ops import _build
    from textreid_torch.tools import int8_variants

    source, entry, table, *_ = int8_variants.KERNELS[kernel]
    text = (_build.CSRC / source).read_text()
    assert "as committed" in table and entry in _build.SIGNATURES
    assert f'extern "C" int {entry}(' in text
    for name, edits in table.items():
        for old, new in edits:
            assert old in text, (name, old)
            assert old != new, name


def _cluster_matmul_requant(xq, wq, s_w, b, r_row, s_next, op, cols, rng):
    """K8 as the cluster kernel decomposes it, in numpy (integers) and f32
    elementwise torch steps: 64-row tiles; block c's columns [c cols, (c +
    1) cols) from its slice of w; each block's partial row maxima of |xn|,
    merged in a shuffled order; each slice rounded with the whole row's
    scale."""
    from textreid_torch.ops.requant import quick_gelu

    rows, n = xq.shape[0], wq.shape[1]
    blocks = n // cols
    q = np.zeros((rows, n), np.int8)
    r = np.zeros((rows, 1), np.float32)
    for t0 in range(0, rows, 64):
        tile = slice(t0, min(t0 + 64, rows))
        xn, part_max = [], []
        for c in range(blocks):
            cs = slice(c * cols, (c + 1) * cols)
            acc = xq[tile].astype(np.int64) @ wq[:, cs].astype(np.int64)
            y = torch.from_numpy(acc.astype(np.int32)).float() * (
                torch.from_numpy(s_w[cs].copy()))
            y = y * torch.from_numpy(r_row[tile]) + torch.from_numpy(
                b[cs].copy())
            if op == "gelu":
                y = quick_gelu(y)
            x_c = y * torch.reciprocal(torch.from_numpy(s_next[cs].copy()))
            xn.append(x_c)
            part_max.append(x_c.abs().amax(dim=-1, keepdim=True))
        order = rng.permutation(blocks)
        m = part_max[order[0]]
        for c in order[1:]:
            m = torch.maximum(m, part_max[c])
        r_t = m.clamp_min(1e-6) * (1.0 / 127.0)
        for c in rng.permutation(blocks):
            v = xn[c] * torch.reciprocal(r_t)
            v = v + torch.where(v >= 0, 0.5, -0.5)
            q[tile, c * cols:(c + 1) * cols] = v.clamp(-127.0, 127.0).to(
                torch.int8).numpy()
        r[tile] = r_t.numpy()
    return torch.from_numpy(q), torch.from_numpy(r)


@pytest.mark.parametrize("op", ["gelu", "none"])
@pytest.mark.parametrize("rows,n", [(37, 2048), (64, 2048), (130, 2048),
                                    (37, 3072), (64, 3072), (130, 3072)])
def test_cluster_decomposition_equals_the_plain_matmul_requant(rows, n, op):
    """K8's cluster kernel arithmetic (the columns split over N / cols
    blocks, each block's row maxima exchanged, each slice rounded with the
    row's scale) equals ``int8_matmul_requant_plain`` bit for bit: a max is
    exact in any order, and every other step is elementwise."""
    k = n // 4
    site = _site(rows, k, n, seed=rows + n + len(op))
    plan = int8_mm.matmul_plan(k, n)
    assert plan.kernel == "cluster" and plan.rows == 64
    got = _cluster_matmul_requant(*site, op, plan.cols,
                                  np.random.RandomState(rows))
    want = int8_mm.int8_matmul_requant_plain(*_torch(site), op=op)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("value,default,want", [
    (None, True, True), (None, False, False), (True, False, True),
    (False, True, False)])
def test_fused_ffn_gate_takes_the_default_or_a_bool(value, default, want):
    assert resolve_fused_ffn(value, default) is want


@pytest.mark.parametrize("value", ["on", 1, 0, "off", "auto"])
def test_fused_ffn_gate_rejects_anything_else(value):
    with pytest.raises(ValueError, match="fused_ffn must be"):
        resolve_fused_ffn(value, True)
