"""The hand-written CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` need a card and skip without one.  This file
imports no JAX, so on a machine without it the card tests run with:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

The unmarked tests run anywhere: on CPU tensors the wrappers take the plain
path and launch nothing.
"""

import math

import pytest
import torch

from textreid_torch.ops import attention, gru, ranking

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from textreid_torch.utils.platform import require_cuda

    return require_cuda("cuda")


def _k1_args(batch, seq, hidden, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xf, xb = (torch.randn(batch, seq, 3 * hidden, generator=g) * 0.6
              for _ in range(2))
    w_f, w_b = ((torch.rand(hidden, 3 * hidden, generator=g) * 2 - 1)
                / math.sqrt(hidden) for _ in range(2))
    lengths = torch.randint(1, seq + 1, (batch,), generator=g,
                            dtype=torch.int32)
    lengths[0] = seq
    return [t.to(device=device, dtype=dtype if t.is_floating_point()
                 else t.dtype) for t in (xf, xb, w_f, w_b, lengths)]


def _k2_args(n_q, n_g, device, dim=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(n_q, dim, generator=g), dim=1)
    gal = torch.nn.functional.normalize(torch.randn(n_g, dim, generator=g),
                                        dim=1)
    gal[n_g - 1] = gal[0]  # an exact tie: row n_g-1 must rank above row 0
    q[0] = gal[0]
    return q.to(device), gal.to(device)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    before = (gru.bigru_pooled_scan.launches, ranking.topk_similarity.launches)
    args = _k1_args(3, 5, 8, torch.float32, "cpu")
    out = gru.bigru_pooled_scan(*args, pool_mode="always")
    assert out.shape == (3, 16)
    q, gal = _k2_args(4, 30, "cpu")
    vals, idx = ranking.topk_similarity(q, gal, k=5)
    assert idx[0, 0] == 29 and idx[0, 1] == 0  # the tie, larger row first
    assert (gru.bigru_pooled_scan.launches,
            ranking.topk_similarity.launches) == before


def test_cpu_tensors_of_the_scan_and_the_int8_topk_launch_nothing():
    from textreid_torch.ops.quant import quantize_rows

    before = (gru.gru_scan.launches,
              ranking.topk_similarity_quantized.launches)
    x, _, w, _, _ = _k1_args(3, 5, 8, torch.float32, "cpu")
    out = gru.gru_scan(x, w, torch.zeros(3, 8), reverse=True)
    assert out.shape == (3, 5, 8)
    q, gal = _k2_args(4, 30, "cpu")
    quant = quantize_rows(gal)
    vals, idx = ranking.topk_similarity_quantized(q, quant.values,
                                                  quant.scales, k=5)
    assert idx[0, 0] == 29 and idx[0, 1] == 0  # the tie, larger row first
    assert (gru.gru_scan.launches,
            ranking.topk_similarity_quantized.launches) == before


def test_gallery_splits_of_the_int8_tile():
    # 128-row tiles: 98,304 rows are 768 tiles, 3,074 rows are 25
    assert ranking.gallery_splits(256, 98304, 132, 128) == 8
    assert ranking.gallery_splits(256, 3074, 132, 128) == 6
    assert ranking.gallery_splits(256, 400, 132, 128) == 1


@pytest.mark.parametrize("n_q,n_rows,sms,want", [
    (256, 3074, 132, 8),     # Q=256: 32 query tiles, ~2 blocks per SM
    (256, 98304, 132, 8),
    (5, 2000, 132, 8),       # 32 tiles: 4 per split
    (5, 700, 132, 2),        # at least 4 tiles of 64 rows per split
    (256, 100, 132, 1),      # a small gallery is not split
])
def test_gallery_splits(n_q, n_rows, sms, want):
    assert ranking.gallery_splits(n_q, n_rows, sms) == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("batch,seq,hidden", [(5, 9, 64), (64, 105, 512)])
def test_bigru_kernel_matches_plain(cuda, dtype, tol, batch, seq, hidden):
    args = _k1_args(batch, seq, hidden, dtype, cuda)
    before = gru.bigru_pooled_scan.launches
    got = gru.bigru_pooled_scan(*args, pool_mode="batch")
    want = gru.zero_participation(gru.bigru_pooled_scan_plain(*args),
                                  args[4], seq, "batch")
    torch.cuda.synchronize()
    assert gru.bigru_pooled_scan.launches == before + 1
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_g,k,valid", [
    (13, 200, 1, 0), (13, 200, 7, 0), (9, 130, 64, 0), (8, 50, 64, 0),
    (17, 300, 10, 250),
    (5, 2000, 10, 0), (9, 5000, 64, 4321),  # gallery split + merge kernel
])
def test_topk_kernel_matches_plain(cuda, n_q, n_g, k, valid):
    q, gal = _k2_args(n_q, n_g, cuda)
    before = ranking.topk_similarity.launches
    vals, idx = ranking.topk_similarity(q, gal, k=k, valid_gallery=valid)
    pv, pi = ranking.topk_similarity_plain(q, gal, k, valid)
    torch.cuda.synchronize()
    assert ranking.topk_similarity.launches == before + 1
    assert (vals - pv).abs().max().item() <= 1e-5
    assert torch.equal(idx, pi)


@pytest.mark.gpu
def test_wrappers_refuse_bad_inputs_on_the_card(cuda):
    args = _k1_args(2, 3, 48, torch.float32, cuda)  # H % 32 != 0
    with pytest.raises(ValueError, match="H % 32"):
        gru.bigru_pooled_scan(*args)
    q, gal = _k2_args(3, 10, cuda)
    with pytest.raises(ValueError, match="k <= 64"):
        ranking.topk_similarity(q, gal, k=65)
    with pytest.raises(TypeError, match="float32"):
        ranking.topk_similarity(q.double(), gal.double(), k=3)


@pytest.mark.gpu
def test_deep_gru_on_the_card_launches_both_kernels(cuda):
    """A 2-layer encoder on the card: the one-direction scan twice for
    layer 0, the fused scan once for layer 1, and the CPU's result."""
    from textreid_torch.models import BiGRUEncoder

    enc = BiGRUEncoder(hidden_dim=32, vocab_size=20, embed_size=8,
                       num_layers=2).eval()
    ids = torch.randint(1, 20, (5, 9))
    lengths = torch.tensor([9, 3, 1, 5, 7])
    with torch.no_grad():
        want = enc(ids, lengths)
        before = (gru.gru_scan.launches, gru.bigru_pooled_scan.launches)
        got = enc.to(cuda)(ids.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert (gru.gru_scan.launches, gru.bigru_pooled_scan.launches) == (
        before[0] + 2, before[1] + 1)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("batch,seq,hidden,reverse", [
    (5, 9, 64, False), (13, 9, 32, True), (128, 105, 512, False)])
def test_gru_scan_kernel_matches_plain(cuda, dtype, tol, batch, seq, hidden,
                                       reverse):
    x, _, w, _, _ = _k1_args(batch, seq, hidden, dtype, cuda)
    h0 = (torch.randn(batch, hidden, generator=torch.Generator().manual_seed(1))
          * 0.5).to(device=cuda, dtype=dtype)
    before = gru.gru_scan.launches
    got = gru.gru_scan(x, w, h0, reverse=reverse)
    want = gru.gru_scan_plain(x, w, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == (batch, seq, hidden)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_gru_scan_function_has_the_plain_gradient_on_the_card(cuda):
    x, _, w, _, _ = _k1_args(6, 9, 64, torch.float32, cuda)
    h0 = torch.randn(6, 64, device=cuda) * 0.5
    g = torch.randn(6, 9, 64, device=cuda)
    grads = []
    for scan in (gru.gru_scan, gru.gru_scan_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, h0)]
        grads.append(torch.autograd.grad(scan(*leaves, reverse=True), leaves,
                                         g))
    for a, b in zip(*grads):
        assert b.abs().max().item() > 0
        assert (a - b).abs().max().item() <= 1e-5 * max(
            1.0, b.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_g,k,valid", [
    (13, 200, 1, 0), (13, 200, 7, 0), (9, 130, 64, 0), (8, 50, 64, 0),
    (17, 300, 10, 250),
    (5, 4000, 10, 0), (9, 9000, 64, 4321),  # gallery split + merge kernel
])
def test_quantized_topk_kernel_matches_plain(cuda, n_q, n_g, k, valid):
    from textreid_torch.ops.quant import quantize_rows

    q, gal = _k2_args(n_q, n_g, cuda)
    quant = quantize_rows(gal)
    before = ranking.topk_similarity_quantized.launches
    vals, idx = ranking.topk_similarity_quantized(
        q, quant.values, quant.scales, k=k, valid_gallery=valid)
    pv, pi = ranking.topk_similarity_quantized_plain(
        q, quant.values, quant.scales, k, valid)
    torch.cuda.synchronize()
    assert ranking.topk_similarity_quantized.launches == before + 1
    assert ((vals - pv).abs() <= 1e-5 * pv.abs() + 1e-6).all()
    assert torch.equal(idx, pi)  # dim 32: the sums are exact in f32


def _qkv_args(batch, seq, width, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(batch, seq, 3 * width, generator=g)
    grad = torch.randn(batch, seq, width, generator=g)
    return qkv.to(device, dtype), grad.to(device, dtype)


# relative to the plain version's largest magnitude: f32 sums in another
# order; bf16 one rounding of the output (or of p, ds) that may land one
# ulp (2^-8 relative) apart
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,seq,width,heads,causal", [
    (3, 17, 64, 2, False), (2, 33, 128, 4, True), (4, 193, 768, 12, False),
    (2, 77, 512, 8, True), (1, 288, 128, 2, True), (2, 1, 64, 1, False)])
def test_attention_kernels_match_plain(cuda, dtype, batch, seq, width,
                                       heads, causal):
    qkv, g = _qkv_args(batch, seq, width, dtype, cuda)
    before = (attention.fused_attention.launches,
              attention.fused_attention_bwd.launches)
    out = attention.fused_attention(qkv, heads, causal)
    dqkv = attention.fused_attention_bwd(qkv, g, heads, causal)
    want = attention.fused_attention_plain(qkv, heads, causal)
    want_d = attention.fused_attention_bwd_plain(qkv, g, heads, causal)
    torch.cuda.synchronize()
    assert (attention.fused_attention.launches,
            attention.fused_attention_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    for got, ref in ((out, want), (dqkv, want_d)):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype] * max(1.0, ref.float().abs().max().item())


@pytest.mark.gpu
def test_attention_function_on_the_card(cuda):
    """Forward K5, backward K6, through autograd."""
    qkv, g = _qkv_args(2, 50, 128, torch.float32, cuda, seed=1)
    qkv.requires_grad_(True)
    (got,) = torch.autograd.grad(attention.attention(qkv, 2), qkv, g)
    want = attention.fused_attention_bwd_plain(qkv.detach(), g, 2)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())


@pytest.mark.gpu
def test_attention_wrappers_refuse_bad_inputs_on_the_card(cuda):
    qkv, g = _qkv_args(2, 5, 96, torch.float32, cuda)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        attention.fused_attention(qkv, 2)
    qkv, g = _qkv_args(1, 289, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="S <= 288"):
        attention.fused_attention(qkv, 1)
    qkv, g = _qkv_args(2, 5, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="g is"):
        attention.fused_attention_bwd(qkv, g.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(qkv.transpose(0, 1).contiguous()
                                  .transpose(0, 1), 2)


@pytest.mark.gpu
def test_bigru_function_gradients_on_the_card(cuda):
    """K1's autograd Function: gradients equal autograd through the plain
    version (f32, 1e-5: the same recompute, another summation order in the
    forward only)."""
    args = _k1_args(6, 12, 64, torch.float32, cuda)
    g = torch.randn(6, 128, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    out = gru.bigru_pooled_scan(*leaves, args[4], pool_mode="batch")
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    ref = gru.zero_participation(
        gru.bigru_pooled_scan_plain(*ref_leaves, args[4]), args[4], 12,
        "batch")
    want = torch.autograd.grad(ref, ref_leaves, g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5
