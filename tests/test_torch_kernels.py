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

from textreid_torch.ops import gru, ranking

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
def test_deep_gru_on_the_card_names_the_missing_kernel(cuda):
    from textreid_torch.models import BiGRUEncoder

    enc = BiGRUEncoder(hidden_dim=8, vocab_size=20, embed_size=8,
                       num_layers=2).to(cuda)
    ids = torch.ones(2, 5, dtype=torch.long, device=cuda)
    with pytest.raises(NotImplementedError, match="gru_scan_pallas"):
        enc(ids, torch.full((2,), 5, device=cuda))
