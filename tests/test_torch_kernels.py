"""The hand-written CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` need a card and skip without one.  This file
imports no JAX, so on a machine without it the card tests run with:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

The unmarked tests run anywhere: on CPU tensors the wrappers take the plain
path and launch nothing.
"""

import math

import numpy as np
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


@pytest.mark.parametrize("kind", ranking.KINDS)
@pytest.mark.parametrize("dim", [256, 768])
@pytest.mark.parametrize("n_rows", [100, 3074, 98304])
@pytest.mark.parametrize("n_q", [1, 8, 256])
def test_topk_plan_fits_and_fills_the_card(n_q, n_rows, dim, kind):
    """K2's and K4's plan: a block fits 227 KB with 3-6 ring stages, the
    grid is one wave, and one query puts every SM to work once the gallery
    has 16 rows an SM."""
    sms = 132
    plan = ranking.topk_plan(n_q, n_rows, dim, sms, kind)
    assert plan.smem_bytes <= ranking.SMEM_MAX
    assert ranking.MIN_STAGES <= plan.stages <= ranking.MAX_STAGES
    assert plan.smem_bytes == ranking._shared_bytes(kind, plan.q_tile, dim,
                                                    plan.stages)
    assert plan.q_tile in ranking.Q_TILES and plan.q_tile <= max(8, 2 * n_q)
    blocks = -(-n_q // plan.q_tile) * plan.splits
    assert 1 <= plan.splits <= n_rows and blocks <= sms
    if n_q == 1:
        assert plan.q_tile == 8
        assert blocks == (sms if n_rows >= 16 * sms else -(-n_rows // 16))


@pytest.mark.parametrize("n_q,n_rows,dim,kind,want", [
    (1, 3074, 256, "f32", (8, 132, 6)),      # a lone /search
    (1, 98304, 256, "int8", (8, 132, 6)),
    (256, 98304, 256, "f32", (64, 33, 3)),   # the gallery streamed 4 times
    (256, 98304, 256, "int8", (32, 16, 5)),  # tensor cores: 32 at most
    (64, 98304, 256, "f32", (32, 66, 5)),    # 64 only from 256 queries
    (256, 3074, 256, "f32", (32, 13, 5)),    # splits of >= 256 rows
    (256, 100, 256, "bf16", (8, 4, 6)),      # too few rows: 8-query tiles
    (256, 98304, 768, "f32", (32, 16, 3)),   # wide rows: a smaller tile
    (256, 98304, 1024, "f32", (32, 16, 3)),  # past 768: staged in slices,
    (256, 98304, 4096, "int8", (32, 16, 4)),  # the plan of 768
    (1, 3074, 1024, "bf16", (8, 132, 6)),
])
def test_topk_plan(n_q, n_rows, dim, kind, want):
    assert ranking.topk_plan(n_q, n_rows, dim, 132, kind)[:3] == want
    if dim > ranking.SLICE_COLS:
        assert ranking.topk_plan(n_q, n_rows, dim, 132, kind) == \
            ranking.topk_plan(n_q, n_rows, ranking.SLICE_COLS, 132, kind)


def test_every_topk_variant_edits_text_of_its_source():
    """``tools/topk_variants.py`` patches ``csrc/topk_similarity.cu`` by
    text: each edit of each variant, and of the clock64 breakdown, must
    find its text once."""
    from textreid_torch.ops import _build
    from textreid_torch.tools import topk_variants

    text = (_build.CSRC / "topk_similarity.cu").read_text()
    edits = [e for v in topk_variants.VARIANTS.values() for e in v]
    for old, new in edits + topk_variants.BREAKDOWN:
        assert text.count(old) == 1, old
        assert new != old


@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("n_q", [1, 3, 24])
@pytest.mark.parametrize("kind", ranking.KINDS)
def test_split_and_merge_of_the_plan_equals_the_plain_topk(kind, n_q, k):
    """The kernel's decomposition (``topk_by_plan``: each split streams its
    128-row tiles into its own top-k against its running k-th entry, then
    the splits' sorted lists are merged) gives the plain version's top-k
    exactly: f32, bf16 and int8 scores, a masked tail, and equal rows on
    either side of a split edge (the larger row first).  12 SMs give 4-12
    splits of 75-225 rows (one or two tiles); k = 16 is more than a split's
    first tile leaves after the threshold."""
    from textreid_torch.ops.quant import QuantizedGallery, quantize_rows
    from textreid_torch.ops.quant import quantized_scores

    n_g, valid = 1000, 900
    plan = ranking.topk_plan(n_q, valid, 32, 12, kind)
    assert plan.splits > 1
    edge = valid // plan.splits
    rng = np.random.RandomState(n_q + k)
    q = torch.from_numpy(rng.randn(n_q, 32).astype(np.float32))
    gal = torch.from_numpy(rng.randn(n_g, 32).astype(np.float32))
    gal[edge] = gal[edge - 1]
    q[0] = gal[edge]
    if kind == "int8":
        quant = quantize_rows(gal)
        scores = quantized_scores(q, QuantizedGallery(quant.values[:valid],
                                                      quant.scales[:valid]))
        want = ranking.topk_similarity_quantized_plain(
            q, quant.values, quant.scales, k, valid)
    else:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        scores = q.to(dtype).float() @ gal[:valid].to(dtype).float().T
        want = ranking.topk_similarity_plain(q, gal, k, valid, dtype)
    vals, idx, inserted = ranking.topk_by_plan(scores, k, plan)
    assert torch.equal(idx, want[1]) and torch.equal(vals, want[0])
    assert idx[0, :2].tolist() == [edge, edge - 1]
    rows = valid / plan.splits
    assert k <= inserted <= rows


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


@pytest.mark.parametrize("batch,capacity,directions,want", [
    # K1, both directions.  One wave either way: 16-row steps are the cheaper
    (1, {32: 8, 16: 8}, 2, (16, 2, 2, 1)),
    (37, {32: 8, 16: 8}, 2, (16, 6, 6, 1)),
    # 1 wave of 32 rows against 2 of 16: a tie goes to 32
    (128, {32: 8, 16: 8}, 2, (32, 8, 8, 1)),
    (256, {32: 8, 16: 8}, 2, (32, 8, 16, 2)),
    (100, {32: 4, 16: 4}, 2, (32, 4, 8, 2)),
    # seven clusters of 16 blocks: 3 waves of 16 rows (48 row-steps) beat
    # 2 of 32 (64); at B=256, 5 of 16 (80) beat 3 of 32 (96)
    (1, {32: 7, 16: 7}, 2, (16, 2, 2, 1)),
    (37, {32: 7, 16: 7}, 2, (16, 6, 6, 1)),
    (128, {32: 7, 16: 7}, 2, (16, 7, 16, 3)),
    (256, {32: 7, 16: 7}, 2, (16, 7, 32, 5)),
    # K3, one direction
    (1, {32: 8, 16: 8}, 1, (16, 1, 1, 1)),
    (37, {32: 8, 16: 8}, 1, (16, 3, 3, 1)),
    (128, {32: 8, 16: 8}, 1, (16, 8, 8, 1)),
    # 1 wave of 32 against 2 of 16: the tie to 32
    (256, {32: 8, 16: 8}, 1, (32, 8, 8, 1)),
    (1, {32: 7, 16: 7}, 1, (16, 1, 1, 1)),
    (37, {32: 7, 16: 7}, 1, (16, 3, 3, 1)),
    # 4 items of 32 in 1 wave against 8 of 16 in 2: a tie, to 32
    (128, {32: 7, 16: 7}, 1, (32, 4, 4, 1)),
    # 16 items of 16 in 3 waves (48) beat 8 of 32 in 2 (64)
    (256, {32: 7, 16: 7}, 1, (16, 7, 16, 3)),
])
def test_resident_plan(batch, capacity, directions, want):
    """The W-resident kernels' row-group plan (``csrc/gru_resident.cuh:
    plan_rows`` computes the same; chip_smoke.py holds the two together on
    the card): (rows a cluster, clusters, items, waves), for K1's two
    directions a launch and K3's one."""
    assert gru.resident_plan(batch, capacity, directions) == want


@pytest.mark.parametrize("dtype,hidden,want", [
    (torch.bfloat16, 512, "gru_scan_fwd_resident"),
    (torch.bfloat16, 32, "gru_scan_fwd_resident"),
    (torch.bfloat16, 544, "gru_scan_fwd"),   # a cluster past 16 blocks
    (torch.bfloat16, 2048, "gru_scan_fwd"),
    (torch.bfloat16, 48, "gru_scan_fwd"),    # not whole 32-unit blocks
    (torch.float32, 512, "gru_scan_fwd"),    # W's f32 slice: no registers
    (torch.float32, 64, "gru_scan_fwd"),
])
def test_gru_scan_dispatch_rule(dtype, hidden, want):
    """K3's choice of kernel is a function of the dtype and H alone."""
    assert gru.scan_kernel(dtype, hidden) == want


def test_bf16_forward_refuses_a_hidden_size_past_its_cluster():
    """The W-resident kernel's cluster has H / 32 blocks, at most 16."""
    x = torch.zeros(2, 3, 3 * 544, dtype=torch.bfloat16)
    w = torch.zeros(544, 3 * 544, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H <= 512"):
        gru._bigru_pooled_cuda(x, x, w, w, torch.ones(2, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 37, 128, 256])
def test_bf16_forwards_match_plain_at_served_and_trained_batches(cuda, batch):
    """K1's W-resident bf16 forward at T=105, H=512 with ragged lengths and
    two empty rows: the pooled-only kernel within 8e-3 of the plain scan
    (after the serving pool rule), the training kernel's pooled output
    within 8e-3 and its saved f32 state within 1e-5 of the plain training
    forward's, its argmax -1 on the empty rows."""
    args = _k1_args(batch, 105, 512, torch.bfloat16, cuda, seed=batch)
    if batch > 2:
        args[4][[1, batch - 2]] = 0
    got = gru.bigru_pooled_scan(*args, pool_mode="always")
    want = gru.zero_participation(gru.bigru_pooled_scan_plain(*args),
                                  args[4], 105, "always")
    pooled, hp, gates, argmax = gru.bigru_pooled_fwd_train(*args)
    p_pooled, p_hp, p_gates, _ = gru.bigru_pooled_fwd_train_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 8e-3
    assert torch.equal(torch.isinf(pooled), torch.isinf(p_pooled))
    finite = torch.isfinite(p_pooled)
    assert (pooled.float() - p_pooled.float())[finite].abs().max() <= 8e-3
    assert (hp - p_hp).abs().max().item() <= 1e-5
    assert (gates - p_gates).abs().max().item() <= 1e-5
    assert bool((argmax[args[4] == 0] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_g,k,valid", [
    (13, 200, 1, 0), (13, 200, 7, 0), (9, 130, 64, 0), (8, 50, 64, 0),
    (17, 300, 10, 250),
    (5, 2000, 10, 0), (9, 5000, 64, 4321),  # gallery splits, one launch
    (1, 3074, 10, 0), (3, 3074, 10, 0), (256, 3074, 10, 0),
    (1, 20000, 64, 19000), (3, 1001, 10, 990), (256, 1001, 64, 990),
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
@pytest.mark.parametrize("dim", [100, 30, 772, 1024, 1600])
@pytest.mark.parametrize("n_q,n_g,k,valid", [
    (1, 3074, 10, 0), (3, 1001, 10, 990), (40, 5000, 64, 4321),
    (256, 3074, 10, 0)])
def test_topk_kernels_rank_any_width(cuda, dim, n_q, n_g, k, valid):
    """K2 (f32 and its bf16 option) and K4 at widths off their multiples
    (the wrappers pad with zero columns) and past the 768 columns they
    stage at once (the sliced instantiation): the plain versions' top-k,
    scores within 1e-5 (f32 sums of up to 1,600 products in another
    order), one launch each."""
    from textreid_torch.ops.quant import quantize_rows

    q, gal = _k2_args(n_q, n_g, cuda, dim=dim)
    quant = quantize_rows(gal)
    for dtype in (torch.float32, torch.bfloat16):
        before = ranking.topk_similarity.launches
        vals, idx = ranking.topk_similarity(q, gal, k, valid, dtype)
        pv, pi = ranking.topk_similarity_plain(q, gal, k, valid, dtype)
        torch.cuda.synchronize()
        assert ranking.topk_similarity.launches == before + 1
        assert (vals - pv).abs().max().item() <= 1e-5
        differ = idx != pi
        assert not differ.any() or (
            vals[differ] - pv[differ]).abs().max().item() <= 1e-5
        assert idx[0, 0].item() == (valid or n_g) - 1 if valid == 0 else True
    before = ranking.topk_similarity_quantized.launches
    vals, idx = ranking.topk_similarity_quantized(
        q, quant.values, quant.scales, k=k, valid_gallery=valid)
    pv, pi = ranking.topk_similarity_quantized_plain(
        q, quant.values, quant.scales, k, valid)
    torch.cuda.synchronize()
    assert ranking.topk_similarity_quantized.launches == before + 1
    assert ((vals - pv).abs() <= 1e-5 * pv.abs() + 1e-6).all()
    differ = idx != pi
    assert not differ.any() or ((vals[differ] - pv[differ]).abs()
                                <= 1e-5 * pv[differ].abs() + 1e-6).all()
    padded = ranking.pad_columns(gal, 4)  # a gallery padded once
    got = ranking.topk_similarity(q, padded, k, valid)
    want = ranking.topk_similarity(q, gal, k, valid)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_g,k,valid", [
    (13, 200, 7, 0), (17, 300, 10, 250), (9, 5000, 64, 4321),
    (1, 3074, 10, 0), (3, 1001, 10, 990), (256, 3074, 10, 0)])
def test_topk_kernel_bf16_compute_matches_plain(cuda, n_q, n_g, k, valid):
    """``compute_dtype=bfloat16``: the kernel rounds both operands as it
    stages them; scores within 1e-5 of the plain version's, and other than
    the f32 scores."""
    q, gal = _k2_args(n_q, n_g, cuda)
    vals, idx = ranking.topk_similarity(q, gal, k, valid, torch.bfloat16)
    pv, pi = ranking.topk_similarity_plain(q, gal, k, valid, torch.bfloat16)
    fv, _ = ranking.topk_similarity(q, gal, k, valid)
    torch.cuda.synchronize()
    assert (vals - pv).abs().max().item() <= 1e-5
    assert (vals[idx != pi] - pv[idx != pi]).abs().max().item() <= 1e-5 \
        if (idx != pi).any() else True
    assert (vals - fv).abs().max().item() > 1e-5
    with pytest.raises(TypeError, match="compute_dtype"):
        ranking.topk_similarity(q, gal, k, valid, torch.float16)


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
def test_topk_wrappers_refuse_bad_inputs_on_the_card(cuda):
    """K2's and K4's wrappers: k past 64, a wrong dtype, a view that is not
    contiguous or not 16-byte aligned, widths that differ; and their entry
    points (the wrappers pad D to it) D off its multiple."""
    from textreid_torch.ops.quant import quantize_rows

    q, gal = _k2_args(3, 40, cuda)
    quant = quantize_rows(gal)
    f32 = ranking.topk_similarity
    int8 = ranking.topk_similarity_quantized
    with pytest.raises(ValueError, match="k <= 64"):
        f32(q, gal, k=65)
    with pytest.raises(ValueError, match="k <= 64"):
        int8(q, quant.values, quant.scales, k=0)
    with pytest.raises(ValueError, match="D % 4"):
        ranking._topk_cuda(q[:, :30].contiguous(),
                           gal[:, :30].contiguous(), 3, 0)
    with pytest.raises(ValueError, match="D % 16"):
        ranking._topk_quantized_cuda(q[:, :24].contiguous(),
                                     quant.values[:, :24].contiguous(),
                                     quant.scales, 3, 0)
    with pytest.raises(ValueError, match="queries"):
        f32(q[:, :20].contiguous(), gal, k=3)
    with pytest.raises(TypeError, match="int8"):
        int8(q, gal, quant.scales, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        f32(q, gal.t().contiguous().t(), k=3)
    with pytest.raises(ValueError, match="aligned"):
        f32(q, torch.zeros(41 * 32 + 1, device=cuda)[1:].view(41, 32), k=3)
    with pytest.raises(ValueError, match="scales"):
        int8(q, quant.values, quant.scales[:-1], k=3)


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


def _k3_args(batch, hidden, dtype, device, seed, seq=105):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, seq, 3 * hidden, generator=g) * 0.6
    w = (torch.rand(hidden, 3 * hidden, generator=g) * 2 - 1) / math.sqrt(
        hidden)
    h0 = torch.randn(batch, hidden, generator=g) * 0.5
    return [t.to(device=device, dtype=dtype) for t in (x, w, h0)]


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch", [1, 37, 128, 256])
def test_resident_gru_scan_matches_plain(cuda, batch, reverse):
    """K3's W-resident bf16 kernel at T=105, H=512 with a non-zero h0 in
    both orders, within 8e-3 of the plain scan (f32 inside, one bf16
    rounding of each stored h_t: 2 ulp below 1.0), one launch; its plan is
    the library's."""
    import ctypes

    from textreid_torch.ops import _build

    args = _k3_args(batch, 512, torch.bfloat16, cuda, seed=batch)
    assert gru.scan_kernel(torch.bfloat16, 512) == "gru_scan_fwd_resident"
    before = gru.gru_scan.launches
    got = gru.gru_scan(*args, reverse=reverse)
    want = gru.gru_scan_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_scan.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (batch, 105, 512)
    assert (got.float() - want.float()).abs().max().item() <= 8e-3
    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(_build.library().gru_scan_resident_plan(
        batch, 512, *map(ctypes.byref, out)), "gru_scan_resident_plan")
    rows, clusters, cap32, cap16 = (v.value for v in out)
    assert (rows, clusters) == gru.resident_plan(
        batch, {32: cap32, 16: cap16}, directions=1)[:2]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [37, 256])
def test_f32_gru_scan_stays_on_the_streamed_kernel(cuda, batch):
    """f32 runs the streamed kernel (W's f32 slice does not fit the
    registers), within 1e-5 of the plain scan: the same f32 math in another
    summation order."""
    args = _k3_args(batch, 512, torch.float32, cuda, seed=batch)
    assert gru.scan_kernel(torch.float32, 512) == "gru_scan_fwd"
    got = gru.gru_scan(*args, reverse=True)
    want = gru.gru_scan_plain(*args, reverse=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


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
    (5, 4000, 10, 0), (9, 9000, 64, 4321),  # gallery splits, one launch
    (1, 3074, 10, 0), (3, 3074, 10, 0), (256, 3074, 10, 0),
    (1, 20000, 64, 19000), (3, 1001, 10, 990), (256, 1001, 64, 990),
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
    (2, 77, 512, 8, True), (1, 288, 128, 2, True), (2, 1, 64, 1, False),
    # the shapes that stress the tensor-core tiling: the served text bucket,
    # the longest S, one token, a ragged S at head_dim 32, one sample
    (256, 100, 512, 8, True), (16, 288, 768, 12, False),
    (16, 288, 768, 12, True), (8, 257, 256, 8, False), (4, 1, 128, 2, False),
    (4, 1, 64, 2, True), (8, 45, 256, 8, True), (8, 45, 256, 8, False),
    (1, 193, 768, 12, False)])
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
def test_attention_function_bf16_vit_shape_on_the_card(cuda):
    """``attention.attention`` under autograd at S=193 in bf16: the output
    is K5's, the gradient K6's, both within the bf16 tolerance of the plain
    versions, one launch each."""
    qkv, g = _qkv_args(4, 193, 768, torch.bfloat16, cuda, seed=2)
    qkv.requires_grad_(True)
    before = (attention.fused_attention.launches,
              attention.fused_attention_bwd.launches)
    out = attention.attention(qkv, 12)
    (got,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert (attention.fused_attention.launches,
            attention.fused_attention_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    pairs = ((out.detach(), attention.fused_attention_plain(qkv.detach(), 12)),
             (got, attention.fused_attention_bwd_plain(qkv.detach(), g, 12)))
    for have, want in pairs:
        assert have.dtype == torch.bfloat16 and have.shape == want.shape
        err = (have.float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[torch.bfloat16] * max(
            1.0, want.float().abs().max().item())


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
    """K1's autograd Function: the training forward and the backward kernel
    once each; gradients equal autograd through the plain version (f32,
    1e-5: the same f32 math in another summation order; 6 x 128 (row,
    unit) maxima, so no near-tie between the two forwards)."""
    args = _k1_args(6, 12, 64, torch.float32, cuda)
    g = torch.randn(6, 128, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    before = (gru.bigru_pooled_scan.launches, gru.bigru_pooled_bwd.launches)
    out = gru.bigru_pooled_scan(*leaves, args[4], pool_mode="batch")
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (gru.bigru_pooled_scan.launches,
            gru.bigru_pooled_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    ref = gru.zero_participation(
        gru.bigru_pooled_scan_plain(*ref_leaves, args[4]), args[4], 12,
        "batch")
    want = torch.autograd.grad(ref, ref_leaves, g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


# K1's backward against its plain version on the same saved state, over the
# plain gradient's largest magnitude: f32 sums of 3H products a step in
# another order (dW: then summed over B T rows); bf16 one rounding of each
# result, which may land one ulp (2^-8 relative) apart
K1_BWD_TOL = {torch.float32: {"dx": 1e-5, "dw": 1e-4},
              torch.bfloat16: {"dx": 8e-3, "dw": 8e-3}}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", [105, 7])
@pytest.mark.parametrize("batch", [128, 37, 8])
def test_bigru_backward_kernel_matches_plain(cuda, dtype, batch, seq):
    """The training forward keeps the plain training forward's state (its
    pooled output the pooled-only kernel's); the backward kernel on that
    state gives the plain backward's gradients.  Ragged
    lengths with a full row; a length-0 row gets zero."""
    hidden = 512
    args = _k1_args(batch, seq, hidden, dtype, cuda, seed=batch + seq)
    args[4][-1] = 0
    g = torch.randn(batch, 2 * hidden,
                    generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    before = (gru.bigru_pooled_scan.launches, gru.bigru_pooled_bwd.launches)
    pooled, hp, gates, argmax = gru.bigru_pooled_fwd_train(*args)
    got = gru.bigru_pooled_bwd(g, args[2], args[3], args[4], hp, gates,
                               argmax)
    torch.cuda.synchronize()
    assert (gru.bigru_pooled_scan.launches,
            gru.bigru_pooled_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(  # -inf on the length-0 row in both
        pooled.float(), gru._bigru_pooled_cuda(*args).float(), rtol=0,
        atol=1e-5 if dtype == torch.float32 else 8e-3)
    plain = gru.bigru_pooled_fwd_train_plain(*args)
    for have, want in zip((hp, gates), plain[1:3]):
        assert (have - want).abs().max().item() <= 1e-5  # f32 states
    assert (argmax[-1] == -1).all()
    want = gru.bigru_pooled_bwd_plain(g, args[2], args[3], args[4], hp, gates,
                                      argmax)
    for key, a, b in zip(("dx", "dx", "dw", "dw"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K1_BWD_TOL[dtype][key] * b.float().abs().max().item()
    for dx in got[:2]:
        assert torch.count_nonzero(dx[-1]) == 0  # the length-0 row
        for b, n in enumerate(args[4].tolist()):
            assert torch.count_nonzero(dx[b, n:]) == 0


@pytest.mark.gpu
def test_bigru_training_wrappers_refuse_bad_inputs_on_the_card(cuda):
    args = _k1_args(2, 3, 544, torch.float32, cuda)  # H > 512
    with pytest.raises(ValueError, match="H <= 512"):
        gru.bigru_pooled_fwd_train(*args)
    args = _k1_args(4, 5, 64, torch.float32, cuda)
    _, hp, gates, argmax = gru.bigru_pooled_fwd_train(*args)
    g = torch.randn(4, 128, device=cuda)
    with pytest.raises(ValueError, match="gates must be"):
        gru.bigru_pooled_bwd(g, args[2], args[3], args[4], hp,
                             gates.bfloat16(), argmax)
    with pytest.raises(ValueError, match="w_f must be"):
        gru.bigru_pooled_bwd(g, args[2].bfloat16(), args[3], args[4], hp,
                             gates, argmax)
    with pytest.raises(ValueError, match="contiguous"):
        gru.bigru_pooled_bwd(g, args[2], args[3], args[4],
                             hp.transpose(2, 3).contiguous().transpose(2, 3),
                             gates, argmax)
    with pytest.raises(ValueError, match="must be on"):
        gru.bigru_pooled_bwd(g, args[2], args[3], args[4].cpu(), hp, gates,
                             argmax)
    with pytest.raises(TypeError, match="f32 or bf16"):
        gru.bigru_pooled_bwd(g.half(), args[2].half(), args[3].half(),
                             args[4], hp, gates, argmax)


# -- K7-K9: the int8 encoders' kernels --------------------------------------

def _int8_site(rows, k, n, device, seed=0, m_out=0):
    g = torch.Generator().manual_seed(seed)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    site = [ints(rows, k), ints(n, k).t(),
            (torch.rand(n, generator=g) + 0.1) * 1e-3,
            torch.randn(n, generator=g) * 0.05,
            (torch.rand(rows, 1, generator=g) + 0.05) / 127.0,
            (torch.rand(n, generator=g) + 0.05) / 127.0]
    if m_out:
        site += [ints(m_out, n).t(),
                 (torch.rand(m_out, generator=g) + 0.1) * 1e-3,
                 torch.randn(m_out, generator=g) * 0.05]
    return [t.to(device) for t in site]


def _int8_agree(got, want, share=1e-3):
    """int8 values equal but for one step on at most ``share`` of the
    elements; row scales rtol 1e-6."""
    step = (got[0].int() - want[0].int()).abs()
    assert got[0].dtype == torch.int8 and step.max().item() <= 1
    assert (step > 0).float().mean().item() <= share
    assert ((got[1] - want[1]).abs() / want[1].abs()).max().item() <= 1e-6


def test_cpu_tensors_of_the_int8_kernels_launch_nothing():
    from textreid_torch.ops import int8_mm, requant

    before = (requant.fused_requant.launches,
              int8_mm.fused_int8_matmul_requant.launches,
              int8_mm.fused_int8_ffn.launches)
    site = _int8_site(5, 64, 64, "cpu", m_out=64)
    q, r = requant.fused_requant(torch.randn(5, 64), site[5], "ln")
    assert q.dtype == torch.int8 and r.shape == (5, 1)
    q, r = int8_mm.fused_int8_matmul_requant(*site[:6])
    assert q.shape == (5, 64) and r.shape == (5, 1)
    assert int8_mm.fused_int8_ffn(*site).shape == (5, 64)
    assert (requant.fused_requant.launches,
            int8_mm.fused_int8_matmul_requant.launches,
            int8_mm.fused_int8_ffn.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["ln", "none", "gelu"])
@pytest.mark.parametrize("rows,c", [(37, 512), (256, 768), (64, 2048),
                                    (64, 3072)])
def test_requant_kernel_matches_plain(cuda, rows, c, op, dtype):
    from textreid_torch.ops import requant

    g = torch.Generator().manual_seed(rows)
    x = (torch.randn(2, rows, c, generator=g) * 1.5 + 0.2).to(cuda, dtype)
    s = ((torch.rand(c, generator=g) + 0.05) / 127.0).to(cuda)
    before = requant.fused_requant.launches
    got = requant.fused_requant(x, s, op)
    want = requant.requant_plain(x, s, op)
    torch.cuda.synchronize()
    assert requant.fused_requant.launches == before + 1
    assert got[0].shape == (2, rows, c) and got[1].shape == (2, rows, 1)
    _int8_agree(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["gelu", "none"])
@pytest.mark.parametrize("rows,k,n", [(37, 512, 2048), (256, 768, 3072),
                                      (5, 64, 64)])
def test_int8_matmul_requant_kernel_matches_plain(cuda, rows, k, n, op):
    from textreid_torch.ops import int8_mm

    site = _int8_site(rows, k, n, cuda, seed=rows)
    before = int8_mm.fused_int8_matmul_requant.launches
    got = int8_mm.fused_int8_matmul_requant(*site, op=op)
    want = int8_mm.int8_matmul_requant_plain(*site, op=op)
    torch.cuda.synchronize()
    assert int8_mm.fused_int8_matmul_requant.launches == before + 1
    _int8_agree(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [(37, 512, 2048), (256, 768, 3072),
                                      (5, 64, 64)])
def test_int8_ffn_kernel_matches_plain(cuda, rows, k, n, dtype):
    """Within four one-step flips of the middle a row (each moves an output
    by at most 127 s_w2 r) plus one rounding of the output dtype."""
    from textreid_torch.ops import int8_mm

    site = _int8_site(rows, k, n, cuda, seed=rows, m_out=k)
    before = int8_mm.fused_int8_ffn.launches
    got = int8_mm.fused_int8_ffn(*site, out_dtype=dtype)
    want = int8_mm.int8_ffn_plain(*site, out_dtype=dtype)
    _, r_mid = int8_mm.int8_matmul_requant_plain(*site[:6], op="gelu")
    torch.cuda.synchronize()
    assert int8_mm.fused_int8_ffn.launches == before + 1
    assert got.dtype == dtype and got.shape == (rows, k)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    allowed = 4 * 127.0 * site[7][None, :] * r_mid + ulp * want.float().abs()
    assert ((got.float() - want.float()).abs() <= allowed).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [(37, 512, 2048), (100, 512, 2048),
                                      (37, 768, 3072), (100, 768, 3072)])
def test_cluster_int8_ffn_equals_the_16_row_kernel(cuda, rows, k, n, dtype):
    """K7's cluster tile (the middle split over N / 512 blocks, row maxima
    and s32 partial sums swapped between them) at both towers' FFNs: the
    same int8 middle and the same integer sums as the 16-row kernel it
    replaced, so the same output bit for bit, and within the allowance of
    test_int8_ffn_kernel_matches_plain of the plain version."""
    from textreid_torch.ops import int8_mm
    from textreid_torch.tools.int8_variants import ffn_rows16

    site = _int8_site(rows, k, n, cuda, seed=rows + k, m_out=k)
    got = int8_mm.fused_int8_ffn(*site, out_dtype=dtype)
    old = ffn_rows16(*site, out_dtype=dtype)
    want = int8_mm.int8_ffn_plain(*site, out_dtype=dtype)
    _, r_mid = int8_mm.int8_matmul_requant_plain(*site[:6], op="gelu")
    torch.cuda.synchronize()
    assert torch.equal(got, old)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    allowed = 4 * 127.0 * site[7][None, :] * r_mid + ulp * want.float().abs()
    assert ((got.float() - want.float()).abs() <= allowed).all()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["gelu", "none"])
@pytest.mark.parametrize("rows,k,n", [(24704, 768, 3072), (25600, 512, 2048),
                                      (37, 512, 2048), (100, 512, 2048),
                                      (37, 768, 3072), (100, 768, 3072)])
def test_cluster_int8_matmul_requant_equals_the_16_row_kernel(cuda, rows, k,
                                                             n, op):
    """K8's cluster kernel (W resident across 16 blocks, wgmma, the row
    maxima swapped between the blocks) at both towers' c_fc: the same
    integer sums and f32 steps as the 16-row kernel, so the same q and r
    bit for bit, and within the gate of the plain version."""
    from textreid_torch.ops import int8_mm
    from textreid_torch.tools.int8_variants import matmul_rows16

    assert int8_mm.matmul_plan(k, n).kernel == "cluster"
    site = _int8_site(rows, k, n, cuda, seed=rows + k)
    before = int8_mm.fused_int8_matmul_requant.launches
    got = int8_mm.fused_int8_matmul_requant(*site, op=op)
    old = matmul_rows16(*site, op=op)
    want = int8_mm.int8_matmul_requant_plain(*site, op=op)
    torch.cuda.synchronize()
    assert int8_mm.fused_int8_matmul_requant.launches == before + 1
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    _int8_agree(got, want)


@pytest.mark.gpu
def test_comparison_wrappers_refuse_bad_inputs_on_the_card(cuda):
    """The 16-row K8, called apart for comparison, checks its inputs as the
    main wrapper does and counts no launch."""
    from textreid_torch.ops import int8_mm
    from textreid_torch.tools.int8_variants import matmul_rows16

    before = int8_mm.fused_int8_matmul_requant.launches
    with pytest.raises(ValueError, match="K % 64"):
        matmul_rows16(*_int8_site(4, 96, 64, cuda))
    site = _int8_site(4, 64, 64, cuda)
    with pytest.raises(ValueError, match="r_row"):
        matmul_rows16(*site[:4], site[4][:2], site[5])
    q, r = matmul_rows16(*site)
    torch.cuda.synchronize()
    assert q.shape == (4, 64) and r.shape == (4, 1)
    assert int8_mm.fused_int8_matmul_requant.launches == before


@pytest.mark.gpu
def test_int8_wrappers_refuse_bad_inputs_on_the_card(cuda):
    from textreid_torch.ops import int8_mm, requant

    with pytest.raises(ValueError, match="C % 4"):
        requant.fused_requant(torch.randn(3, 30, device=cuda),
                              torch.ones(30, device=cuda))
    with pytest.raises(TypeError, match="f32 or bf16"):
        requant.fused_requant(torch.randn(3, 32, device=cuda).half(),
                              torch.ones(32, device=cuda))
    site = _int8_site(4, 96, 64, cuda)  # K % 64 != 0
    with pytest.raises(ValueError, match="K % 64"):
        int8_mm.fused_int8_matmul_requant(*site)
    site = _int8_site(4, 64, 64, cuda, m_out=64)
    with pytest.raises(TypeError, match="f32 or bf16"):
        int8_mm.fused_int8_ffn(*site, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="r_row"):
        int8_mm.fused_int8_matmul_requant(*site[:4], site[4][:2], site[5])
