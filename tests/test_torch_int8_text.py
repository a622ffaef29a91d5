"""The port's int8-dataflow CLIP text transformer (``models/int8_text.py``)
against the JAX package's, on the CPU in f32: 2 layers, width 128, 4 heads,
12 positions, a 50-token vocabulary.  Same inputs, converters and tolerances
as ``test_torch_int8_vit.py``: folded float graph 1e-4; calibration abs-max
rtol 1e-5; ``w_q`` equal but for one step on at most 0.1% of the weights,
``s_w``, ``b``, scales rtol 1e-6; int8 against float cosine >= 0.999;
identical quantized weights give the JAX embeddings to cosine >= 0.9999 and
2% of the largest entry (one-step flips of int8 activations that lie on a
rounding boundary).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models import int8_text as jax_int8
from textreid_tpu.models.text_transformer import (
    TextTransformer as JaxTextTransformer,
)
from textreid_torch.models import int8_text
from textreid_torch.models.int8_vit import BLOCK_SITES
from textreid_torch.models.text_transformer import TextTransformer
from textreid_torch.utils.weight_convert import _textual, int8_tower_from_jax

torch.set_num_threads(2)

VOCAB, CTX, WIDTH, LAYERS, HEADS, OUT = 50, 12, 128, 2, 4, 16


def _tokens(n, seed, seq=CTX, min_len=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB, (n, seq)).astype(np.int32)
    lens = rng.randint(min_len, seq + 1, (n,)).astype(np.int32)
    for row, ln in enumerate(lens):  # zero-pad past lengths like the loader
        ids[row, ln:] = 0
    return ids, lens


def _t(ids, lens):
    return torch.from_numpy(ids).long(), torch.from_numpy(lens)


def _randomized(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*x.shape)).astype(
            np.float32), params)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(
        b, axis=1)


@pytest.fixture(scope="module")
def towers():
    jax_tt = JaxTextTransformer(vocab_size=VOCAB, context_length=CTX,
                                width=WIDTH, layers=LAYERS, heads=HEADS,
                                output_dim=OUT)
    ids, lens = _tokens(2, seed=0)
    params = _randomized(jax_tt.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                     jnp.asarray(lens))["params"], seed=1)
    sd: dict = {}
    _textual(sd, "", params)
    port = TextTransformer(VOCAB, CTX, WIDTH, LAYERS, HEADS, OUT)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    return jax_tt, params, port.eval()


@pytest.fixture(scope="module")
def calibrated(towers):
    jax_tt, params, port = towers
    batches = [_tokens(8, seed=2), _tokens(8, seed=3)]
    jax_amax = jax_int8.calibrate_text_amax(jax_tt, params, batches)
    jax_tower = jax_int8.prepare_int8_text(jax_tt, params, jax_amax)
    amax = int8_text.calibrate_text_amax(port, batches)
    tower = int8_text.prepare_int8_text(port, amax)
    return jax_amax, jax_tower, amax, tower


def _carried(jax_tower):
    as_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return int8_tower_from_jax(as_numpy(jax_tower.units),
                               as_numpy(jax_tower.scales),
                               as_numpy(jax_tower.consts))


def test_folded_float_graph_is_the_module_forward(towers):
    jax_tt, params, port = towers
    ids, lens = _tokens(4, seed=4)
    with torch.no_grad():
        want = port(*_t(ids, lens))
        got = int8_text.folded_text_float(port, *_t(ids, lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    jax_got = jax_int8._folded_text_float(jax_tt, params, jnp.asarray(ids),
                                          jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-4,
                               atol=1e-4)


def test_calibration_abs_max_equals_jax(calibrated):
    jax_amax, _, amax, _ = calibrated
    assert set(amax) == set(jax_amax) == {
        f"block_{i}.{s}" for i in range(LAYERS) for s in BLOCK_SITES}
    assert amax["block_0.qkv"].shape == (WIDTH,)
    assert amax["block_0.c_proj"].shape == (4 * WIDTH,)
    for site in jax_amax:
        np.testing.assert_allclose(amax[site].numpy(), jax_amax[site],
                                   rtol=1e-5, err_msg=site)


def test_calibration_takes_the_max_across_batches(towers):
    _, _, port = towers
    b1, b2 = _tokens(2, seed=5), _tokens(2, seed=6)
    each = [int8_text.calibrate_text_amax(port, [b]) for b in (b1, b2)]
    both = int8_text.calibrate_text_amax(port, [b1, b2])
    for site in both:
        assert torch.equal(both[site],
                           torch.maximum(each[0][site], each[1][site]))
    with pytest.raises(ValueError, match="at least one batch"):
        int8_text.calibrate_text_amax(port, [])


def test_prepare_gives_the_jax_towers_weights(towers, calibrated):
    jax_amax, jax_tower, _, _ = calibrated
    tower = int8_text.prepare_int8_text(
        towers[2],
        {s: torch.from_numpy(np.array(a)) for s, a in jax_amax.items()})
    assert set(tower.units) == set(jax_tower.units)
    for site, ju in jax_tower.units.items():
        u = tower.units[site]
        assert u["w_q"].dtype == torch.int8 and u["w_q"].T.is_contiguous()
        step = np.abs(u["w_q"].numpy().astype(np.int32)
                      - np.asarray(ju["w_q"]).astype(np.int32))
        assert step.max() <= 1 and (step > 0).mean() <= 1e-3, site
        np.testing.assert_allclose(u["s_w"].numpy(), np.asarray(ju["s_w"]),
                                   rtol=1e-6, err_msg=site)
        np.testing.assert_allclose(u["b"].numpy(), np.asarray(ju["b"]),
                                   rtol=1e-6, atol=1e-6, err_msg=site)
    for site, s in jax_tower.scales.items():
        np.testing.assert_allclose(tower.scales[site].numpy(), np.asarray(s),
                                   rtol=1e-6, err_msg=site)
    assert set(tower.consts) == set(jax_tower.consts)
    # an f32 tower reads the float tower's own table: one copy
    assert tower.consts["token"].data_ptr() == \
        towers[2].token_embedding.weight.data_ptr()
    assert tower.consts["proj"].dtype == torch.bfloat16


def test_apply_on_a_carried_tower_gives_the_jax_embeddings(towers,
                                                           calibrated):
    jax_tt, _, port = towers
    _, jax_tower, _, _ = calibrated
    ids, lens = _tokens(8, seed=7)
    want = np.asarray(jax_int8.int8_text_apply(
        jax_tt, jax_tower, jnp.asarray(ids), jnp.asarray(lens)))
    got = int8_text.int8_text_apply(port, _carried(jax_tower),
                                    *_t(ids, lens)).numpy()
    assert got.shape == want.shape == (8, OUT)
    assert _cosine(got, want).min() >= 0.9999
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_own_preparation_gives_the_jax_embeddings(towers, calibrated):
    jax_tt, _, port = towers
    _, jax_tower, _, tower = calibrated
    ids, lens = _tokens(6, seed=8)
    want = np.asarray(jax_int8.int8_text_apply(
        jax_tt, jax_tower, jnp.asarray(ids), jnp.asarray(lens)))
    got = int8_text.int8_text_apply(port, tower, *_t(ids, lens)).numpy()
    assert _cosine(got, want).min() >= 0.9999


def test_int8_agrees_with_the_float_tower(towers, calibrated):
    _, _, port = towers
    tower = calibrated[3]
    ids, lens = _tokens(8, seed=9)
    with torch.no_grad():
        want = port(*_t(ids, lens)).numpy()
    got = int8_text.int8_text_apply(port, tower, *_t(ids, lens)).numpy()
    assert _cosine(got, want).min() >= 0.999


def test_padding_does_not_move_the_int8_embedding(towers, calibrated):
    """Tokens past ``lengths`` are invisible: per-token row scales and the
    causal mask keep them out (no pad mask is needed)."""
    _, _, port = towers
    tower = calibrated[3]
    ids, lens = _tokens(4, seed=10, min_len=4)
    noisy = ids.copy()
    rng = np.random.RandomState(11)
    for row, ln in enumerate(lens):
        noisy[row, ln:] = rng.randint(1, VOCAB, CTX - ln)
    a = int8_text.int8_text_apply(port, tower, *_t(ids, lens))
    b = int8_text.int8_text_apply(port, tower, *_t(noisy, lens))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_both_settings_of_fused_ffn_agree(towers, calibrated):
    _, _, port = towers
    tower = calibrated[3]
    args = _t(*_tokens(4, seed=12))
    on = int8_text.int8_text_apply(port, tower, *args, fused_ffn=True)
    off = int8_text.int8_text_apply(port, tower, *args, fused_ffn=False)
    default = int8_text.int8_text_apply(port, tower, *args)
    assert torch.equal(on, default)  # the text tower's default is on
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="fused_ffn must be"):
        int8_text.int8_text_apply(port, tower, *args, fused_ffn="off")


def test_too_long_a_sequence_raises(towers, calibrated):
    _, _, port = towers
    with pytest.raises(ValueError, match="context_length"):
        int8_text.int8_text_apply(
            port, calibrated[3], torch.ones(1, CTX + 1, dtype=torch.long),
            torch.tensor([2]))


def test_bf16_tower_holds_one_bf16_table(towers, calibrated):
    _, _, port = towers
    tower = int8_text.prepare_int8_text(port, calibrated[2], torch.bfloat16)
    assert tower.consts["token"].dtype == torch.bfloat16
    args = _t(*_tokens(4, seed=13))
    out = int8_text.int8_text_apply(port, tower, *args)
    ref = int8_text.int8_text_apply(port, calibrated[3], *args)
    assert out.dtype == torch.bfloat16
    assert _cosine(out.float().numpy(), ref.numpy()).min() >= 0.995
