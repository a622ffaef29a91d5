"""The port's CLIP text transformer against the JAX package's, on the CPU in
f32, from the same parameters carried over by ``state_dict_from_jax``'s text
branch.  Tolerance rtol/atol 1e-4: the same f32 arithmetic in another
summation order through two layers (the JAX tower runs XLA's attention, the
port the plain version of K5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.text_transformer import (
    TextTransformer as JaxTextTransformer,
)
from textreid_tpu.utils.weight_convert import (
    convert_clip_text as jax_convert_clip_text,
)
from textreid_torch.config import get_default_cfg
from textreid_torch.models.text_transformer import (
    TEXT_TRANSFORMER_SPECS,
    TextTransformer,
    build_text_transformer,
)
from textreid_torch.utils.weight_convert import _textual, convert_clip_text

torch.set_num_threads(2)

VOCAB, CTX, WIDTH, LAYERS, HEADS, OUT = 50, 12, 128, 2, 4, 16


def _tokens(n, seed, seq=CTX, min_len=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB, (n, seq)).astype(np.int32)
    lens = rng.randint(min_len, seq + 1, (n,)).astype(np.int32)
    for row, ln in enumerate(lens):
        ids[row, ln:] = 0
    return ids, lens


def _randomized(params, seed):
    """Seeded values for every leaf (flax initialises biases and LayerNorm
    affines to constants, which would hide a swapped pair)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*x.shape)).astype(
            np.float32), params)


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


def test_matches_jax_on_converted_weights(towers):
    jax_tt, params, port = towers
    ids, lens = _tokens(5, seed=2)
    want = np.asarray(jax_tt.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(lens)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(lens))
    assert got.shape == (5, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_shorter_sequences_use_the_first_positions(towers):
    jax_tt, params, port = towers
    ids, lens = _tokens(3, seed=3, seq=7)
    want = np.asarray(jax_tt.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(lens)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_padding_does_not_move_the_embedding(towers):
    """Under the causal mask the end-of-text slot sees its own prefix only:
    other tokens after ``lengths``, and other rows in the batch, change
    nothing."""
    _, _, port = towers
    ids, lens = _tokens(4, seed=4)
    noisy = ids.copy()
    rng = np.random.RandomState(5)
    for row, ln in enumerate(lens):
        noisy[row, ln:] = rng.randint(1, VOCAB, CTX - ln)
    with torch.no_grad():
        a = port(torch.from_numpy(ids).long(), torch.from_numpy(lens))
        b = port(torch.from_numpy(noisy).long(), torch.from_numpy(lens))
        c = port(torch.from_numpy(ids[:1]).long(), torch.from_numpy(lens[:1]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(a[:1].numpy(), c.numpy(), atol=1e-6)


def test_lengths_are_clipped_into_the_sequence(towers):
    _, _, port = towers
    ids, _ = _tokens(2, seed=6)
    with torch.no_grad():
        low = port(torch.from_numpy(ids).long(), torch.tensor([0, 1]))
        high = port(torch.from_numpy(ids).long(), torch.tensor([CTX, 99]))
        first = port(torch.from_numpy(ids).long(), torch.tensor([1, 1]))
        full = port(torch.from_numpy(ids).long(), torch.tensor([CTX, CTX]))
    np.testing.assert_allclose(low.numpy(), first.numpy(), atol=1e-6)
    np.testing.assert_allclose(high.numpy(), full.numpy(), atol=1e-6)


def test_too_long_a_sequence_raises(towers):
    _, _, port = towers
    ids = torch.ones(1, CTX + 1, dtype=torch.long)
    with pytest.raises(ValueError, match="context_length"):
        port(ids, torch.tensor([3]))


def test_bf16_compute_dtype_keeps_f32_parameters(towers):
    _, _, port = towers
    ids, lens = _tokens(2, seed=7)
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(lens),
                   dtype=torch.bfloat16)
        ref = port(torch.from_numpy(ids).long(), torch.from_numpy(lens))
    assert out.dtype == torch.bfloat16
    assert port.text_projection.dtype == torch.float32
    assert torch.nn.functional.cosine_similarity(
        out.float(), ref, dim=1).min() > 0.99


def _clip_text_state_dict(seed=8, ctx=9):
    """A synthetic CLIP archive: the text tower at the top level and a few
    ``visual.*`` keys that share its block names."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {"token_embedding.weight": arr(VOCAB, WIDTH),
          "positional_embedding": arr(ctx, WIDTH),
          "ln_final.weight": arr(WIDTH), "ln_final.bias": arr(WIDTH),
          "text_projection": arr(WIDTH, OUT),
          "visual.transformer.resblocks.0.attn.in_proj_weight": arr(6, 2),
          "visual.proj": arr(4, 4), "logit_scale": arr(1)}
    for i in range(LAYERS + 1):  # one block more than the tower takes
        p = f"transformer.resblocks.{i}"
        sd[f"{p}.attn.in_proj_weight"] = arr(3 * WIDTH, WIDTH)
        sd[f"{p}.attn.in_proj_bias"] = arr(3 * WIDTH)
        sd[f"{p}.attn.out_proj.weight"] = arr(WIDTH, WIDTH)
        sd[f"{p}.attn.out_proj.bias"] = arr(WIDTH)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = arr(WIDTH)
            sd[f"{p}.{ln}.bias"] = arr(WIDTH)
        sd[f"{p}.mlp.c_fc.weight"] = arr(4 * WIDTH, WIDTH)
        sd[f"{p}.mlp.c_fc.bias"] = arr(4 * WIDTH)
        sd[f"{p}.mlp.c_proj.weight"] = arr(WIDTH, 4 * WIDTH)
        sd[f"{p}.mlp.c_proj.bias"] = arr(WIDTH)
    return sd


def test_convert_clip_text_loads_and_matches_the_jax_importer():
    """A CLIP-layout text half with a 9-row positional table, resampled to
    the 12-row context: the port's converter gives the tower the JAX
    importer's parameters, and both towers the same embeddings."""
    sd = _clip_text_state_dict()
    converted = convert_clip_text(sd, LAYERS, context_length=CTX, prefix="")
    assert converted["positional_embedding"].shape == (CTX, WIDTH)
    assert not any(k.startswith("visual.") or "resblocks.2" in k
                   or k == "logit_scale" for k in converted)
    port = TextTransformer(VOCAB, CTX, WIDTH, LAYERS, HEADS, OUT)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in converted.items()}, strict=True)
    params = jax_convert_clip_text(sd, LAYERS, context_length=CTX)["params"]
    np.testing.assert_allclose(converted["positional_embedding"],
                               params["positional_embedding"], rtol=1e-6)
    jax_tt = JaxTextTransformer(vocab_size=VOCAB, context_length=CTX,
                                width=WIDTH, layers=LAYERS, heads=HEADS,
                                output_dim=OUT)
    ids, lens = _tokens(3, seed=9)
    want = np.asarray(jax_tt.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(lens)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(ids).long(),
                          torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_convert_clip_text_keeps_the_prefix_and_needs_every_block():
    sd = _clip_text_state_dict()
    out = convert_clip_text(sd, LAYERS)
    assert all(k.startswith("textual_model.") for k in out)
    assert out["textual_model.positional_embedding"].shape == (9, WIDTH)
    with pytest.raises(KeyError, match="no block"):
        convert_clip_text(sd, LAYERS + 2)


def test_build_text_transformer_presets_and_explicit_fields():
    cfg = get_default_cfg()
    cfg.MODEL.TRANSFORMER.ARCH = "clip_text_b16"
    cfg.MODEL.TRANSFORMER.CONTEXT_LENGTH = 100
    cfg.MODEL.TRANSFORMER.VOCAB_SIZE = 64
    tt = build_text_transformer(cfg)
    assert (tt.width, tt.layers, tt.heads, tt.output_dim,
            tt.context_length) == (512, 12, 8, 512, 100)
    assert tt.out_channels == 512
    assert set(TEXT_TRANSFORMER_SPECS) == {
        "clip_text_rn50", "clip_text_rn101", "clip_text_b32",
        "clip_text_b16", "clip_text_l14"}
    cfg.MODEL.TRANSFORMER.ARCH = ""
    cfg.MODEL.TRANSFORMER.WIDTH = 64
    cfg.MODEL.TRANSFORMER.LAYERS = 1
    cfg.MODEL.TRANSFORMER.HEADS = 2
    cfg.MODEL.TRANSFORMER.OUTPUT_DIM = 8
    tt = build_text_transformer(cfg)
    assert (tt.width, tt.layers, tt.heads, tt.output_dim) == (64, 1, 2, 8)
    cfg.MODEL.TRANSFORMER.ARCH = "clip_text_xl"
    with pytest.raises(KeyError, match="unknown MODEL.TRANSFORMER.ARCH"):
        build_text_transformer(cfg)
