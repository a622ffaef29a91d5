"""The port's CLIP ViT tower against the JAX package's, on the CPU in f32.

The JAX tower runs its fused-attention Pallas kernels in interpret mode
(``fused_attention=True, attn_interpret=True``); the port's runs the
kernels' plain versions.  Weights cross with the port's converter.
Tolerance 1e-5: the same f32 arithmetic in another summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_tpu.utils.weight_convert import (
    convert_clip_vit as jax_convert_clip_vit,
)
from textreid_torch.models.vit import VisionTransformer
from textreid_torch.utils.weight_convert import _vit, convert_clip_vit

torch.set_num_threads(2)

RES, PATCH, WIDTH, LAYERS, HEADS, OUT = (32, 16), 8, 64, 2, 2, 32


def _jax_vit():
    return JaxViT(input_resolution=RES, patch_size=PATCH, width=WIDTH,
                  layers=LAYERS, heads=HEADS, output_dim=OUT,
                  fused_attention=True, attn_interpret=True)


def _port_vit(state_dict):
    model = VisionTransformer(RES, PATCH, WIDTH, LAYERS, HEADS, OUT)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state_dict.items()}, strict=True)
    return model


def _pixels(seed, batch=3):
    return np.random.RandomState(seed).randn(batch, *RES, 3).astype(
        np.float32)


def test_vit_matches_jax_on_converted_weights():
    x = _pixels(0)
    jax_model = _jax_vit()
    params = jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    sd: dict = {}
    _vit(sd, "", jax.tree.map(np.asarray, params))
    model = _port_vit(sd)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (3, OUT)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


def test_vit_gradients_match_jax():
    """d(sum of outputs * w)/d(params) through the fused attention's
    backward on both sides."""
    x = _pixels(2, batch=2)
    w = np.random.RandomState(3).randn(2, OUT).astype(np.float32)
    jax_model = _jax_vit()
    params = jax_model.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    grads = jax.grad(lambda p: jnp.sum(
        jax_model.apply({"params": p}, jnp.asarray(x)) * w))(params)
    want: dict = {}
    _vit(want, "", jax.tree.map(np.asarray, grads))
    sd: dict = {}
    _vit(sd, "", jax.tree.map(np.asarray, params))
    model = _port_vit(sd)
    (model(torch.from_numpy(x).permute(0, 3, 1, 2))
     * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def _clip_state_dict(seed=5, src_grid=4):
    """A synthetic OpenAI-CLIP archive: the ``visual.*`` ViT subtree at a
    square source grid, plus text-tower keys that share its block names."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {"visual.conv1.weight": arr(WIDTH, 3, PATCH, PATCH),
          "visual.class_embedding": arr(WIDTH),
          "visual.positional_embedding": arr(src_grid * src_grid + 1, WIDTH),
          "visual.proj": arr(WIDTH, OUT)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = 1 + arr(WIDTH)
        sd[f"visual.{ln}.bias"] = arr(WIDTH)
    for i in range(LAYERS + 1):  # one block more than the model keeps
        p = f"visual.transformer.resblocks.{i}"
        sd[f"{p}.attn.in_proj_weight"] = arr(3 * WIDTH, WIDTH)
        sd[f"{p}.attn.in_proj_bias"] = arr(3 * WIDTH)
        sd[f"{p}.attn.out_proj.weight"] = arr(WIDTH, WIDTH)
        sd[f"{p}.attn.out_proj.bias"] = arr(WIDTH)
        sd[f"{p}.mlp.c_fc.weight"] = arr(4 * WIDTH, WIDTH)
        sd[f"{p}.mlp.c_fc.bias"] = arr(4 * WIDTH)
        sd[f"{p}.mlp.c_proj.weight"] = arr(WIDTH, 4 * WIDTH)
        sd[f"{p}.mlp.c_proj.bias"] = arr(WIDTH)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = 1 + arr(WIDTH)
            sd[f"{p}.{ln}.bias"] = arr(WIDTH)
    sd["transformer.resblocks.0.attn.in_proj_weight"] = arr(3 * 32, 32)
    sd["token_embedding.weight"] = arr(10, 32)
    return sd


def test_convert_clip_vit_round_trips_against_the_jax_converter():
    grid = (RES[0] // PATCH, RES[1] // PATCH)  # (4, 2): the 4x4 grid resizes
    sd = _clip_state_dict()
    got = convert_clip_vit(sd, LAYERS, final_grid=grid, prefix="")
    jax_vars = jax_convert_clip_vit(sd, LAYERS, final_grid=grid)
    want: dict = {}
    _vit(want, "", jax_vars["params"])
    assert set(got) == set(want)
    assert got["positional_embedding"].shape == (grid[0] * grid[1] + 1, WIDTH)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                   rtol=1e-6, err_msg=name)

    # and the converted tower computes what the JAX tower computes
    x = _pixels(6, batch=2)
    jax_out = _jax_vit().apply(jax_vars, jnp.asarray(x))
    out = _port_vit(got)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out),
                               atol=1e-5, rtol=1e-5)


def test_convert_clip_vit_refuses_a_short_archive():
    sd = _clip_state_dict()
    with pytest.raises(KeyError, match="block 3"):
        convert_clip_vit(sd, LAYERS + 2, prefix="")
