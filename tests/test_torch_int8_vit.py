"""The port's int8-dataflow ViT (``models/int8_vit.py``) against the JAX
package's, on the CPU in f32: 2 layers, width 128, 4 heads, 32x16 pixels in
8x8 patches.  The same numpy inputs from fixed seeds go through both; the
weights cross with ``state_dict_from_jax``'s ViT branch, a prepared JAX tower
with ``int8_tower_from_jax``.  On the CPU JAX runs its XLA composition (its
Pallas gates open on a TPU only) and the port the plain versions of K7-K9.

Tolerances: folded float graph against the module 1e-4 (reassociated f32);
calibration abs-max rtol 1e-5; ``w_q`` equal but for one step on at most
0.1% of the weights (a product that differs in its last bit at a rounding
boundary), ``s_w``, ``b`` and the activation scales rtol 1e-6 (``b`` with
atol 1e-6: ``beta @ W`` sums in another order); int8 against float cosine >=
0.999, the JAX package's bar.  On identical quantized weights the two
packages' embeddings agree to cosine >= 0.9999 and to 2% of the largest
embedding entry: their f32 activations differ in the last bits (attention
and LayerNorm sum in another order), which flips an int8 activation that
lies on a rounding boundary by one step, 1/127 of its row's range.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models import int8_vit as jax_int8
from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_torch.models import int8_vit
from textreid_torch.models.vit import VisionTransformer
from textreid_torch.ops import int8_mm
from textreid_torch.utils.weight_convert import _vit, int8_tower_from_jax

torch.set_num_threads(2)

RES, PATCH, WIDTH, LAYERS, HEADS, OUT = (32, 16), 8, 128, 2, 4, 16
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def _pixels(seed, batch=4):
    return np.random.RandomState(seed).randn(batch, *RES, 3).astype(
        np.float32)


def _randomized(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*x.shape)).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def towers():
    jax_vit = JaxViT(input_resolution=RES, patch_size=PATCH, width=WIDTH,
                     layers=LAYERS, heads=HEADS, output_dim=OUT)
    params = _randomized(jax_vit.init(
        jax.random.PRNGKey(0), jnp.asarray(_pixels(0)))["params"], seed=1)
    sd: dict = {}
    _vit(sd, "", params)
    port = VisionTransformer(RES, PATCH, WIDTH, LAYERS, HEADS, OUT)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    return jax_vit, params, port.eval()


@pytest.fixture(scope="module")
def calibrated(towers):
    """Both packages calibrated on the same two batches and prepared."""
    jax_vit, params, port = towers
    batches = [_pixels(2), _pixels(3)]
    jax_amax = jax_int8.calibrate_vit_amax(jax_vit, params, batches, MEAN,
                                           STD)
    jax_tower = jax_int8.prepare_int8_vit(jax_vit, params, jax_amax)
    amax = int8_vit.calibrate_vit_amax(port, batches, torch.tensor(MEAN),
                                       torch.tensor(STD))
    tower = int8_vit.prepare_int8_vit(port, amax)
    return jax_amax, jax_tower, amax, tower


def _prepared_from(port, jax_amax):
    """The port's preparation on the JAX package's abs-max, so that the
    preparation is compared apart from the calibration."""
    return int8_vit.prepare_int8_vit(
        port, {s: torch.from_numpy(np.array(a)) for s, a in jax_amax.items()})


def _carried(jax_tower):
    as_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return int8_tower_from_jax(as_numpy(jax_tower.units),
                               as_numpy(jax_tower.scales),
                               as_numpy(jax_tower.consts))


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(
        b, axis=1)


def test_folded_float_graph_is_the_module_forward(towers):
    jax_vit, params, port = towers
    x = _pixels(4)
    with torch.no_grad():
        want = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = int8_vit.folded_vit_float(port, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    jax_got = jax_int8._folded_vit_float(jax_vit, params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-4,
                               atol=1e-4)


def test_calibration_abs_max_equals_jax(calibrated):
    jax_amax, _, amax, _ = calibrated
    assert set(amax) == set(jax_amax) == {"patch"} | {
        f"block_{i}.{s}" for i in range(LAYERS)
        for s in int8_vit.BLOCK_SITES}
    assert amax["patch"].shape == (3,)
    assert amax["block_0.c_proj"].shape == (4 * WIDTH,)
    for site in jax_amax:
        np.testing.assert_allclose(amax[site].numpy(), jax_amax[site],
                                   rtol=1e-5, err_msg=site)


def test_calibration_takes_the_max_across_batches(towers):
    _, _, port = towers
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    b1, b2 = _pixels(5), _pixels(6)
    each = [int8_vit.calibrate_vit_amax(port, [b], mean, std)
            for b in (b1, b2)]
    both = int8_vit.calibrate_vit_amax(port, [b1, b2], mean, std)
    for site in both:
        assert torch.equal(both[site],
                           torch.maximum(each[0][site], each[1][site]))
    with pytest.raises(ValueError, match="at least one batch"):
        int8_vit.calibrate_vit_amax(port, [], mean, std)


def test_calibration_normalizes_uint8_pixels(towers):
    _, _, port = towers
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    raw = np.random.RandomState(7).randint(0, 256, (2, *RES, 3),
                                           dtype=np.uint8)
    normalized = (raw.astype(np.float32) / 255.0 - np.array(
        MEAN, np.float32)) / np.array(STD, np.float32)
    a = int8_vit.calibrate_vit_amax(port, [raw], mean, std)
    b = int8_vit.calibrate_vit_amax(port, [normalized], mean, std)
    for site in a:
        np.testing.assert_allclose(a[site].numpy(), b[site].numpy(),
                                   rtol=1e-5)


def test_prepare_gives_the_jax_towers_weights(towers, calibrated):
    jax_amax, jax_tower, _, _ = calibrated
    tower = _prepared_from(towers[2], jax_amax)
    assert set(tower.units) == set(jax_tower.units)
    for site, ju in jax_tower.units.items():
        u = tower.units[site]
        want_q = np.asarray(ju["w_q"]).reshape(-1, ju["w_q"].shape[-1])
        assert u["w_q"].dtype == torch.int8
        assert u["w_q"].T.is_contiguous()  # the layout the kernels read
        step = np.abs(u["w_q"].numpy().astype(np.int32)
                      - want_q.astype(np.int32))
        assert step.max() <= 1 and (step > 0).mean() <= 1e-3, site
        np.testing.assert_allclose(u["s_w"].numpy(), np.asarray(ju["s_w"]),
                                   rtol=1e-6, err_msg=site)
        np.testing.assert_allclose(u["b"].numpy(), np.asarray(ju["b"]),
                                   rtol=1e-6, atol=1e-6, err_msg=site)
    for site, s in jax_tower.scales.items():
        np.testing.assert_allclose(tower.scales[site].numpy(), np.asarray(s),
                                   rtol=1e-6, err_msg=site)
    assert tower.consts["proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tower.consts["proj"].float().numpy(),
        np.asarray(jax_tower.consts["proj"].astype(jnp.float32)))


def test_apply_on_a_carried_tower_gives_the_jax_embeddings(towers,
                                                           calibrated):
    jax_vit, _, port = towers
    _, jax_tower, _, _ = calibrated
    x = _pixels(8, batch=6)
    want = np.asarray(jax_int8.int8_vit_apply(jax_vit, jax_tower,
                                              jnp.asarray(x)))
    got = int8_vit.int8_vit_apply(port, _carried(jax_tower),
                                  torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, OUT)
    assert _cosine(got, want).min() >= 0.9999
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_own_preparation_gives_the_jax_embeddings(towers, calibrated):
    jax_vit, _, port = towers
    _, jax_tower, _, tower = calibrated
    x = _pixels(9)
    want = np.asarray(jax_int8.int8_vit_apply(jax_vit, jax_tower,
                                              jnp.asarray(x)))
    got = int8_vit.int8_vit_apply(port, tower, torch.from_numpy(x)).numpy()
    assert _cosine(got, want).min() >= 0.9999


def test_int8_agrees_with_the_float_tower(towers, calibrated):
    _, _, port = towers
    tower = calibrated[3]
    x = _pixels(10, batch=8)
    with torch.no_grad():
        want = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    got = int8_vit.int8_vit_apply(port, tower, torch.from_numpy(x)).numpy()
    assert _cosine(got, want).min() >= 0.999


def test_every_block_matmul_consumes_int8(towers, calibrated):
    _, _, port = towers
    tower = calibrated[3]
    seen = []
    real = int8_mm.int_matmul

    def spy(xq, w_q):
        seen.append((xq.dtype, w_q.dtype))
        return real(xq, w_q)

    with mock.patch.object(int8_mm, "int_matmul", spy), \
            mock.patch.object(int8_vit, "int_matmul", spy):
        for fused in (False, True):
            int8_vit.int8_vit_apply(port, tower,
                                    torch.from_numpy(_pixels(11, 2)),
                                    fused_ffn=fused)
    # patch + 4 products a block, both settings of fused_ffn
    assert len(seen) == 2 * (1 + 4 * LAYERS)
    assert all(pair == (torch.int8, torch.int8) for pair in seen)


def test_both_settings_of_fused_ffn_agree(towers, calibrated):
    """In an f32 tower K7 and K8 + ``c_proj`` are the same function."""
    _, _, port = towers
    tower = calibrated[3]
    x = torch.from_numpy(_pixels(12))
    off = int8_vit.int8_vit_apply(port, tower, x, fused_ffn=False)
    on = int8_vit.int8_vit_apply(port, tower, x, fused_ffn=True)
    default = int8_vit.int8_vit_apply(port, tower, x)
    assert torch.equal(off, default)  # the ViT's default is off
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="fused_ffn must be"):
        int8_vit.int8_vit_apply(port, tower, x, fused_ffn="on")


def test_bf16_tower_keeps_the_residual_stream_in_bf16(towers, calibrated):
    _, _, port = towers
    amax = calibrated[2]
    tower = int8_vit.prepare_int8_vit(port, amax, torch.bfloat16)
    x = torch.from_numpy(_pixels(13))
    out = int8_vit.int8_vit_apply(port, tower, x)
    ref = int8_vit.int8_vit_apply(port, calibrated[3], x)
    assert out.dtype == torch.bfloat16
    assert _cosine(out.float().numpy(), ref.numpy()).min() >= 0.995


def test_unfolded_patches_are_the_convolution(towers):
    _, _, port = towers
    x = torch.from_numpy(_pixels(14))
    with torch.no_grad():
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), port.conv1.weight, stride=PATCH)
        got = int8_vit.unfold_patches(x, PATCH) @ int8_vit.patch_kernel(port)
    np.testing.assert_allclose(
        got.numpy(), want.flatten(2).transpose(1, 2).numpy(), atol=1e-5)
