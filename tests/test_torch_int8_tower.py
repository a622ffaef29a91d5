"""The port's int8-dataflow CLIP ModifiedResNet trunk
(``textreid_torch/models/int8_tower.py``) against the JAX package's, on the
CPU: the JAX package's own tiny trunk (all four stages, one block each,
width 16, res5 stride 1, 64x32 pixels) with its BatchNorm statistics
settled by train-mode forwards, as its tests settle them (init statistics
make every agreement bound meaningless).  The same numpy inputs from fixed
seeds go through both packages; the weights cross with
``state_dict_from_jax``, a prepared JAX tower with
``int8_conv_tower_from_jax``.

Tolerances: the folded float graph against the module's eval forward 1e-5
(f32, reassociated); calibration abs-max rtol 1e-5 of each channel, or of
the site's largest where a channel is small (the f32 convolutions sum in
another order; measured 1.1e-5 of a channel at 2% of its site's largest,
in layer 3); from JAX's abs-max the
port's ``w_q`` bit for bit, ``s_w`` and ``b`` rtol 1e-6 (``b`` atol 1e-6:
the zero-point term sums in another order).  On a carried tower every
int8 tensor between the convolutions equals JAX's, or differs by one step
on fewer than 0.1% of its elements (an f32 epilogue whose last bit differs
at a rounding boundary: XLA may contract ``acc * s_w + b`` into an FMA),
and the embeddings agree within 1e-4; the same with the bf16 epilogue,
and with ``float_blocks=1`` (a bf16 front) once the front's 2x2 pool sums
as XLA's CPU ``reduce_window`` does, one bf16 rounding an addition in
window order (the port's pool, ``F.avg_pool2d``, sums in f32 and rounds
once: the one difference, worth 1 bf16 ulp on a fifth of the pooled values
and, through the int8 layers that follow, 1e-3 of the embeddings; gated at
2e-3 as it is).  Int8 against
float embeddings: minimum cosine >= 0.999, and no lower than JAX's own on
the same weights minus 1e-4.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.engine.state import TrainState
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models import int8_tower as jax_tower
from textreid_tpu.models.losses import l2_normalize as jax_l2
from textreid_tpu.models.m_resnet import AttentionPool2d as JaxPool
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxMResNet
from textreid_tpu.models.model import preprocess_pixels as jax_preprocess
from textreid_torch.models import int8_tower
from textreid_torch.models.gru import BiGRUEncoder
from textreid_torch.models.losses import l2_normalize
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.models.model import TextReIDModel
from textreid_torch.ops import int8_conv
from textreid_torch.utils.weight_convert import (int8_conv_tower_from_jax,
                                                 load_reference_state_dict,
                                                 state_dict_from_jax)

torch.set_num_threads(2)

RES = (64, 32)
STEP_SHARE = 1e-3
EMB_TOL = 1e-4


def _uint8(seed, n=4):
    return np.random.RandomState(seed).randint(0, 255, (n, *RES, 3),
                                               dtype=np.uint8)


def _normalized(seed, n=4):
    return np.random.RandomState(seed).randn(n, *RES, 3).astype(
        np.float32) * 0.5


@pytest.fixture(scope="module")
def models():
    """(JAX model, its state, the port's model) on the same weights."""
    jax_model = JaxModel(
        visual=JaxMResNet(layers=(1, 1, 1, 1), output_dim=32, heads=4,
                          last_stride=1, input_resolution=RES, width=16),
        textual=JaxBiGRU(hidden_dim=8, vocab_size=30, embed_size=8),
        feature_size=16, num_classes=4)
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 30, (2, 8)),
                      jnp.int32)
    variables = jax_model.init(jax.random.PRNGKey(0),
                               jnp.asarray(_uint8(0, 2)), ids,
                               jnp.asarray([8, 4], jnp.int32),
                               method="init_all")
    stats = variables["batch_stats"]
    for seed in (1, 2, 3):  # settle the statistics, as a checkpoint's are
        _, mutated = jax_model.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(_uint8(seed)), train=True, erase=None,
            method="encode_image", mutable=["batch_stats"])
        stats = mutated["batch_stats"]
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"], batch_stats=stats,
                       constants=variables.get("constants", {}),
                       opt_state=None)
    model = TextReIDModel(
        ModifiedResNet((1, 1, 1, 1), 32, 4, last_stride=1,
                       input_resolution=RES, width=16),
        BiGRUEncoder(hidden_dim=8, vocab_size=30, embed_size=8),
        feature_size=16, num_classes=4).eval()
    load_reference_state_dict(model, state_dict_from_jax(
        {"params": variables["params"], "batch_stats": stats}))
    return jax_model, state, model


def _jax_visual(models):
    jax_model, state, _ = models
    return (jax_model.visual, state.params["visual"],
            state.batch_stats["visual"])


def _jax_amax(models, batches):
    visual, params, stats = _jax_visual(models)
    return jax_tower.calibrate_amax(visual, params, stats, batches,
                                    (0.5,) * 3, (0.25,) * 3)


def _port_amax(models, batches):
    return int8_tower.calibrate_amax(models[2].visual_model, batches,
                                     torch.full((3,), 0.5),
                                     torch.full((3,), 0.25))


def test_folded_float_graph_is_the_module_eval_forward(models):
    visual = models[2].visual_model
    x = torch.from_numpy(_normalized(4))
    with torch.no_grad():
        want = visual(x.permute(0, 3, 1, 2))
        feat = int8_tower.folded_trunk_float(visual, x)
        got = visual.attnpool(feat.permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jv, params, stats = _jax_visual(models)
    jax_feat = jax_tower._folded_trunk_float(jv, params, stats,
                                             jnp.asarray(x.numpy()), None)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jax_feat),
                               rtol=1e-5, atol=1e-5)


def test_calibration_abs_max_equals_jax(models):
    batches = [_uint8(5), _normalized(6)]
    want = _jax_amax(models, batches)
    got = _port_amax(models, batches)
    assert set(got) == set(want)
    assert {"conv1", "layer1_0.conv1", "layer2_0.downsample_out",
            "layer4_0.conv3"} <= set(got)
    for site, amax in want.items():
        np.testing.assert_allclose(got[site].numpy(), amax, rtol=1e-5,
                                   atol=1e-5 * amax.max(), err_msg=site)


def test_calibration_takes_the_max_across_batches(models):
    b1, b2 = _normalized(7), _normalized(8) * 2.0
    each = [_port_amax(models, [b]) for b in (b1, b2)]
    both = _port_amax(models, [b1, b2])
    for site in both:
        assert torch.equal(both[site],
                           torch.maximum(each[0][site], each[1][site]))
    with pytest.raises(ValueError, match="at least one batch"):
        _port_amax(models, [])


def _flat_hwio(w_q):
    """JAX's HWIO ``w_q`` as the port's ``[K (+ zero rows), co]``."""
    w = np.asarray(w_q).reshape(-1, w_q.shape[-1])
    pad = -w.shape[0] % 8
    return np.concatenate([w, np.zeros((pad, w.shape[1]), np.int8)])


@pytest.mark.parametrize("float_blocks", [0, 1])
def test_preparation_from_jax_abs_max_equals_jax(models, float_blocks):
    amax = _jax_amax(models, [_uint8(9)])
    visual, params, stats = _jax_visual(models)
    want = jax_tower.prepare_int8_tower(visual, params, stats, amax,
                                        float_blocks=float_blocks)
    got = int8_tower.prepare_int8_tower(
        models[2].visual_model,
        {s: torch.from_numpy(np.array(a)) for s, a in amax.items()},
        float_blocks=float_blocks)
    assert set(got.units) == set(want.units)
    for name, u in want.units.items():
        g = got.units[name]
        if "w" in u:  # the bf16 front
            np.testing.assert_array_equal(
                g["w"].float().permute(2, 3, 1, 0).numpy(),
                np.asarray(u["w"], np.float32), err_msg=name)
            np.testing.assert_allclose(g["b"].numpy(), u["b"], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            continue
        np.testing.assert_array_equal(g["w_q"].numpy(), _flat_hwio(u["w_q"]),
                                      err_msg=name)
        np.testing.assert_allclose(g["s_w"].numpy(), u["s_w"], rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g["b"].numpy(), u["b"], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for site, s in want.scales.items():
        np.testing.assert_allclose(got.scales[site].numpy(), s, rtol=1e-7)


def _carried(models, float_blocks=0):
    amax = _jax_amax(models, [_uint8(10), _uint8(11)])
    visual, params, stats = _jax_visual(models)
    jtower = jax_tower.prepare_int8_tower(visual, params, stats, amax,
                                          float_blocks=float_blocks)
    as_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return jtower, int8_conv_tower_from_jax(as_numpy(jtower.units),
                                            as_numpy(jtower.scales))


def _jax_embed(models, feat):
    jax_model, state, _ = models
    visual = jax_model.visual
    pool = JaxPool(spacial_dim=visual.final_grid,
                   embed_dim=visual.width * 32, num_heads=visual.heads,
                   output_dim=visual.output_dim)
    pooled = pool.apply({"params": state.params["visual"]["attnpool"]},
                        feat.astype(jnp.float32))
    emb = jax_model.apply({"params": state.params}, pooled,
                          method="embed_image")
    return np.asarray(jax_l2(emb.astype(jnp.float32), axis=1))


def _port_embed(models, feat):
    model = models[2]
    with torch.no_grad():
        pooled = model.visual_model.attnpool(
            feat.float().permute(0, 3, 1, 2))
        return l2_normalize(model.embed_image(pooled).float(), dim=1).numpy()


def _xla_cpu_bf16_pool(x, kernel):
    """``F.avg_pool2d(x, 2)`` of NCHW bf16 as XLA's CPU reduce_window sums
    it: in window order, each addition rounded to bf16, then / 4."""
    assert kernel == 2 and x.dtype == torch.bfloat16
    a, b = x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]
    c, d = x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]
    return (((a + b) + c) + d) / 4.0


def _assert_int8_close(got, want, what):
    assert got.shape == want.shape, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() < STEP_SHARE, (what, (diff > 0).mean())


@pytest.mark.parametrize("float_blocks,ep", [
    (0, "float32"), (1, "float32"), (0, "bfloat16")])
def test_trunk_on_a_carried_tower_equals_jax(models, float_blocks, ep):
    jtower, tower = _carried(models, float_blocks)
    x = _normalized(12)
    jax_inputs, inputs = [], []
    real_conv, real_conv2d = jax_tower._conv, int8_tower.int8_conv2d

    def jax_spy(xq, kernel, strides, preferred=None):
        if xq.dtype == jnp.int8:
            jax_inputs.append(np.asarray(xq))
        return real_conv(xq, kernel, strides, preferred)

    def spy(xq, *args):
        inputs.append(xq.numpy().copy())
        return real_conv2d(xq, *args)

    visual = _jax_visual(models)[0]
    with mock.patch.object(jax_tower, "_conv", jax_spy):
        want = jax_tower.int8_trunk_apply(
            visual, jtower, jnp.asarray(x), getattr(jnp, ep), float_blocks)

    def port(pool=int8_tower.F.avg_pool2d):
        with mock.patch.object(int8_tower.F, "avg_pool2d", pool):
            return int8_tower.int8_trunk_apply(
                models[2].visual_model, tower, torch.from_numpy(x),
                getattr(torch, ep), float_blocks)

    if float_blocks:
        np.testing.assert_allclose(_port_embed(models, port()),
                                   _jax_embed(models, want), atol=2e-3)
    with mock.patch.object(int8_tower, "int8_conv2d", spy):
        got = port(_xla_cpu_bf16_pool if float_blocks else
                   int8_tower.F.avg_pool2d)
    int8_units = sum("w_q" in u for u in tower.units.values())
    assert len(inputs) == len(jax_inputs) == int8_units
    for i, (g, w) in enumerate(zip(inputs, jax_inputs)):
        assert g.dtype == np.int8
        _assert_int8_close(g, w, f"conv input {i}")
    assert got.dtype == getattr(torch, ep)
    np.testing.assert_allclose(_port_embed(models, got),
                               _jax_embed(models, want), atol=EMB_TOL)


def test_every_product_reads_int8(models):
    """What the graph keeps between the convolutions is int8: every int8
    product's operands, as JAX's ``test_inter_conv_tensors_are_int8``."""
    _, tower = _carried(models)
    seen = []
    real = int8_conv.int_matmul

    def spy(xq, w_q):
        seen.append((xq.dtype, w_q.dtype))
        return real(xq, w_q)

    with mock.patch.object(int8_conv, "int_matmul", spy):
        int8_tower.int8_trunk_apply(models[2].visual_model, tower,
                                    torch.from_numpy(_normalized(13, 2)))
    assert len(seen) == len(tower.units) == 3 + 4 * 3 + 4
    assert set(seen) == {(torch.int8, torch.int8)}


def _float_embed(model, pixels):
    with torch.no_grad():
        return l2_normalize(model.embed_image(model.encode_image(
            torch.from_numpy(pixels))).float(), dim=1).numpy()


def test_int8_encoder_against_the_float_tower_and_jax(models):
    jax_model, state, model = models
    calib, pixels = [_uint8(14)], _uint8(15)
    encode, _ = int8_tower.build_int8_encoder(model, calib)
    with torch.no_grad():
        got = encode(torch.from_numpy(pixels)).numpy()
    cos = (got * _float_embed(model, pixels)).sum(axis=1)

    jencode, jtower = jax_tower.build_int8_encoder(jax_model, state, calib)
    erase = jnp.zeros((4, 5), jnp.int32)
    jgot = np.asarray(jencode(state, jtower, jnp.asarray(pixels), erase))
    feat = jax_model.apply(
        {"params": state.params, "batch_stats": state.batch_stats,
         "constants": state.constants}, jnp.asarray(pixels), erase=erase,
        method="encode_image")
    jfloat = np.asarray(jax_l2(jax_model.apply(
        {"params": state.params}, feat, method="embed_image").astype(
            jnp.float32), axis=1))
    jcos = (jgot * jfloat).sum(axis=1)
    assert cos.min() >= 0.999, cos
    assert cos.min() >= jcos.min() - 1e-4, (cos, jcos)


def test_uint8_input_equals_the_normalized_float_input(models):
    model = models[2]
    encode, _ = int8_tower.build_int8_encoder(model, [_uint8(16)])
    pixels = torch.from_numpy(_uint8(17))
    jax_f32 = np.asarray(jax_preprocess(
        jnp.asarray(pixels.numpy()), None, (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225), jnp.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            encode(pixels).numpy(), encode(torch.from_numpy(jax_f32)).numpy(),
            atol=1e-5)


def test_other_towers_are_refused(models):
    from textreid_torch.models.resnet import ResNet

    model = TextReIDModel(ResNet("basic", (1, 1, 1, 1)),
                          models[2].textual_model, feature_size=16)
    with pytest.raises(NotImplementedError, match="ModifiedResNet"):
        int8_tower.build_int8_encoder(model, [_uint8(18)])
