"""The port's int8 interceptor (``textreid_torch/models/quant_tower.py``)
against the JAX package's (``textreid_tpu/models/quant_tower.py``), on the
CPU in f32, on the same numpy inputs and carried weights.

Tolerances: ``int8_conv`` and ``int8_dense`` within one quantization step
of the output (``s_x max s_w 127``: one activation step times the largest
weight), the bound a rounding boundary crossed by a last-bit difference
allows; ``int8_image_encoder`` on the CLIP ModifiedResNet, the torchvision
resnet18 and a ViT within 1e-4 of JAX's embeddings (each quantizes only
the convolutions with ``kh kw cout >= 2304``: RN50's wide 3x3s, resnet18's
7x7 stem and layer 3-4 3x3s, the ViT's patchify), and each at cosine above
0.99 to its float tower (the JAX package's own bar,
``tests/test_quant_tower.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.engine.state import TrainState
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models import quant_tower as jax_quant
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxMResNet
from textreid_tpu.models.resnet import ResNet as JaxResNet
from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_torch.models import common, quant_tower
from textreid_torch.models.gru import BiGRUEncoder
from textreid_torch.models.losses import l2_normalize
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.models.model import TextReIDModel
from textreid_torch.models.resnet import ResNet
from textreid_torch.models.vit import VisionTransformer
from textreid_torch.utils.weight_convert import (load_reference_state_dict,
                                                 state_dict_from_jax)

torch.set_num_threads(2)

RES = (64, 32)


def _step(s_x, w_q_scale):
    return float(np.max(s_x * w_q_scale) * 127)


@pytest.mark.parametrize("kernel,stride,ci,co", [
    (3, 1, 16, 32), (3, 2, 8, 16), (1, 1, 32, 24), (7, 2, 3, 16)])
def test_int8_conv_equals_jax(kernel, stride, ci, co):
    rng = np.random.RandomState(kernel + stride)
    x = rng.randn(2, 10, 9, ci).astype(np.float32)
    w = (rng.randn(kernel, kernel, ci, co) * 0.1).astype(np.float32)
    pad = kernel // 2
    want = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), [(pad, pad)] * 2))
    got = quant_tower.int8_conv(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), (stride, stride),
        (pad, pad)).permute(0, 2, 3, 1)
    s_x = np.abs(x).max() / 127.0
    s_w = np.abs(w).max(axis=(0, 1, 2)) / 127.0
    np.testing.assert_allclose(got.numpy(), want, atol=_step(s_x, s_w))


def test_int8_dense_equals_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(4, 9, 60).astype(np.float32)  # K = 60: padded to 64
    w = (rng.randn(60, 130) * 0.1).astype(np.float32)
    b = (rng.randn(130) * 0.1).astype(np.float32)
    want = np.asarray(jax_quant.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b)))
    got = quant_tower.int8_dense(torch.from_numpy(x),
                                 torch.from_numpy(w.T.copy()),
                                 torch.from_numpy(b))
    s_w = np.abs(w).max(axis=0) / 127.0
    np.testing.assert_allclose(got.numpy(), want,
                               atol=_step(np.abs(x).max() / 127.0, s_w))


def test_the_context_managers_route_and_restore():
    conv = torch.nn.Conv2d(8, 300, 3, padding=1, bias=False)
    dil = torch.nn.Conv2d(8, 300, 3, padding=2, dilation=2, bias=False)
    x = torch.randn(1, 8, 5, 5)
    with torch.no_grad():
        float_y = common.conv2d(x, conv)
        with quant_tower.int8_convs(2304):  # 3 * 3 * 300 qualifies
            assert common.INT8_CONVS.get() == 2304
            q = common.conv2d(x, conv)
            assert torch.equal(common.conv2d(x, dil), torch.nn.functional
                               .conv2d(x, dil.weight, None, 1, 2, 2))
        with quant_tower.int8_convs(3000):  # it does not
            assert torch.equal(common.conv2d(x, conv), float_y)
    assert common.INT8_CONVS.get() is None
    assert torch.equal(q, quant_tower.int8_conv(x, conv.weight, (1, 1),
                                                (1, 1)))
    assert not torch.equal(q, float_y)
    lin = torch.nn.Linear(16, 512)
    h = torch.randn(3, 16)
    with quant_tower.int8_linears(512):
        got = common.linear(h, lin)
    assert common.INT8_LINEARS.get() is None
    assert torch.equal(got, quant_tower.int8_dense(h, lin.weight, lin.bias))


def _visual_pair(kind):
    if kind == "m_resnet":
        return (JaxMResNet(layers=(1, 1, 1, 1), output_dim=32, heads=4,
                           last_stride=1, input_resolution=RES, width=32),
                ModifiedResNet((1, 1, 1, 1), 32, 4, last_stride=1,
                               input_resolution=RES, width=32))
    if kind == "resnet18":
        return (JaxResNet("basic", (2, 2, 2, 2)),
                ResNet("basic", (2, 2, 2, 2)))
    return (JaxViT(input_resolution=RES, patch_size=8, width=64, layers=2,
                   heads=4, output_dim=32),
            VisionTransformer(RES, 8, 64, 2, 4, 32))


@pytest.fixture(scope="module", params=["m_resnet", "resnet18", "vit"])
def pair(request):
    """(JAX model, its state, the port's model) on the same weights."""
    jax_visual, visual = _visual_pair(request.param)
    jax_model = JaxModel(visual=jax_visual,
                         textual=JaxBiGRU(hidden_dim=8, vocab_size=30,
                                          embed_size=8),
                         feature_size=16, num_classes=4)
    rng = np.random.RandomState(0)
    variables = jax_model.init(
        jax.random.PRNGKey(0),
        jnp.asarray(rng.randint(0, 255, (2, *RES, 3), dtype=np.uint8)),
        jnp.asarray(rng.randint(1, 30, (2, 8)), jnp.int32),
        jnp.asarray([8, 4], jnp.int32), method="init_all")
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables.get("batch_stats", {}),
                       constants=variables.get("constants", {}),
                       opt_state=None)
    model = TextReIDModel(visual, BiGRUEncoder(hidden_dim=8, vocab_size=30,
                                               embed_size=8),
                          feature_size=16, num_classes=4).eval()
    load_reference_state_dict(model, state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return jax_model, state, model


def test_image_encoder_equals_jax_and_stays_near_float(pair):
    jax_model, state, model = pair
    pixels = np.random.RandomState(4).randint(0, 255, (4, *RES, 3),
                                              dtype=np.uint8)
    erase = jnp.zeros((4, 5), jnp.int32)
    want = np.asarray(jax_quant.int8_image_encoder(jax_model, state)(
        state, jnp.asarray(pixels), erase))
    encode = quant_tower.int8_image_encoder(model)
    got = encode(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        float_emb = l2_normalize(model.embed_image(model.encode_image(
            torch.from_numpy(pixels))).float(), dim=1).numpy()
    cos = (got * float_emb).sum(axis=1)
    assert cos.min() > 0.99, cos
    assert np.abs(got - float_emb).max() > 0  # some convolution quantized
