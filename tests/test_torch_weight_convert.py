"""Weights from the JAX package to the port: ``state_dict_from_jax`` against
the JAX package's own exporter, the ``.pth`` round trip through
``build_eval_model``, and the errors for keys that do not match."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.config import get_default_cfg
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models import TextReIDModel as JaxTextReIDModel
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_tpu.utils.weight_convert import export_textreid_checkpoint
from textreid_torch.models import build_model
from textreid_torch.utils.bootstrap import build_eval_model
from textreid_torch.utils.weight_convert import (
    FROZEN_TABLE_KEY,
    load_reference_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)

torch.set_num_threads(2)


def tiny_cfg():
    cfg = get_default_cfg()
    cfg.MODEL.VISUAL_MODEL = "m_resnet50"
    cfg.MODEL.TEXTUAL_MODEL = "bigru"
    cfg.MODEL.GRU.ONEHOT = "clip_vit"
    cfg.MODEL.GRU.VOCABULARY_SIZE = 30
    cfg.MODEL.GRU.EMBEDDING_SIZE = 8
    cfg.MODEL.GRU.NUM_UNITS = 16
    cfg.MODEL.RESNET.RES5_STRIDE = 1
    cfg.MODEL.EMBEDDING.EMBED_HEAD = "moco"
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 12
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 64, 32
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    return cfg


@pytest.fixture(scope="module")
def jax_pieces():
    model = JaxTextReIDModel(
        visual=JaxModifiedResNet(layers=(1, 1, 1, 1), output_dim=16, heads=2,
                                 input_resolution=(64, 32), width=8),
        textual=JaxBiGRU(hidden_dim=16, vocab_size=30, embed_size=8,
                         use_onehot="clip_vit", allow_random_table=True),
        feature_size=12, num_classes=5)
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3), jnp.uint8),
        jnp.ones((1, 6), jnp.int32), jnp.ones((1,), jnp.int32),
        method="init_all"))()
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "constants": variables["constants"]}


def test_matches_the_jax_exporter_key_for_key(jax_pieces):
    """On every query key (the loss projection included) the port's
    converter gives exactly what the JAX package's exporter gives, so the
    two cannot drift."""
    sd = state_dict_from_jax(jax_pieces)
    moco = dict(jax_pieces, key_params=jax_pieces["params"],
                key_batch_stats=jax_pieces["batch_stats"],
                v_queue=np.zeros((4, 12), np.float32),
                t_queue=np.zeros((4, 12), np.float32),
                id_queue=np.zeros((4,), np.int32),
                queue_ptr=np.zeros((), np.int32))
    ref = export_textreid_checkpoint(moco, tiny_cfg())
    for key, value in sd.items():
        if key == FROZEN_TABLE_KEY:
            np.testing.assert_array_equal(
                value, np.asarray(
                    jax_pieces["constants"]["textual"]["frozen_token_table"]))
            continue
        assert key in ref, key
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
        assert value.dtype == ref[key].dtype, key
    query = {k for k in ref if not k.startswith(
        ("embed_model.v_encoder_k", "embed_model.t_encoder_k",
         "embed_model.v_queue",
         "embed_model.t_queue", "embed_model.id_queue",
         "embed_model.queue_ptr"))}
    assert query == set(sd) - {FROZEN_TABLE_KEY}


def test_pth_round_trip_through_build_eval_model(tmp_path):
    cfg = tiny_cfg()
    source = build_model(cfg, "cpu")
    path = str(tmp_path / "model.pth")
    save_reference_checkpoint(source, path)
    cfg.SEED = 1  # a different seeded init, overwritten by the checkpoint
    loaded = build_eval_model(cfg, path, device="cpu")
    want = source.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    fresh = build_model(cfg, "cpu")
    assert not torch.equal(fresh.embed_model.v_embed_layer.weight,
                           want["embed_model.v_embed_layer.weight"])


def test_key_errors(jax_pieces):
    sd = state_dict_from_jax(jax_pieces)
    model = build_model(tiny_cfg(), "cpu")
    with pytest.raises(KeyError, match="missing"):  # a full-width trunk
        load_reference_state_dict(model, sd)

    from textreid_torch.models import BiGRUEncoder, TextReIDModel
    from textreid_torch.models.m_resnet import ModifiedResNet

    def tiny_model():
        return TextReIDModel(
            ModifiedResNet((1, 1, 1, 1), 16, 2, input_resolution=(64, 32),
                           width=8),
            BiGRUEncoder(16, 30, 8, use_onehot="clip_vit",
                         allow_random_table=True), 12)

    model = tiny_model()
    load_reference_state_dict(model, dict(
        sd, **{"embed_model.v_queue": np.zeros((12, 4), np.float32),
               "module.embed_model.loss_evaluator.projection":
                   np.zeros((12, 5), np.float32)}))  # ignored by name
    np.testing.assert_array_equal(
        model.embed_model.t_embed_layer.weight.detach().numpy(),
        sd["embed_model.t_embed_layer.weight"])
    missing = {k: v for k, v in sd.items() if k != "visual_model.bn1.bias"}
    with pytest.raises(KeyError, match="visual_model.bn1.bias"):
        load_reference_state_dict(tiny_model(), missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(tiny_model(), dict(sd, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="export_torch"):
        build_eval_model(tiny_cfg(), os.path.dirname(__file__),
                         device="cpu")
