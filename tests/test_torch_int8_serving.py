"""Int8-encoder serving of the full-CLIP model as a whole, on the CPU in f32
at a tiny size: a ViT (2 layers, width 128, 32x16 pixels in 8x8 patches) and
a CLIP text transformer (2 layers, width 128, 12 positions), built by both
packages' ``build_model`` from one YAML, the JAX parameters carried into the
port by ``state_dict_from_jax``.

``RetrievalIndex(int8_encode=True)`` and ``enable_int8_text`` on both sides,
from the same gallery and calibration batches: each package calibrates and
prepares for itself, so their int8 activations may differ by a step where an
abs-max differs in its last bits; gallery embeddings and scores agree to 5e-3
and the top-k is the same wherever two neighbouring scores are further apart
than that.  Int8-text search against float search: atol 0.02 on scores, 0.03
with a quantized gallery, the JAX package's own bounds.  Then the tools:
``build_index --int8-encode --quantize --text-calib-out`` and ``serve
--int8-text-calib`` through their ``main`` functions with ``--device cpu``,
and ``test_net`` on the float model.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.config import get_default_cfg as jax_default_cfg
from textreid_tpu.engine.state import TrainState
from textreid_tpu.models import build_model as jax_build_model
from textreid_tpu.serving import RetrievalIndex as JaxRetrievalIndex
from textreid_torch import test_net
from textreid_torch.config import get_default_cfg
from textreid_torch.data import make_synthetic_dataset
from textreid_torch.models import build_model
from textreid_torch.models.int8_vit import Int8Tower
from textreid_torch.models.text_transformer import TextTransformer
from textreid_torch.ops import int8_mm
from textreid_torch.serving import RetrievalIndex
from textreid_torch.tools import build_index, serve
from textreid_torch.utils.weight_convert import (
    load_reference_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)

from test_torch_isolation import person_search_logger  # noqa: F401

torch.set_num_threads(2)

TINY = """
MODEL:
  VISUAL_MODEL: "vit"
  TEXTUAL_MODEL: "transformer"
  NUM_CLASSES: 8
  VIT: {PATCH_SIZE: 8, WIDTH: 128, LAYERS: 2, HEADS: 4, OUTPUT_DIM: 32}
  TRANSFORMER: {ARCH: "", WIDTH: 128, LAYERS: 2, HEADS: 4, OUTPUT_DIM: 32,
                VOCAB_SIZE: 64, CONTEXT_LENGTH: 12}
  EMBEDDING: {EMBED_HEAD: "moco", FEATURE_SIZE: 32}
  MOCO: {FC: False}
INPUT: {HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: 12}
DATASETS:
  TEST: ("cuhkpedes_test", )
DATALOADER: {NUM_WORKERS: 2}
TEST: {IMS_PER_BATCH: 6}
"""
SCORE_TOL = 5e-3


def _cfg(factory, root):
    cfg = factory()
    cfg.merge_from_file(str(root / "configs" / "tiny" / "fullclip.yaml"))
    cfg.ROOT = str(root)
    cfg.freeze()
    return cfg


def _tokens(n, seed, seq=12, vocab=64, min_len=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (n, seq)).astype(np.int32)
    lens = rng.randint(min_len, seq + 1, (n,)).astype(np.int32)
    for row, ln in enumerate(lens):
        ids[row, ln:] = 0
    return ids, lens


def _gallery(seed, batches=3, rows=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (rows, 32, 16, 3), dtype=np.uint8)
            for _ in range(batches)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, config path, checkpoint path, JAX (model, state), port
    model)."""
    root = tmp_path_factory.mktemp("ws")
    make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                           num_identities=8, images_per_id=2,
                           image_size=(32, 16), vocab_size=64, max_tokens=10,
                           split="test", seed=1)
    (root / "configs" / "tiny").mkdir(parents=True)
    cfg_path = root / "configs" / "tiny" / "fullclip.yaml"
    cfg_path.write_text(TINY)

    jax_model = jax_build_model(_cfg(jax_default_cfg, root))
    ids, lens = _tokens(2, seed=0)
    variables = jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(_gallery(0, 1, 2)[0]),
        jnp.asarray(ids), jnp.asarray(lens), method="init_all")
    rng = np.random.RandomState(2)
    params = jax.tree.map(  # biases and LayerNorm affines off their constants
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*x.shape)).astype(
            np.float32), variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, constants={}, opt_state=None)

    model = build_model(_cfg(get_default_cfg, root), "cpu").eval()
    load_reference_state_dict(model, state_dict_from_jax({"params": params}))
    ckpt = str(root / "model.pth")
    save_reference_checkpoint(model, ckpt)
    return root, str(cfg_path), ckpt, (jax_model, state), model


def test_build_model_takes_the_text_transformer(workspace):
    model = workspace[4]
    assert isinstance(model.textual_model, TextTransformer)
    sd = model.state_dict()
    assert sd["textual_model.token_embedding.weight"].shape == (64, 128)
    assert sd["textual_model.transformer.resblocks.1.mlp.c_fc.weight"
              ].shape == (512, 128)
    assert sd["embed_model.t_embed_layer.weight"].shape == (32, 32)


def test_build_model_builds_the_full_clip_model_for_training(workspace):
    """``build_model(train=True)`` builds the full-CLIP model, in train
    mode, with the seeded weights of the serving build (its train step:
    ``tests/test_torch_train_fullclip.py``)."""
    cfg = _cfg(get_default_cfg, workspace[0])
    model = build_model(cfg, "cpu", train=True)
    assert model.training and model.textual_model.training
    assert isinstance(model.textual_model, TextTransformer)
    served = build_model(cfg, "cpu").state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(value, served[name]), name


def test_int8_encode_routes_a_vit_to_the_int8_tower(workspace):
    model = workspace[4]
    index = RetrievalIndex(model, int8_encode=True)
    assert index._int8_pending and index._int8_image_encoder is None
    seen = []
    real = int8_mm.int_matmul

    def spy(xq, w_q):
        seen.append(xq.dtype)
        return real(xq, w_q)

    with mock.patch.object(int8_mm, "int_matmul", spy):
        index.build_gallery(_gallery(3), meta=np.arange(15), valid_rows=14)
    assert not index._int8_pending
    assert isinstance(index._int8_image_tower, Int8Tower)
    # 3 batches x 2 blocks x 3 library products (K8 holds the fourth)
    assert len(seen) == 3 * 2 * 4 and set(seen) == {torch.int8}
    assert index.gallery.shape == (14, 32)
    # image queries take the calibrated tower too
    _, meta = index.search_by_image(_gallery(3)[0][:2], k=1)
    assert meta[:, 0].tolist() == [0, 1]
    with pytest.raises(ValueError, match="at least one batch"):
        RetrievalIndex(model, int8_encode="dataflow").build_gallery([])


def test_the_other_int8_encode_modes_name_their_roadmap_item(workspace):
    from textreid_torch.models.m_resnet import ModifiedResNet
    from textreid_torch.models.model import TextReIDModel

    model = workspace[4]
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        RetrievalIndex(model, int8_encode="intercept")
    conv = TextReIDModel(
        ModifiedResNet(layers=(1, 1, 1, 1), output_dim=16, heads=2,
                       last_stride=1, input_resolution=(64, 32), width=8),
        model.textual_model, feature_size=32)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        RetrievalIndex(conv, int8_encode=True)


def test_enable_int8_text_rejects_a_bigru(workspace):
    from textreid_torch.models import BiGRUEncoder
    from textreid_torch.models.model import TextReIDModel

    model = workspace[4]
    gru_model = TextReIDModel(model.visual_model, BiGRUEncoder(
        hidden_dim=8, vocab_size=30, embed_size=8), feature_size=32)
    index = RetrievalIndex(gru_model)
    with pytest.raises(NotImplementedError, match="TextTransformer"):
        index.enable_int8_text([_tokens(2, seed=4)])


@pytest.mark.parametrize("quantize,atol", [(False, 0.02), (True, 0.03)])
def test_int8_text_search_against_float_search(workspace, quantize, atol):
    model = workspace[4]
    batches = _gallery(5, batches=2)
    float_index = RetrievalIndex(model, query_batch=4)
    float_index.build_gallery(batches, meta=np.arange(10))
    index = RetrievalIndex(model, query_batch=4, quantize=quantize)
    index.build_gallery(batches, meta=np.arange(10))
    index.enable_int8_text([_tokens(8, seed=6)])
    ids, lens = _tokens(3, seed=7)
    vals_f, meta_f = float_index.search(ids, lens, k=5)
    vals_8, meta_8 = index.search(ids, lens, k=5)
    np.testing.assert_allclose(vals_8, vals_f, atol=atol)
    cos = (float_index.encode_queries(ids, lens)
           * index.encode_queries(ids, lens)).sum(axis=1)
    assert cos.min() > 0.999
    # the same ranking wherever the float scores are not a near-tie
    gaps = np.abs(np.diff(vals_f, axis=1)).min(axis=1)
    for row in np.nonzero(gaps > 2 * atol)[0]:
        assert meta_8[row].tolist() == meta_f[row].tolist()


def test_same_topk_as_the_jax_index(workspace):
    """Both packages: int8 gallery encode calibrated on the first batches,
    int8 text encode calibrated on the same captions."""
    _, _, _, (jax_model, state), model = workspace
    batches, calib = _gallery(8), [_tokens(8, seed=9)]
    jax_index = JaxRetrievalIndex(jax_model, state, query_batch=4,
                                  use_pallas=False, int8_encode=True)
    jax_index.build_gallery(batches, meta=np.arange(15))
    jax_index.enable_int8_text([(jnp.asarray(i), jnp.asarray(n))
                                for i, n in calib])
    index = RetrievalIndex(model, query_batch=4, int8_encode=True)
    index.build_gallery(batches, meta=np.arange(15))
    index.enable_int8_text(calib)
    np.testing.assert_allclose(index.gallery.numpy(),
                               np.asarray(jax_index.gallery), atol=SCORE_TOL)

    ids, lens = _tokens(6, seed=10)
    want_s, want_m = jax_index.search(ids, lens, k=5)
    got_s, got_m = index.search(ids, lens, k=5)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL)
    checked = 0
    for row in range(6):
        if np.abs(np.diff(want_s[row])).min() > 2 * SCORE_TOL:
            assert got_m[row].tolist() == want_m[row].tolist()
            checked += 1
    assert checked >= 1
    pixels = batches[1][:2]
    want_s, want_m = jax_index.search_by_image(pixels, k=3)
    got_s, got_m = index.search_by_image(pixels, k=3)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL)
    assert got_m[:, 0].tolist() == want_m[:, 0].tolist() == [5, 6]


def test_tools_build_an_int8_encoded_index_and_serve_int8_text(workspace):
    root, cfg_path, ckpt, _, model = workspace
    index_path, calib_path = str(root / "gallery.idx"), str(root / "calib.npz")
    common = ["--root", str(root), "--config-file", cfg_path,
              "--checkpoint-file", ckpt, "--device", "cpu", "--quantize"]
    built = build_index.main(common + [
        "--output", index_path, "--int8-encode", "--text-calib-out",
        calib_path, "--text-calib-rows", "12"])
    assert built._int8_image_encoder is not None
    assert built.gallery.shape == (16, 32)
    with np.load(calib_path) as calib:
        assert calib["token_ids"].shape == (12, 12)
        assert calib["lengths"].shape == (12,)
    with np.load(index_path) as data:
        assert data["quant_values"].shape == (16, 32)

    # the int8 gallery rows are the float tower's to quantization error
    float_index = RetrievalIndex(model)
    float_index.build_gallery(
        [b for b in _unique_batches(root, cfg_path)], valid_rows=16)
    cos = (float_index.gallery * built.gallery).sum(dim=1)
    assert cos.min() > 0.999

    service, server = serve.build_server(common + [
        "--index-file", index_path, "--int8-text-calib", calib_path,
        "--query-batch", "4", "--port", "0", "--k-buckets", "5,10"])
    try:
        assert service.index._int8_text_encoder is not None
        ids, lens = _tokens(3, seed=11)
        reply = service.search({"token_ids": ids.tolist(),
                                "lengths": lens.tolist(), "k": 5})
        assert np.asarray(reply["scores"]).shape == (3, 5)
        plain = RetrievalIndex(model, quantize=True)
        plain.load_index(index_path)
        vals, _ = plain.search(ids, lens, k=5)
        np.testing.assert_allclose(np.asarray(reply["scores"]), vals,
                                   atol=0.03)
    finally:
        server.server_close()


def _unique_batches(root, cfg_path):
    """The gallery batches ``build_index`` forms: one row per image id."""
    from textreid_torch.data import make_data_loader

    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_path)
    cfg.ROOT = str(root)
    cfg.freeze()
    seen, rows = set(), []
    for batch in make_data_loader(cfg, is_train=False)[0]:
        valid = batch.get("valid")
        n = int(valid.sum()) if valid is not None else len(batch["image_ids"])
        for i in range(n):
            if int(batch["image_ids"][i]) not in seen:
                seen.add(int(batch["image_ids"][i]))
                rows.append(np.asarray(batch["pixels"][i]))
    size = cfg.TEST.IMS_PER_BATCH
    rows += [rows[-1]] * (-len(rows) % size)
    return [np.stack(rows[s:s + size]) for s in range(0, len(rows), size)]


def test_calibration_chunks_pad_cut_and_batch_the_captions(tmp_path):
    from textreid_torch.tools.serve import calibration_chunks

    path = str(tmp_path / "calib.npz")
    ids, lens = _tokens(10, seed=12, seq=9)
    np.savez(path, token_ids=ids, lengths=lens)
    chunks, rows = calibration_chunks(path, 12, 4)
    assert rows == 8 and len(chunks) == 2
    assert chunks[0][0].shape == (4, 12) and chunks[0][1].shape == (4,)
    chunks, rows = calibration_chunks(path, 6, 16)  # fewer rows than a batch
    assert rows == 10 and chunks[0][0].shape == (10, 6)
    assert chunks[0][1].max() <= 6


def test_test_net_evaluates_the_float_full_clip_model(workspace):
    root, cfg_path, ckpt, _, _ = workspace
    top1 = test_net.main(["--root", str(root), "--config-file", cfg_path,
                          "--checkpoint-file", ckpt, "--device", "cpu"])
    assert set(top1) == {"cuhkpedes_test"}
    assert 0.0 <= top1["cuhkpedes_test"] <= 100.0


def test_entry_points_default_to_the_card_and_raise_without_one(workspace):
    """No ``--device``: ``cuda``, which fails when there is no card rather
    than carrying on on the CPU (the new options included)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    root, cfg_path, ckpt, _, _ = workspace
    common = ["--root", str(root), "--config-file", cfg_path,
              "--checkpoint-file", ckpt]
    with pytest.raises(RuntimeError, match="cuda"):
        test_net.main(common)
    with pytest.raises(RuntimeError, match="cuda"):
        build_index.main(common + ["--output", str(root / "never.idx"),
                                   "--int8-encode"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_server(common + [
            "--index-file", str(root / "gallery.idx"), "--int8-text-calib",
            str(root / "calib.npz")])
    assert not (root / "never.idx").exists()
