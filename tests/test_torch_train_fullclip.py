"""Full-CLIP training (a ViT + the CLIP text transformer, the family of
``moco_fullclip_vitb16_ls_bs128_2048.yaml``) against the JAX package, on
the CPU in f32, with the text half of a CLIP archive loaded as JAX's
``train_net.py`` loads it.

The archive: a seeded CLIP-layout state dict saved with ``torch.save``
(CLIP's 77-row positional table, a ``visual.*`` key beside the text
tower's, as a whole archive has them).  The yaml's visual tower is a
plain ``vit``, which has no CLIP archive of its own, so ``train_net``
takes the first of JAX's search order present: ``ViT-B-32.pt`` before
``RN50.pt``.  Both text towers (query and key) must hold what JAX's
``convert_clip_text`` makes of that file (carried over by
``state_dict_from_jax``'s layout), the positional table resampled to
``CONTEXT_LENGTH`` 12 (atol 1e-7), every other entry exactly.

Then two MoCo steps of both packages from one JAX state whose text towers
hold that archive (JAX: ``merge_pretrained``, as its ``train_net`` does),
both towers' attention through JAX's Pallas kernels in interpret mode and
the port's plain versions (K5 causal in the text tower), held as
``tests/test_torch_train_gru2l.py:assert_two_steps`` does (no BatchNorm:
every parameter at atol 1e-6, entries under the gradient floor within two
Adam steps; loss dicts at LOSS_RTOL, key model, queues, pointer).
"""

import numpy as np
import pytest
import torch

import jax

from textreid_tpu.models import TextReIDModel as JaxModel
from textreid_tpu.models.text_transformer import (
    TextTransformer as JaxTextTransformer,
)
from textreid_tpu.models.vit import VisionTransformer as JaxViT
from textreid_tpu.utils.weight_convert import (
    convert_clip_text,
    load_torch_state_dict,
    merge_pretrained,
)
from textreid_torch import train_net
from textreid_torch.data import make_synthetic_dataset
from textreid_torch.models.text_transformer import TextTransformer
from textreid_torch.utils import weight_convert

from test_torch_isolation import person_search_logger  # noqa: F401
from test_torch_train_gru2l import assert_two_steps, jax_start, port_start
from test_torch_train_step import CLASSES, K, TOKENS, VOCAB, make_batch

torch.set_num_threads(2)

WIDTH, LAYERS, HEADS = 32, 2, 2
TINY = f"""
MODEL:
  VISUAL_MODEL: "vit"
  TEXTUAL_MODEL: "transformer"
  NUM_CLASSES: {CLASSES}
  VIT: {{PATCH_SIZE: 8, WIDTH: 64, LAYERS: 2, HEADS: 2, OUTPUT_DIM: 32}}
  TRANSFORMER: {{ARCH: "", WIDTH: {WIDTH}, LAYERS: {LAYERS}, HEADS: {HEADS},
                OUTPUT_DIM: 32, VOCAB_SIZE: {VOCAB}, CONTEXT_LENGTH: 12}}
  EMBEDDING: {{EMBED_HEAD: "moco", FEATURE_SIZE: 32, EPSILON: 0.1}}
  MOCO: {{FC: False, K: {K}}}
INPUT: {{HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: {TOKENS}}}
DATASETS:
  TRAIN: ("cuhkpedes_train", )
DATALOADER: {{IMS_PER_ID: 4, NUM_WORKERS: 1}}
SOLVER: {{IMS_PER_BATCH: 8, NUM_EPOCHS: 0, EVALUATE_PERIOD: 0,
          WEIGHT_DECAY_BIAS: 0.01}}
"""


def clip_text_archive(seed):
    """A seeded CLIP state dict: the text tower at CLIP's 77 positions
    (``visual.*`` beside it)."""
    torch.manual_seed(seed)
    text = TextTransformer(vocab_size=VOCAB, context_length=77, width=WIDTH,
                           layers=LAYERS, heads=HEADS, output_dim=32)
    gen = torch.Generator().manual_seed(seed + 1)
    archive = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
               for k, v in text.state_dict().items()}
    archive["visual.proj"] = torch.zeros(4, 4)
    return archive


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                           num_identities=2, images_per_id=4,
                           image_size=(32, 16), vocab_size=VOCAB,
                           max_tokens=TOKENS, split="train")
    clip = root / "pretrained" / "clip"
    clip.mkdir(parents=True)
    torch.save(clip_text_archive(1), clip / "RN50.pt")
    torch.save(clip_text_archive(2), clip / "ViT-B-32.pt")
    (root / "fullclip.yaml").write_text(TINY)
    return root


def jax_text(path):
    """What JAX's ``train_net`` makes of the archive's text half."""
    return convert_clip_text(load_torch_state_dict(str(path)), LAYERS,
                             context_length=12)


def test_the_clip_text_half_loads_into_both_text_towers_as_jax_loads_it(
        workspace):
    state, _ = train_net.main(["--root", str(workspace), "--config-file",
                               str(workspace / "fullclip.yaml"),
                               "--device", "cpu"])
    want = {}
    weight_convert._textual(
        want, "", jax.tree.map(np.asarray, jax_text(
            workspace / "pretrained" / "clip" / "ViT-B-32.pt")["params"]))
    assert want["positional_embedding"].shape == (12, WIDTH)
    for model in (state.model, state.key_model):
        got = model.textual_model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "positional_embedding":
                np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                           atol=1e-7)
            else:
                assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k


def test_two_full_clip_moco_steps_match_jax(workspace, tmp_path):
    from textreid_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(workspace / "fullclip.yaml"))
    cfg.ROOT = str(tmp_path)
    batches = [make_batch(1), make_batch(2)]
    jax_model = JaxModel(
        visual=JaxViT(input_resolution=(32, 16), patch_size=8, width=64,
                      layers=2, heads=2, output_dim=32, fused_attention=True,
                      attn_interpret=True),
        textual=JaxTextTransformer(vocab_size=VOCAB, context_length=12,
                                   width=WIDTH, layers=LAYERS, heads=HEADS,
                                   output_dim=32, fused_attention=True,
                                   attn_interpret=True),
        feature_size=32, num_classes=CLASSES, embed_head="moco",
        moco_fc=False, pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD))
    jstate, jstep = jax_start(cfg, jax_model, batches)
    text = {"textual": jax_text(
        workspace / "pretrained" / "clip" / "ViT-B-32.pt")["params"]}
    jstate = jstate.replace(
        params=merge_pretrained({"params": jstate.params},
                                {"params": text})["params"],
        key_params=merge_pretrained({"params": jstate.key_params},
                                    {"params": text})["params"])
    tstate, tstep = port_start(cfg, jstate)
    assert isinstance(tstate.model.textual_model, TextTransformer)
    assert_two_steps(jstate, jstep, tstate, tstep, batches, trunk=())
