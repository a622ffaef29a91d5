"""Canonical flagship model configs (the port's own copy of
``textreid_tpu/config/flagship.py``).

The flagship MoCo config (the reference's headline experiment,
``configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml`` shapes —
reference ``configs/cuhkpedes`` SOLVER/MODEL blocks) is built by one
constructor, so that every harness measures the same model.

``variant`` selects the model family:

* ``""``         — CLIP-RN50 visual + bi-GRU textual (the flagship);
* ``"vit"``      — ViT-B/16 visual + bi-GRU textual (stretch backbone,
                   ``configs/cuhkpedes/moco_gru_clipvitb16_ls_bs128_2048``);
* ``"fullclip"`` — ViT-B/16 + CLIP text transformer (the full-CLIP
                   flagship, ``configs/cuhkpedes/moco_fullclip_vitb16_*``).
"""

from __future__ import annotations

import numpy as np

VARIANTS = ("", "vit", "fullclip")


def flagship_cfg(variant: str = "", fused_attention: bool = False,
                 attn_mode: str = "", tokens: int = 105):
    """Build the flagship config tree for synthetic harnesses.

    ``fused_attention`` turns on the fused attention kernels
    (``TPU.FUSED_ATTENTION``); it requires a transformer variant — on the
    RN50+bi-GRU flagship the gate would be a silent no-op and any artifact
    tagged with it a lie.  ``attn_mode`` (optional) forces one lowering on
    BOTH towers, overriding the per-tower defaults in config/defaults.py.
    """
    from . import get_default_cfg

    if variant not in VARIANTS:
        raise ValueError(
            f"unknown flagship variant {variant!r} (expected one of "
            f"{VARIANTS})")
    cfg = get_default_cfg()
    # synthetic harnesses have no clip_vocab_vit.npy on disk — opt into
    # the fixed random frozen table explicitly (utils/vocab.py contract)
    cfg.TPU.ALLOW_RANDOM_VOCAB = True
    cfg.MODEL.VISUAL_MODEL = "m_resnet50"
    cfg.MODEL.TEXTUAL_MODEL = "bigru"
    cfg.MODEL.GRU.ONEHOT = "clip_vit"
    cfg.MODEL.GRU.VOCABULARY_SIZE = 512
    cfg.MODEL.RESNET.RES5_STRIDE = 1
    cfg.MODEL.EMBEDDING.EMBED_HEAD = "moco"
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 256
    cfg.MODEL.EMBEDDING.EPSILON = 0.1
    cfg.MODEL.MOCO.FC = False
    cfg.MODEL.MOCO.K = 2048
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 384, 128
    # CLIP pixel stats, as in every clip-backbone reference YAML
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    if variant in ("vit", "fullclip"):
        cfg.MODEL.VISUAL_MODEL = "clip_vit_b16"
    if variant == "fullclip":
        cfg.MODEL.TEXTUAL_MODEL = "transformer"
        cfg.MODEL.TRANSFORMER.ARCH = "clip_text_b16"
        cfg.MODEL.TRANSFORMER.VOCAB_SIZE = 49408
        cfg.MODEL.TRANSFORMER.CONTEXT_LENGTH = tokens
    if fused_attention:
        if not variant:
            raise ValueError(
                "fused_attention requires variant 'vit' or 'fullclip' — "
                "the RN50+bi-GRU flagship has no transformer tower, so the "
                "gate would be a no-op")
        cfg.TPU.FUSED_ATTENTION = True
        if attn_mode:
            cfg.TPU.FUSED_ATTENTION_MODE = attn_mode
            cfg.TPU.FUSED_ATTENTION_TEXT_MODE = attn_mode
    return cfg


def flagship_batch(batch_size: int = 128, tokens: int = 105,
                   seed: int = 0) -> dict:
    """The synthetic device batch every train-step bench/profile uses:
    uint8 NHWC pixels (normalize+erase run on device, models/model.py),
    padded token ids + lengths, person ids at the CUHK-PEDES class count.
    """
    rng = np.random.RandomState(seed)
    return {
        "pixels": rng.randint(0, 255, (batch_size, 384, 128, 3),
                              dtype=np.uint8),
        "erase": np.zeros((batch_size, 5), np.int32),
        "token_ids": rng.randint(1, 512,
                                 (batch_size, tokens)).astype(np.int32),
        "lengths": rng.randint(10, tokens,
                               (batch_size,)).astype(np.int32),
        "pids": rng.randint(0, 11003, (batch_size,)).astype(np.int32),
    }
