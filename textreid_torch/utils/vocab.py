"""Frozen token-embedding table loading (counterpart of
``textreid_tpu/utils/vocab.py``).

The ``.npy`` lookup tables (e.g. CLIP's token embedding exported as
``clip_vocab_vit.npy``) feed the bi-GRU when ``MODEL.GRU.ONEHOT != "yes"``.
"""

from __future__ import annotations

import logging
import os

import numpy as np

_VOCAB_FILES = {
    "bert_c4": "datasets/cuhkpedes/bert_vocab_c4.npy",
    "bert_l2": "datasets/cuhkpedes/bert_vocab_l2.npy",
    "clip_vit": "datasets/cuhkpedes/clip_vocab_vit.npy",
    "clip_rn50x4": "datasets/cuhkpedes/clip_vocab_rn50x4.npy",
}


def load_vocab_dict(root: str, use_onehot: str) -> np.ndarray:
    if use_onehot not in _VOCAB_FILES:
        raise NotImplementedError(f"Unknown vocab mode: {use_onehot}")
    return np.load(os.path.join(root, _VOCAB_FILES[use_onehot]))


def frozen_table_initializer(cfg):
    """Return a lazy loader for the frozen table, or None for learnable
    embeddings or the explicitly allowed random table.

    A missing table file raises unless ``cfg.TPU.ALLOW_RANDOM_VOCAB`` opts
    into the seeded random table (synthetic runs only): a mistyped
    ``--root`` must fail loudly, not serve garbage.
    """
    if cfg.MODEL.TEXTUAL_MODEL in ("transformer", "clip_transformer"):
        return None
    mode = cfg.MODEL.GRU.ONEHOT
    if mode == "yes":
        return None
    if mode not in _VOCAB_FILES:
        raise NotImplementedError(f"Unknown vocab mode: {mode}")
    root = cfg.ROOT
    path = os.path.join(root, _VOCAB_FILES[mode])
    if not os.path.exists(path):
        if cfg.TPU.ALLOW_RANDOM_VOCAB:
            logging.getLogger("PersonSearch.vocab").warning(
                "Frozen vocab table %s is missing; TPU.ALLOW_RANDOM_VOCAB "
                "substitutes a SEEDED RANDOM table — synthetic runs only.",
                path,
            )
            return None
        raise FileNotFoundError(
            f"MODEL.GRU.ONEHOT={mode!r} requires the frozen token-embedding "
            f"table at {path} (see DATA.md). Check --root, or set "
            f"TPU.ALLOW_RANDOM_VOCAB True to run with a random table "
            f"(synthetic/smoke runs only)."
        )
    return lambda: load_vocab_dict(root, mode)
