"""Caption tokenization for raw-sentence annotations.

The reference trains exclusively on pre-tokenized ``onehot`` id lists
(`reference/lib/data/datasets/cuhkpedes.py:42-45` with
``DATASETS.USE_ONEHOT=True``); its raw-``sentence`` path constructs a string
Caption the GRU cannot consume.  This adapter completes that capability:
CLIP's BPE tokenization producing ids compatible with the
``clip_vocab_vit.npy`` embedding table.

Zero-egress friendly: wraps ``transformers.CLIPTokenizer`` loaded from a
*local* tokenizer directory (vocab.json + merges.txt); nothing is
downloaded.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class CLIPTokenizerAdapter:
    def __init__(self, tokenizer_dir: str, max_length: int = 105):
        try:
            from transformers import CLIPTokenizer
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "transformers is required for raw-sentence tokenization"
            ) from e
        self.tokenizer = CLIPTokenizer.from_pretrained(tokenizer_dir)
        self.max_length = max_length

    def __call__(self, sentence: str):
        """Returns (ids[max_length] int32, length int)."""
        ids = self.tokenizer(
            sentence,
            truncation=True,
            max_length=self.max_length,
            add_special_tokens=True,
        )["input_ids"]
        out = np.zeros(self.max_length, dtype=np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    def batch(self, sentences: List[str]):
        ids = np.zeros((len(sentences), self.max_length), np.int32)
        lengths = np.zeros(len(sentences), np.int32)
        for i, s in enumerate(sentences):
            ids[i], lengths[i] = self(s)
        return ids, lengths


def build_tokenizer(cfg) -> Optional[CLIPTokenizerAdapter]:
    """Tokenizer for datasets with USE_ONEHOT=False; None when annotations
    are pre-tokenized."""
    if cfg.DATASETS.USE_ONEHOT:
        return None
    import os

    tok_dir = os.path.join(cfg.ROOT, "pretrained", "clip_tokenizer")
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            f"Raw-sentence datasets need a local CLIP tokenizer at {tok_dir} "
            f"(vocab.json + merges.txt)"
        )
    return CLIPTokenizerAdapter(tok_dir, cfg.INPUT.MAX_TEXT_LENGTH)
