"""Annotation-backed datasets (CUHK-PEDES, ICFG-PEDES).

Counterpart of `reference/lib/data/datasets/cuhkpedes.py` and
`concat_dataset.py`, torch-free.  Records follow the reference annotation
schema (cuhkpedes.py:37-54): ``file_path`` (image under ``<root>/imgs``),
``onehot`` (pre-tokenized token ids) or ``sentence``, ``id`` (person id) and
``image_id``.  Unlike the reference — which pads captions inside the model
(`gru.py:49-53`, the design wart called out in SURVEY.md section 3.4) — samples
come out of ``__getitem__`` as fixed-shape numpy arrays ready for stacking.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Sequence

import numpy as np
from PIL import Image


class CUHKPEDESDataset:
    def __init__(
        self,
        root: str,
        ann_file: str,
        use_onehot: bool = True,
        max_length: int = 105,
        transforms=None,
        tokenizer=None,
        cache_images: bool = False,
    ):
        self.root = root
        self.use_onehot = use_onehot
        self.max_length = max_length
        self.transforms = transforms
        self.tokenizer = tokenizer
        self.img_dir = os.path.join(root, "imgs")
        # optional decoded-image cache (DATALOADER.CACHE_IMAGES): index ->
        # full-size uint8 array, filled lazily, shared across epochs
        self.cache_images = cache_images
        self._img_cache = {} if cache_images else None

        with open(ann_file, "r") as f:
            dataset = json.load(f)
        if not isinstance(dataset, dict) or "annotations" not in dataset:
            raise ValueError(
                f"{type(self).__name__}: {ann_file} has no top-level "
                f"'annotations' list (reference schema: "
                f"lib/data/datasets/cuhkpedes.py:27-28); found "
                f"{sorted(dataset)[:8] if isinstance(dataset, dict) else type(dataset).__name__}"
            )
        self.dataset = dataset["annotations"]
        self._validate_schema(ann_file)

    def _validate_schema(self, ann_file: str) -> None:
        """Fail fast, at construction, with a message naming the file —
        instead of a bare KeyError raised later inside a loader worker
        thread (reference record schema: cuhkpedes.py:37-54)."""
        if not self.dataset:
            raise ValueError(f"{type(self).__name__}: {ann_file} has an "
                             f"empty 'annotations' list")
        first = self.dataset[0]
        required = ["file_path", "id", "image_id",
                    "onehot" if self.use_onehot else "sentence"]
        missing = [k for k in required if k not in first]
        if missing:
            raise ValueError(
                f"{type(self).__name__}: first record of {ann_file} is "
                f"missing required key(s) {missing}; expected the "
                f"CUHK-PEDES annotation schema {required} "
                f"(got keys {sorted(first)[:10]}). If this is a "
                f"differently-formatted release (e.g. the raw ICFG-PEDES/"
                f"SSAN layout), convert it with tools/convert_icfg.py, or "
                f"pass use_onehot=False with a tokenizer."
            )

    def __len__(self) -> int:
        return len(self.dataset)

    def _tokens(self, record) -> tuple:
        """Return (ids[max_length] int32, true length clipped to max_length)."""
        if self.use_onehot:
            raw = np.asarray(record["onehot"], dtype=np.int32)
        elif self.tokenizer is not None:
            ids, length = self.tokenizer(record["sentence"])
            return ids, length
        else:
            raise ValueError(
                "Raw-sentence records require a tokenizer; see "
                "textreid_torch.data.tokenizer.CLIPTokenizerAdapter"
            )
        length = min(len(raw), self.max_length)
        out = np.zeros(self.max_length, dtype=np.int32)
        out[:length] = raw[:length]
        return out, length

    def __getitem__(self, index: int) -> dict:
        return self.load(index)

    def load(self, index: int, rng=None) -> dict:
        """Load one sample; ``rng`` makes augmentation deterministic per
        (seed, epoch, position) regardless of worker-thread scheduling."""
        record = self.dataset[index]
        if self._img_cache is not None and index in self._img_cache:
            img = Image.fromarray(self._img_cache[index])
        else:
            img = Image.open(
                os.path.join(self.img_dir, record["file_path"])
            ).convert("RGB")
            if self._img_cache is not None:
                self._img_cache[index] = np.asarray(img, dtype=np.uint8)
        erase = np.zeros(5, dtype=np.int32)
        if self.transforms is not None:
            img, erase = self.transforms(img, rng)
        token_ids, length = self._tokens(record)
        return {
            "pixels": img,  # [H, W, 3] uint8 (device_prep) or float32
            "erase": erase,  # [5] int32 [apply, top, left, h, w]
            "token_ids": token_ids,  # [max_length] int32
            "length": np.int32(length),
            "pid": np.int32(record["id"]),
            "image_id": np.int32(record["image_id"]),
            "index": np.int32(index),
        }

    def get_id_info(self, index: int):
        record = self.dataset[index]
        return record["image_id"], record["id"]


class ICFGPEDESDataset(CUHKPEDESDataset):
    """ICFG-PEDES in CUHK-PEDES-converted annotations; the reference README
    lists this dataset as a TODO ('Experiments on other datasets').  The
    published release (SSAN layout: one raw JSON with captions/
    processed_tokens/split per record) is converted to this schema by
    ``tools/convert_icfg.py`` — the constructor-time schema validation
    (``_validate_schema``) rejects un-converted files up front with that
    hint instead of a KeyError deep in a worker thread."""


class ConcatDataset:
    """Concatenation with ``get_id_info`` passthrough (reference
    concat_dataset.py:13-23)."""

    def __init__(self, datasets: Sequence):
        assert datasets, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[
            dataset_idx - 1
        ]
        return dataset_idx, sample_idx

    def __getitem__(self, idx: int):
        return self.load(idx)

    def load(self, idx: int, rng=None):
        d, s = self._locate(idx)
        item = self.datasets[d].load(s, rng)
        item["index"] = np.int32(idx)
        return item

    def get_id_info(self, idx: int):
        d, s = self._locate(idx)
        return self.datasets[d].get_id_info(s)


def make_synthetic_dataset(
    out_dir: str,
    num_identities: int = 8,
    images_per_id: int = 4,
    captions_per_image: int = 1,
    image_size=(64, 32),
    vocab_size: int = 100,
    max_tokens: int = 20,
    seed: int = 0,
    split: str = "train",
) -> str:
    """Write a tiny CUHK-PEDES-schema dataset for tests/smoke runs.

    Returns the dataset root (images under ``<root>/imgs``, annotations under
    ``<root>/annotations/<split>.json``).
    """
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "imgs")
    ann_dir = os.path.join(out_dir, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    annotations = []
    image_id = 0
    for pid in range(num_identities):
        for j in range(images_per_id):
            fname = f"p{pid:03d}_{j}.jpg"
            arr = rng.randint(0, 255, (*image_size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, fname))
            for _ in range(captions_per_image):
                n_tok = int(rng.randint(3, max_tokens))
                tokens = rng.randint(1, vocab_size, size=n_tok).tolist()
                annotations.append(
                    {
                        "file_path": fname,
                        "onehot": tokens,
                        "id": pid,
                        "image_id": image_id,
                    }
                )
            image_id += 1

    ann_path = os.path.join(ann_dir, f"{split}.json")
    with open(ann_path, "w") as f:
        json.dump({"annotations": annotations}, f)
    return out_dir
