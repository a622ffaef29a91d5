#!/usr/bin/env python
"""Convert the published ICFG-PEDES annotation release to the CUHK-PEDES
annotation schema (the port's copy of the repository's
``tools/convert_icfg.py``: the same CLI, byte-identical output).

The ICFG-PEDES release (SSAN, Ding et al. 2021) ships a single
``ICFG-PEDES.json`` modeled on CUHK-PEDES's *raw* ``reid_raw.json``:
records carry ``id`` / ``file_path`` / ``captions`` (list of strings) /
``processed_tokens`` (list of word lists) / ``split``, either as one flat
list or as a dict keyed by split.  The reference framework, and this
package (``data/datasets.py:ICFGPEDESDataset``), read the *converted*
per-split schema instead: a ``{"annotations": [...]}`` file per split whose
records have ``file_path``, ``onehot`` (integer token ids), ``id`` and
``image_id``.

This tool performs that conversion:

* one output record per caption;
* ``onehot`` ids come from a vocabulary built over the TRAIN split's tokens
  (frequency-ordered, id 0 reserved for padding/<unk> — the embedding
  table's convention in ``models/gru.py``), written next to the
  annotations as ``vocab.json`` (word -> id, usable by
  ``server.SimpleTokenizer``);
* train person ids are remapped to contiguous ``[0, num_train_ids)`` so they
  can index the instance-loss classifier directly (``MODEL.NUM_CLASSES``);
  test/val ids keep their release values (they are only compared for
  equality by the evaluator);
* ``image_id`` is assigned sequentially per unique ``file_path`` within a
  split (the evaluator dedupes the gallery by it).

Usage::

    python -m textreid_torch.tools.convert_icfg ICFG-PEDES.json \\
        datasets/icfgpedes [--min-count 2] [--max-length 100]

writes ``datasets/icfgpedes/annotations/{train,test[,val]}.json`` and
``datasets/icfgpedes/annotations/vocab.json``; images are expected under
``datasets/icfgpedes/imgs/<file_path>`` (symlink the release's image root
there).  It reads and writes JSON only: no tensors, no ``--device``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")


def tokenize(caption: str) -> list:
    """Lowercase word tokenizer for records without ``processed_tokens``."""
    return _WORD_RE.findall(caption.lower())


def _record_tokens(rec: dict) -> list:
    """Per-caption word lists for one release record."""
    toks = rec.get("processed_tokens")
    if toks:
        # some releases wrap a single caption's tokens as a flat list
        if toks and isinstance(toks[0], str):
            toks = [toks]
        return [[str(w).lower() for w in cap] for cap in toks]
    caps = rec.get("captions", [])
    if isinstance(caps, str):
        caps = [caps]
    return [tokenize(c) for c in caps]


def _record_sentences(rec: dict, n: int) -> list:
    caps = rec.get("captions", [])
    if isinstance(caps, str):
        caps = [caps]
    caps = [str(c) for c in caps]
    return (caps + [""] * n)[:n]


def load_release(path: str) -> dict:
    """Read the release file into ``{split: [records]}``.

    Accepts the flat-list layout (each record carries ``split``) and the
    dict-keyed-by-split layout; split names are normalized to
    train/val/test.
    """
    with open(path) as f:
        raw = json.load(f)
    by_split = collections.defaultdict(list)
    if isinstance(raw, dict):
        # either {"train": [...], ...} or a single wrapper key
        items = raw.items()
        if set(raw) - {"train", "val", "test", "query", "gallery"}:
            if len(raw) == 1:
                (_, inner), = raw.items()
                if not isinstance(inner, list):
                    raise ValueError(
                        f"{path}: unrecognized wrapper layout "
                        f"(keys {sorted(raw)[:8]})")
                raw = inner
                items = None
            else:
                raise ValueError(
                    f"{path}: unrecognized dict layout (keys "
                    f"{sorted(raw)[:8]}); expected split-keyed lists or a "
                    f"flat record list")
        if items is not None:
            for split, recs in items:
                by_split[_norm_split(split)].extend(recs)
            return dict(by_split)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a list of records or a "
                         f"split-keyed dict, got {type(raw).__name__}")
    for rec in raw:
        by_split[_norm_split(rec.get("split", "train"))].append(rec)
    return dict(by_split)


def _norm_split(split: str) -> str:
    s = str(split).lower()
    if s in ("train", "trainval"):
        return "train"
    if s in ("val", "valid", "validation"):
        return "val"
    if s in ("test", "query", "gallery"):
        return "test"
    raise ValueError(f"unknown split name {split!r}")


def build_vocab(records: list, min_count: int = 1) -> dict:
    """Frequency-ordered word -> id table over the train captions; id 0 is
    reserved for padding/<unk> (``models/gru.py`` embeds id 0 as the pad
    row)."""
    counts = collections.Counter()
    for rec in records:
        for cap in _record_tokens(rec):
            counts.update(cap)
    words = [w for w, c in counts.most_common() if c >= min_count]
    return {w: i + 1 for i, w in enumerate(words)}


def convert(release_path: str, out_root: str, min_count: int = 1,
            max_length: int = 0) -> dict:
    """Run the conversion; returns ``{split: num_records}`` for reporting."""
    by_split = load_release(release_path)
    if "train" not in by_split:
        raise ValueError(f"{release_path}: no train split found "
                         f"(splits: {sorted(by_split)})")
    vocab = build_vocab(by_split["train"], min_count=min_count)

    ann_dir = os.path.join(out_root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)

    train_pid_map = {}
    written = {}
    dropped = {}
    for split, records in sorted(by_split.items()):
        annotations = []
        image_ids = {}
        for rec in records:
            fp = rec["file_path"]
            pid = int(rec["id"])
            if split == "train":
                pid = train_pid_map.setdefault(pid, len(train_pid_map))
            image_id = image_ids.setdefault(fp, len(image_ids))
            token_lists = _record_tokens(rec)
            sentences = _record_sentences(rec, len(token_lists))
            if not token_lists:
                # The CUHK schema has no caption-less records, and the
                # evaluator derives its gallery from annotation image_ids
                # — silently skipping these would shrink the gallery and
                # inflate retrieval metrics.  Count and warn loudly.
                dropped[split] = dropped.get(split, 0) + 1
                continue
            for cap, sentence in zip(token_lists, sentences):
                onehot = [vocab.get(w, 0) for w in cap]
                if max_length:
                    onehot = onehot[:max_length]
                annotations.append({
                    "file_path": fp,
                    "onehot": onehot,
                    "sentence": sentence,
                    "id": pid,
                    "image_id": image_id,
                })
        out_path = os.path.join(ann_dir, f"{split}.json")
        with open(out_path, "w") as f:
            json.dump({"annotations": annotations}, f)
        written[split] = len(annotations)

    with open(os.path.join(ann_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    written["num_train_ids"] = len(train_pid_map)
    written["vocab_size"] = len(vocab) + 1  # + pad/<unk> id 0
    if dropped:
        written["dropped_captionless"] = dropped
        print(
            f"WARNING: dropped caption-less records (cannot be represented "
            f"in the CUHK schema; their images will be MISSING from the "
            f"converted gallery): {dropped}", file=sys.stderr)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("release", help="path to ICFG-PEDES.json")
    parser.add_argument("out_root", help="dataset root to write "
                        "annotations/ under")
    parser.add_argument("--min-count", type=int, default=1,
                        help="drop words rarer than this from the vocab "
                        "(they map to <unk>=0)")
    parser.add_argument("--max-length", type=int, default=0,
                        help="clip captions to this many tokens (0 = keep)")
    args = parser.parse_args(argv)
    stats = convert(args.release, args.out_root, args.min_count,
                    args.max_length)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
