"""Batched data loading.

Counterpart of `reference/lib/data/build.py` +
`collate_batch.py` (the port's own copy of ``textreid_tpu/data/loader.py``:
numpy on the host; callers move batches to the device):

* ``make_data_loader(cfg, is_train)`` builds datasets from the catalog
  (train sets concatenated — build.py:36-41), wires the PK ``TripletSampler``
  for training (build.py:54-67) and a padded sequential loader for eval.
* Batches are dicts of stacked numpy arrays
  ``{pixels f32[B,H,W,3], token_ids i32[B,L], lengths, pids, image_ids,
  index, valid}`` — captions are padded in the pipeline, not inside the
  model (fixing the wart at reference gru.py:49-53 / SURVEY.md section 3.4).
* Eval batches are padded to a **fixed** batch size with repeated samples
  and a ``valid`` mask so every step sees the same shape; the
  reference instead emits a ragged final batch (build.py:89).
* Sample loading is overlapped with a thread pool (the reference uses 4
  DataLoader worker processes — build.py:104-109; PIL decode releases the
  GIL, so threads suffice without pickling overhead).
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from ..config.catalog import DatasetCatalog
from .datasets import ConcatDataset, CUHKPEDESDataset, ICFGPEDESDataset
from .sampler import TripletSampler
from .transforms import build_transforms

_FACTORIES = {
    "CUHKPEDESDataset": CUHKPEDESDataset,
    "ICFGPEDESDataset": ICFGPEDESDataset,
}


def _collate(samples: List[dict], valid: np.ndarray) -> dict:
    pixels = np.stack([s["pixels"] for s in samples])
    if pixels.dtype != np.uint8:
        pixels = pixels.astype(np.float32)
    batch = {
        "pixels": pixels,
        "erase": np.stack([s["erase"] for s in samples]),
        "token_ids": np.stack([s["token_ids"] for s in samples]),
        "lengths": np.stack([s["length"] for s in samples]),
        "pids": np.stack([s["pid"] for s in samples]),
        "image_ids": np.stack([s["image_id"] for s in samples]),
        "index": np.stack([s["index"] for s in samples]),
        "valid": valid,
    }
    return batch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler: Optional[TripletSampler] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_to_full: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        process_shard=None,
    ):
        """``process_shard=(rank, world)`` turns this into a per-host shard
        loader for multi-host training: batch *indices* are computed
        globally (identical on every process — samplers are deterministic
        in (seed, epoch)), but each process decodes only its contiguous
        slice of every batch.  Feed the result through
        ``parallel.mesh.shard_local_batch``.  This replaces the reference's
        DistributedSampler per-rank split (build.py:45-46) without each
        host paying the full global decode cost."""
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to_full = pad_to_full
        self.num_workers = max(1, num_workers)
        self._epoch = 0
        self._seed = seed
        self.process_shard = process_shard
        self._batch_shard = None  # (rank, world): see batch_shard

    def batch_shard(self, rank: int, world: int) -> "DataLoader":
        """A copy that yields batches ``rank, rank + world, ...`` of this
        loader's, whole: each process's share of an evaluation under data
        parallelism (its rows say which samples they are: ``index``)."""
        out = copy.copy(self)
        out._batch_shard = (rank, world)
        return out

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.batch_sampler is not None:
            self.batch_sampler.set_epoch(epoch)

    def _index_batches(self) -> List[List[int]]:
        if self.batch_sampler is not None:
            return list(iter(self.batch_sampler))
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState((self._seed * 9176 + self._epoch) % 2**31)
            rng.shuffle(order)
        bs = self.batch_size
        batches = [order[i : i + bs].tolist() for i in range(0, n, bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        if self._batch_shard is not None:
            rank, world = self._batch_shard
            batches = batches[rank::world]
        return batches

    def __len__(self) -> int:
        return len(self._index_batches())

    def _padded(self, batch_idx):
        idxs = list(batch_idx)
        valid = np.ones(len(idxs), dtype=bool)
        if self.pad_to_full and self.batch_size and len(idxs) < self.batch_size:
            pad = self.batch_size - len(idxs)
            idxs = idxs + [idxs[-1]] * pad
            valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
        return idxs, valid

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        epoch = self._epoch
        self._epoch += 1
        load = getattr(self.dataset, "load", None)
        counter = iter(range(1 << 60))
        with ThreadPoolExecutor(self.num_workers) as pool:
            # Per-sample futures; keep one batch in flight ahead of the
            # one being consumed (double-buffered host pipeline).
            def submit_one(i, pos=None):
                if load is None:
                    return pool.submit(self.dataset.__getitem__, i)
                # per-sample RNG: deterministic in (seed, epoch, position),
                # independent of worker-thread scheduling
                if pos is None:
                    pos = next(counter)
                sample_seed = (self._seed * 1_000_003 + epoch * 97 + pos) % 2**31
                return pool.submit(load, i, np.random.RandomState(sample_seed))

            def submit(bi, batch_idx):
                idxs, valid = self._padded(batch_idx)
                if self.process_shard is not None:
                    rank, world = self.process_shard
                    n = len(idxs)
                    if n % world != 0:
                        raise ValueError(
                            f"Global batch {n} not divisible by "
                            f"process count {world}"
                        )
                    ls = n // world
                    rows = range(rank * ls, (rank + 1) * ls)
                    # augmentation RNG keyed by GLOBAL position so the
                    # decoded samples are identical to an unsharded run
                    futs = [
                        submit_one(idxs[r], pos=bi * n + r) for r in rows
                    ]
                    return futs, valid[rank * ls : (rank + 1) * ls]
                return [submit_one(i) for i in idxs], valid

            pending = None
            for bi, batch_idx in enumerate(batches):
                nxt = submit(bi, batch_idx)
                if pending is not None:
                    futs, valid = pending
                    yield _collate([f.result() for f in futs], valid)
                pending = nxt
            if pending is not None:
                futs, valid = pending
                yield _collate([f.result() for f in futs], valid)


def build_dataset(cfg, dataset_names, transforms, is_train: bool):
    """Mirrors reference build.py:12-41."""
    if not isinstance(dataset_names, (list, tuple)):
        raise RuntimeError(f"dataset list expected, got {dataset_names!r}")
    tokenizer = None
    if not cfg.DATASETS.USE_ONEHOT:
        from .tokenizer import build_tokenizer

        tokenizer = build_tokenizer(cfg)
    datasets = []
    for name in dataset_names:
        spec = DatasetCatalog.get(cfg.ROOT, name)
        factory = _FACTORIES[spec["factory"]]
        datasets.append(
            factory(
                transforms=transforms,
                use_onehot=cfg.DATASETS.USE_ONEHOT,
                max_length=cfg.INPUT.MAX_TEXT_LENGTH,
                tokenizer=tokenizer,
                cache_images=cfg.DATALOADER.CACHE_IMAGES,
                **spec["args"],
            )
        )
    if not is_train:
        return datasets
    return [datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)]


def make_data_loader(cfg, is_train: bool = True, seed: Optional[int] = None,
                     process_shard=None):
    """Mirrors reference build.py:70-115.

    Returns a single loader for training, a list of loaders for eval.
    Batch sizes are *global*.

    ``process_shard=(rank, world)`` makes the *train* loader decode only
    this process's contiguous slice of every global batch (multi-host;
    pair with ``parallel.mesh.shard_local_batch``).  Eval loaders always
    produce full batches — eval is infrequent and its host-side metric
    assembly needs the full index/pid arrays on every process.
    """
    seed = cfg.SEED if seed is None else seed
    transforms = build_transforms(cfg, is_train,
                                  rng=np.random.RandomState(seed),
                                  device_prep=cfg.TPU.DEVICE_PREP)
    names = cfg.DATASETS.TRAIN if is_train else cfg.DATASETS.TEST
    datasets = build_dataset(cfg, names, transforms, is_train)

    if is_train:
        dataset = datasets[0]
        batch_size = cfg.SOLVER.IMS_PER_BATCH
        if cfg.DATALOADER.EN_SAMPLER:
            pids = [dataset.get_id_info(i)[1] for i in range(len(dataset))]
            sampler = TripletSampler(
                pids, batch_size, cfg.DATALOADER.IMS_PER_ID, seed=seed
            )
            return DataLoader(
                dataset, batch_sampler=sampler,
                num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
                process_shard=process_shard,
            )
        return DataLoader(
            dataset, batch_size=batch_size, shuffle=True, drop_last=True,
            num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
            process_shard=process_shard,
        )

    return [
        DataLoader(
            d, batch_size=cfg.TEST.IMS_PER_BATCH, shuffle=False,
            drop_last=False, pad_to_full=True,
            num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
        )
        for d in datasets
    ]
