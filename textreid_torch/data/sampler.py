"""Identity-balanced PK batch sampler.

Counterpart of the reference ``TripletSampler``
(`reference/lib/data/samplers/triplet_batch_sampler.py`): every batch
contains ``P = batch_size // images_per_pid`` distinct person ids with
exactly ``K = images_per_pid`` instances each.  Invariants preserved:

* each pid's index list is shuffled then chunked into groups of K
  (triplet_batch_sampler.py:72-110);
* pids with fewer than K samples are padded by repetition
  (``repeat_interleave`` semantics of ``_split``, lines 10-35: [a,b] with
  K=4 -> [a,a,b,b]);
* trailing sub-K chunks are dropped (drop_last);
* batches are assembled by drawing P random pids with remaining chunks
  until fewer than P pids remain (``_merge``, lines 38-51).

The reference then re-permutes batch order to follow its base sampler
(lines 104-110) — a determinism detail with no distributional effect; here
batch order is a fresh shuffle per epoch.  All RNG is host-side numpy so the
device-side step stays pure (SURVEY.md section 7 hard-part (c)).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, List

import numpy as np


class TripletSampler:
    def __init__(
        self,
        pids_per_index: List[int],
        batch_size: int,
        images_per_pid: int,
        seed: int = 0,
    ):
        assert batch_size % images_per_pid == 0, (
            f"batch_size {batch_size} must be divisible by images_per_pid "
            f"{images_per_pid}"
        )
        self.batch_size = batch_size
        self.num_instances = images_per_pid
        self.num_pids_per_batch = batch_size // images_per_pid
        self.index_dict = defaultdict(list)
        for index, pid in enumerate(pids_per_index):
            self.index_dict[int(pid)].append(index)
        self.pids = sorted(self.index_dict.keys())
        if len(self.pids) < self.num_pids_per_batch:
            raise ValueError(
                f"Need at least {self.num_pids_per_batch} identities, have "
                f"{len(self.pids)}"
            )
        self._epoch = 0
        self._seed = seed

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _chunks_for_pid(self, rng, pid) -> List[List[int]]:
        idxs = np.array(self.index_dict[pid])
        rng.shuffle(idxs)
        k = self.num_instances
        if len(idxs) < k:
            times = -(-k // len(idxs))  # ceil
            idxs = np.repeat(idxs, times)  # repeat_interleave padding
        n_chunks = len(idxs) // k  # drop_last on the remainder
        return [idxs[i * k : (i + 1) * k].tolist() for i in range(n_chunks)]

    def _prepare_batches(self) -> List[List[int]]:
        rng = np.random.RandomState((self._seed * 1_000_003 + self._epoch) % 2**31)
        splits = {pid: self._chunks_for_pid(rng, pid) for pid in self.pids}
        available = [pid for pid in self.pids if splits[pid]]
        batches = []
        while len(available) >= self.num_pids_per_batch:
            chosen = rng.choice(len(available), self.num_pids_per_batch,
                                replace=False)
            batch: List[int] = []
            for pid in [available[c] for c in chosen]:
                batch.extend(splits[pid].pop(0))
            available = [pid for pid in available if splits[pid]]
            batches.append(batch)
        order = rng.permutation(len(batches))
        return [batches[i] for i in order]

    def __iter__(self) -> Iterator[List[int]]:
        batches = self._prepare_batches()
        self._epoch += 1
        return iter(batches)

    def __len__(self) -> int:
        # Materialize one epoch without advancing the epoch counter.
        return len(self._prepare_batches())
