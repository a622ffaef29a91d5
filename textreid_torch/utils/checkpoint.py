"""Training checkpoints (counterpart of ``textreid_tpu/utils/checkpoint.py
Checkpointer``) as ``torch.save`` files.

A checkpoint ``save_dir/<name>.pth`` holds what ``engine.state.TrainState.
state_dict`` gives (model, key model, optimizer, ``step``, queues, pointer)
and ``meta``, the trainer's progress (``epoch``, ``iteration``,
``max_epoch``, ``best_top1``): the JAX package keeps that in a
``.meta.json`` beside its orbax directory.  The names are the JAX
package's: ``best``, ``epoch_N`` and ``preempt``.

* Writes are atomic: a temporary file, then ``os.replace``.
* ``async_save=True`` (``TPU.ASYNC_CHECKPOINT``, as JAX's orbax
  ``AsyncCheckpointer``): the state is copied to the CPU on the caller's
  thread, so the next step's in-place updates cannot race the write, and
  written to disk on a background thread.  :meth:`Checkpointer.wait`
  blocks on that write; a save, a read and the end of training wait first.
  A failed write raises from the next ``wait``.
* ``prune_epochs(keep)`` keeps the newest ``keep`` ``epoch_N`` files and
  never touches ``best`` or ``preempt``.
* ``resume`` restores the whole state and returns ``meta``; ``load`` is a
  weights-only load (the model and, where the file has it, the key model).
  A file whose keys or shapes do not match the state exactly (a renamed
  module, a partial save, a DataParallel ``module.`` prefix) falls back to
  :func:`align_state_dict`, the longest-suffix key alignment of the JAX
  package's ``align_pytree``; a load that aligns nothing is refused.
* In a data-parallel group (``parallel/mesh.py``) every rank calls
  ``save`` at the same points and rank 0 alone writes (and prunes); a
  sharded state (a model axis, ZeRO-1) is written in the single-process
  layout, gathered by every rank, and split again when it is read, so a
  file loads into any mesh and into one process alike; every
  :meth:`Checkpointer.wait`, and so every save and read, ends in a barrier,
  so no rank reads ahead of a write that came before.  Every rank resumes
  from the same file onto its own device; :func:`auto_resume_path` is
  decided on rank 0 and broadcast.

An orbax directory of the JAX package is not read (this package imports
nothing of orbax): export it to a reference ``.pth`` with
``tools/export_torch.py``.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ..parallel.mesh import barrier, broadcast_object
from ..parallel.mesh import rank as process_rank

EPOCH_FILE = re.compile(r"epoch_(\d+)\.pth")


def align_state_dict(target: Dict[str, torch.Tensor], loaded: dict,
                     logger: Optional[logging.Logger] = None,
                     label: str = "", min_cover: float = 0.5,
                     stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Longest-suffix key alignment of ``loaded`` onto ``target``'s keys
    (flat ``state_dict`` keys, compared component-wise at ``.``): the
    counterpart of the JAX package's ``align_pytree``, with its contract.

    For each target key, the loaded key with the longest suffix overlap
    wins, provided it is the only one at that length and the shapes agree.
    A full match of the shorter key (a DataParallel ``module.`` prefix on
    either side) is always accepted; a partial one only when it spans at
    least two components covering ``min_cover`` of BOTH keys, so that a
    bare ``weight`` cannot alias an unrelated module's.  Unmatched entries
    keep their current values, with a warning on the
    ``PersonSearch.checkpoint`` logger.  ``stats``, when given, gains the
    ``matched`` and ``total`` counts.  Returns a dict with ``target``'s
    keys, in its order."""
    logger = logger or logging.getLogger("PersonSearch.checkpoint")
    where = f"[{label}]" if label else ""
    l_paths = {tuple(k.split(".")): k for k in loaded}

    def suffix_len(a: Tuple[str, ...], b: Tuple[str, ...]) -> int:
        n = 0
        while n < len(a) and n < len(b) and a[-1 - n] == b[-1 - n]:
            n += 1
        return n

    out, unmatched, n_matched = {}, [], 0
    for key, cur in target.items():
        path = tuple(key.split("."))
        candidates, best_len = [], 0
        for lpath in l_paths:
            n = suffix_len(path, lpath)
            if n > best_len:
                candidates, best_len = [lpath], n
            elif n == best_len and n > 0:
                candidates.append(lpath)
        best = None
        if len(candidates) == 1 and best_len > 0:
            lpath = candidates[0]
            if best_len == min(len(path), len(lpath)) or (
                    best_len >= 2 and best_len >= min_cover * len(path)
                    and best_len >= min_cover * len(lpath)):
                best = l_paths[lpath]
        if best is None:
            unmatched.append(key)
            out[key] = cur
            continue
        leaf = loaded[best]
        if tuple(leaf.shape) != tuple(cur.shape):
            logger.warning(
                "align%s: %s matched %s but shapes differ (%s vs %s); "
                "keeping initialization", where, key, best,
                tuple(leaf.shape), tuple(cur.shape))
            out[key] = cur
            continue
        if best != key:
            logger.warning("align%s: %s loaded from %s", where, key, best)
        n_matched += 1
        out[key] = leaf
    if unmatched:
        logger.warning(
            "align%s: %d leaves not found in checkpoint, kept "
            "initialization: %s", where, len(unmatched),
            ", ".join(unmatched[:10]))
    if stats is not None:
        stats["matched"] = stats.get("matched", 0) + n_matched
        stats["total"] = stats.get("total", 0) + len(target)
    return out


def _strict_match(module: torch.nn.Module, sd: dict) -> None:
    """Raise ``KeyError`` when ``sd``'s keys are not ``module``'s, and
    ``ValueError`` when a shape differs: the mismatches that send
    :meth:`Checkpointer.load` to the alignment."""
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    shapes = [f"{k} {tuple(sd[k].shape)} vs {tuple(v.shape)}"
              for k, v in want.items() if tuple(sd[k].shape) != tuple(v.shape)]
    if shapes:
        raise ValueError(f"shapes differ: {shapes[:8]}")


def refuse_directory(path: str) -> None:
    """Raise when ``path`` is a directory (an orbax checkpoint of the JAX
    package): reading one is not supported."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?): not supported; export it to a reference .pth with "
            "tools/export_torch.py")


def read_meta(path: str) -> dict:
    """The ``meta`` of a checkpoint file, without reading its tensors
    (they are memory-mapped, not loaded)."""
    return dict(torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True).get("meta", {}))


def epoch_checkpoints(save_dir: str) -> list:
    """``[(N, file name)]`` of the ``epoch_N.pth`` files, oldest first."""
    return sorted((int(m.group(1)), name) for name in os.listdir(save_dir)
                  if (m := EPOCH_FILE.fullmatch(name)))


def auto_resume_path(save_dir: str) -> Optional[str]:
    """What ``--resume-from auto`` resumes from (the JAX ``train_net.py``
    rule): the newest ``epoch_N.pth``, or ``preempt.pth`` when its meta
    iteration is strictly newer; ``None`` when there is neither.  Rank 0's
    answer on every rank."""
    return broadcast_object(_newest_checkpoint(save_dir)
                            if process_rank() == 0 else None)


def _newest_checkpoint(save_dir: str) -> Optional[str]:
    epochs = epoch_checkpoints(save_dir) if os.path.isdir(save_dir) else []
    path = os.path.join(save_dir, epochs[-1][1]) if epochs else None
    preempt = os.path.join(save_dir, "preempt.pth")
    if os.path.isfile(preempt) and int(
            read_meta(preempt).get("iteration", -1)) > (
            int(read_meta(path).get("iteration", -1)) if path else -1):
        path = preempt
    return path


class Checkpointer:
    def __init__(self, save_dir: str = "", async_save: bool = False,
                 logger: Optional[logging.Logger] = None):
        self.save_dir = os.path.abspath(save_dir) if save_dir else ""
        self.async_save = async_save
        self.logger = logger or logging.getLogger("PersonSearch.checkpoint")
        self.primary = process_rank() == 0  # writes and prunes
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.pth")

    def wait(self) -> None:
        """Block until the write in flight, if any, is on disk; raise its
        error if it failed; in a group, then meet every rank."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        barrier()

    def save(self, name: str, state, **meta) -> None:
        """Write ``state`` and ``meta`` to ``<name>.pth`` (in the background
        with ``async_save``; one write in flight at a time)."""
        if not self.save_dir:
            return
        self.wait()
        sharded = getattr(state, "sharding", None) is not None
        if not self.primary and not sharded:
            return
        start = time.perf_counter()
        # a sharded state is gathered to the single-process layout by every
        # rank (parallel/mesh.py:StateSharding)
        payload = {**state.state_dict(), "meta": dict(meta)}
        if not self.primary:
            return
        snapshot_s = time.perf_counter() - start
        path = self.path(name)
        if not self.async_save:
            self._write(payload, path, snapshot_s)
            return
        self._writer = threading.Thread(
            target=self._write_in_background, args=(payload, path, snapshot_s),
            name=f"checkpoint {name}")
        self._writer.start()

    def _write_in_background(self, payload, path, snapshot_s) -> None:
        try:
            self._write(payload, path, snapshot_s)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def _write(self, payload: dict, path: str, snapshot_s: float) -> None:
        start = time.perf_counter()
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self.logger.info(
            "Saved checkpoint %s: snapshot %.3f s, write %.3f s%s", path,
            snapshot_s, time.perf_counter() - start,
            " (in the background)" if self.async_save else "")

    def prune_epochs(self, keep: int) -> None:
        """Delete all but the newest ``keep`` ``epoch_N.pth``
        (``SOLVER.CHECKPOINT_KEEP``; 0 keeps all).  A write in flight is
        still a temporary file, so it is neither counted nor deleted."""
        if keep <= 0 or not self.save_dir or not self.primary:
            return
        for _, name in epoch_checkpoints(self.save_dir)[:-keep]:
            path = os.path.join(self.save_dir, name)
            self.logger.info("Pruning checkpoint %s", path)
            os.remove(path)

    def _read(self, path: str) -> dict:
        refuse_directory(path)
        self.wait()  # reads see every write that came before
        self.logger.info("Loading checkpoint from %s", path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def resume(self, path: str, state):
        """Restore the whole state (in place) from ``path``; returns
        ``(state, meta)``."""
        payload = self._read(path)
        state.load_state_dict(payload)
        return state, dict(payload.get("meta", {}))

    def load(self, path: str, state):
        """Weights-only load: the model and, where both the file and the
        state have one, the key model; the optimizer, queues and progress
        keep their values.

        A file whose keys or shapes do not match (and only that: a missing
        file or a read error propagates) falls back to
        :func:`align_state_dict`, as the JAX package's ``load`` falls back
        to ``align_pytree``: unmatched entries keep their values, a load
        that matched nothing raises ``ValueError`` before anything is
        written, and one that matched under half is logged as an error."""
        payload = self._read(path)
        pairs = [("model", state.model)]
        if state.key_model is not None and "key_model" in payload:
            pairs.append(("key_model", state.key_model))
        if getattr(state, "sharding", None) is not None:
            payload = {**payload, **{field: state.sharding.split_model(
                payload[field]) for field, _ in pairs}}
        try:
            for field, module in pairs:
                _strict_match(module, payload[field])
        except (KeyError, ValueError) as exc:
            self.logger.warning(
                "Strict load failed (%s: %s); falling back to "
                "longest-suffix key alignment", type(exc).__name__, exc)
            return self._load_aligned(path, payload, pairs, state)
        for field, module in pairs:
            module.load_state_dict(payload[field])
        return state

    def _load_aligned(self, path: str, payload: dict, pairs, state):
        stats: dict = {}
        aligned = [(module, align_state_dict(
            module.state_dict(), payload[field], self.logger, label=field,
            stats=stats)) for field, module in pairs]
        matched, total = stats.get("matched", 0), stats.get("total", 0)
        if total and matched == 0:
            raise ValueError(
                f"Aligned load of {path} matched 0/{total} weight leaves — "
                "refusing to return a pure-initialization state (wrong or "
                "corrupted checkpoint?)")
        if matched < 0.5 * total:
            self.logger.error(
                "Aligned load of %s matched only %d/%d weight leaves; the "
                "rest keep initialization — verify this is the intended "
                "checkpoint", path, matched, total)
        for module, sd in aligned:
            module.load_state_dict(sd)
        return state
