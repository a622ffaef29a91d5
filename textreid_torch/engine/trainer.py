"""Training loop (counterpart of ``textreid_tpu/engine/trainer.py``): the
epoch x step loop with the per-epoch learning rate, metrics read on the
host only at ``LOG_PERIOD`` boundaries (reading syncs with the card), the
``DEBUG_NANS`` check there, and at the end of an epoch:

* every ``EVALUATE_PERIOD`` epochs, the query model evaluated on the first
  of ``DATASETS.TEST`` (``engine/inference.py:inference``, no re-ranking),
  in eval mode (BatchNorm on its running statistics) and under
  ``torch.inference_mode``, then back to train mode; its t2i R@1 goes to
  the meters as ``top1``, and a strictly better one than ``best_top1``
  saves ``best``;
* every ``CHECKPOINT_PERIOD`` epochs, ``epoch_N``, then pruning to the
  newest ``CHECKPOINT_KEEP``.

A SIGTERM (``utils/preempt.py``, ``TPU.PREEMPT_SAVE``) is acted on at the
next log boundary: ``preempt`` is saved with ``epoch`` pinned one back, so
that a resume runs the interrupted epoch again, and training returns.
However training ends, the checkpoint write in flight is waited for and
the SIGTERM handler uninstalled.

In a process group (``parallel/mesh.py``) every rank steps on its data
shard's rows of the global batch (the loader's ``process_shard``, or its
slice of the global batch when the loader gives the whole of it), sets the
epoch, evaluates (each data shard encoding its share of the batches) and
polls the preemption flag at the same iterations, so that no collective
waits on a rank that left; the meters and the log are rank 0's, and the
evaluation's R@1 is rank 0's on every rank, so the ``best`` decision
agrees.
"""

from __future__ import annotations

import datetime
import logging
import math
import time

import torch

from ..parallel.mesh import broadcast_object, data_rank, data_size
from ..solver.build import set_learning_rate
from ..utils.meters import MetricLogger
from ..utils.preempt import PreemptionGuard
from .inference import inference

# the loader's arrays a train step reads
BATCH_KEYS = ("pixels", "erase", "token_ids", "lengths", "pids")


def local_rows(batch: dict, loader) -> dict:
    """This rank's rows of ``batch`` (its data shard's, shard-major: the
    ranks of a model group hold the same rows), unless the loader decodes
    them alone (``process_shard``) or there is one data shard."""
    shards = data_size()
    if shards == 1 or getattr(loader, "process_shard", None) is not None:
        return batch
    n = batch["pids"].shape[0]
    if n % shards:
        raise ValueError(f"Global batch {n} not divisible by data-shard "
                         f"count {shards}")
    start = data_rank() * (n // shards)
    return {k: v[start:start + n // shards] for k, v in batch.items()}


def to_device(batch: dict, device: torch.device) -> dict:
    """The step's arrays as tensors on ``device``; host copies go through
    pinned memory so the transfer does not block the host."""
    out = {}
    for key in BATCH_KEYS:
        t = torch.from_numpy(batch[key])
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def evaluate(model, data_loader) -> float:
    """t2i R@1 of ``model`` on ``data_loader`` (the JAX trainer's call:
    no re-ranking, nothing saved), in eval mode; the model's mode is
    restored after."""
    training = model.training
    model.eval()
    try:
        return broadcast_object(float(inference(
            model, data_loader, dataset_name="val", save_data=False,
            rerank=False)))
    finally:
        model.train(training)


def do_train(cfg, state, train_step, data_loader, data_loader_val,
             checkpointer, meters: MetricLogger, lr_schedule,
             arguments: dict, device, preempt_guard=None) -> MetricLogger:
    """Train ``state`` in place for the epochs left in ``arguments``
    (``epoch``, ``iteration``, ``max_epoch``, ``best_top1``, updated as it
    goes); returns the meters.  ``data_loader_val`` is the list of
    evaluation loaders (empty: no evaluation)."""
    logger = logging.getLogger("PersonSearch.trainer")
    logger.info("Start training")
    if preempt_guard is None:
        preempt_guard = PreemptionGuard(enabled=bool(cfg.TPU.PREEMPT_SAVE))
    device = torch.device(device)
    try:
        max_epoch = int(arguments.get("max_epoch", cfg.SOLVER.NUM_EPOCHS))
        epoch = int(arguments.get("epoch", 0))
        iteration = int(arguments.get("iteration", 0))
        best_top1 = float(arguments.get("best_top1", 0.0))
        checkpoint_period = cfg.SOLVER.CHECKPOINT_PERIOD
        evaluate_period = cfg.SOLVER.EVALUATE_PERIOD
        steps_per_epoch = len(data_loader)
        max_iter = max_epoch * steps_per_epoch
        log_period = max(1, int(cfg.SOLVER.LOG_PERIOD))
        start = end = time.time()
        while epoch < max_epoch:
            data_loader.set_epoch(epoch)
            lr = lr_schedule(epoch)
            set_learning_rate(state.optimizer, lr)
            epoch += 1
            arguments["epoch"] = epoch
            for step, batch in enumerate(data_loader):
                data_time = time.time() - end
                iteration += 1
                arguments["iteration"] = iteration
                metrics = train_step(state, to_device(
                    local_rows(batch, data_loader), device))
                boundary = step % log_period == 0 or (
                    step == steps_per_epoch - 1)
                if boundary:
                    host = {k: float(v) for k, v in metrics.items()}
                    if cfg.TPU.DEBUG_NANS:
                        bad = [k for k, v in host.items()
                               if not math.isfinite(v)]
                        if bad:
                            raise FloatingPointError(
                                f"Non-finite training metrics at iteration "
                                f"{iteration}: {bad}")
                    meters.update(**host)
                batch_time = time.time() - end
                end = time.time()
                meters.update(time=batch_time, data=data_time)
                if boundary:
                    eta = datetime.timedelta(seconds=int(
                        meters.time.global_avg * (max_iter - iteration)))
                    logger.info("eta: %s  epoch [%d][%d/%d]  %s  lr: %.6f",
                                eta, epoch, step, steps_per_epoch, meters,
                                lr)
                    if preempt_guard.triggered_global():
                        logger.warning(
                            "Preemption signal at iteration %d; saving "
                            "'preempt' checkpoint and exiting", iteration)
                        checkpointer.save("preempt", state, **{
                            **arguments, "epoch": epoch - 1})
                        return meters  # finally: wait + uninstall

            if (evaluate_period and epoch % evaluate_period == 0
                    and data_loader_val):
                eval_start = time.time()
                top1 = evaluate(state.model, data_loader_val[0])
                logger.info("Evaluation after epoch %d: t2i R@1 %.4f in "
                            "%.3f s", epoch, top1, time.time() - eval_start)
                meters.update(top1=top1)
                if top1 > best_top1:
                    best_top1 = top1
                    arguments["best_top1"] = best_top1
                    checkpointer.save("best", state, **arguments)
                end = time.time()  # the next step's wait excludes it

            if checkpoint_period and epoch % checkpoint_period == 0:
                checkpointer.save(f"epoch_{epoch}", state, **arguments)
                checkpointer.prune_epochs(cfg.SOLVER.CHECKPOINT_KEEP)
                end = time.time()

        # the last write on disk, then the exact prune: during training a
        # write in flight is not counted, so KEEP + 1 files may be there
        checkpointer.wait()
        checkpointer.prune_epochs(cfg.SOLVER.CHECKPOINT_KEEP)
        total = time.time() - start
        logger.info("Total training time: %s (%.4f s / it)",
                    datetime.timedelta(seconds=int(total)),
                    total / max(max_iter, 1))
        return meters
    finally:
        checkpointer.wait()
        preempt_guard.uninstall()
