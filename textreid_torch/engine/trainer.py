"""Training loop (counterpart of ``textreid_tpu/engine/trainer.py``): the
epoch x step loop with the per-epoch learning rate, metrics read on the
host only at ``LOG_PERIOD`` boundaries (reading syncs with the card), the
``DEBUG_NANS`` check there, and ``torch.save`` checkpoints every
``CHECKPOINT_PERIOD`` epochs.

Not ported yet: evaluation during training (``SOLVER.EVALUATE_PERIOD > 0``
raises, ROADMAP Queue A item 5), checkpoint pruning
(``SOLVER.CHECKPOINT_KEEP > 0`` raises) and preemption saves (item 5).
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import time

import torch

from ..solver.build import set_learning_rate
from ..utils.meters import MetricLogger

# the loader's arrays a train step reads
BATCH_KEYS = ("pixels", "erase", "token_ids", "lengths", "pids")


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


def save_checkpoint(path: str, state, arguments: dict) -> None:
    """Model, key model, optimizer, queues and ``arguments`` (epoch,
    iteration) in one ``torch.save`` file, written atomically."""
    tmp = path + ".tmp"
    torch.save({**state.state_dict(), "meta": dict(arguments)}, tmp)
    os.replace(tmp, path)


def do_train(cfg, state, train_step, data_loader, lr_schedule,
             output_dir: str, arguments: dict, device,
             meters: MetricLogger = None):
    """Train ``state`` in place for the epochs left in ``arguments``;
    returns the meters."""
    if cfg.SOLVER.EVALUATE_PERIOD > 0:
        raise NotImplementedError(
            "evaluation during training (SOLVER.EVALUATE_PERIOD > 0) is not "
            "ported yet (ROADMAP Queue A item 5); pass "
            "SOLVER.EVALUATE_PERIOD 0")
    if cfg.SOLVER.CHECKPOINT_KEEP > 0:
        raise NotImplementedError(
            "pruning old checkpoints (SOLVER.CHECKPOINT_KEEP > 0) is not "
            "ported yet (ROADMAP Queue A item 5)")
    logger = logging.getLogger("PersonSearch.trainer")
    logger.info("Start training")
    meters = meters or MetricLogger()
    device = torch.device(device)
    max_epoch = int(arguments.get("max_epoch", cfg.SOLVER.NUM_EPOCHS))
    epoch = int(arguments.get("epoch", 0))
    iteration = int(arguments.get("iteration", 0))
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
            metrics = train_step(state, to_device(batch, device))
            if step % log_period == 0 or step == steps_per_epoch - 1:
                host = {k: float(v) for k, v in metrics.items()}
                if cfg.TPU.DEBUG_NANS:
                    bad = [k for k, v in host.items() if not math.isfinite(v)]
                    if bad:
                        raise FloatingPointError(
                            f"Non-finite training metrics at iteration "
                            f"{iteration}: {bad}")
                meters.update(**host)
            batch_time = time.time() - end
            end = time.time()
            meters.update(time=batch_time, data=data_time)
            if step % log_period == 0 or step == steps_per_epoch - 1:
                eta = datetime.timedelta(seconds=int(
                    meters.time.global_avg * (max_iter - iteration)))
                logger.info("eta: %s  epoch [%d][%d/%d]  %s  lr: %.6f", eta,
                            epoch, step, steps_per_epoch, meters, lr)
        period = cfg.SOLVER.CHECKPOINT_PERIOD
        if period and epoch % period == 0:
            save_checkpoint(os.path.join(output_dir, f"epoch_{epoch}.pth"),
                            state, arguments)
    total = time.time() - start
    logger.info("Total training time: %s (%.4f s / it)",
                datetime.timedelta(seconds=int(total)),
                total / max(max_iter, 1))
    return meters
