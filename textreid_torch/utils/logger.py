"""Hierarchical logger (counterpart of ``textreid_tpu/utils/logger.py``):
"PersonSearch.*" namespace, stdout + ``log.txt``, silent on non-primary
processes."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(
    name: str = "PersonSearch",
    save_dir: str = "",
    process_index: int = 0,
    filename: str = "log.txt",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if process_index > 0 or logger.handlers:
        return logger

    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename), mode="w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
