"""The port's data pipeline: the JAX package's loaders, shared as they are
(``textreid_tpu.data`` is numpy and PIL only).  Eval batches carry uint8
NHWC pixels, which the model normalizes on the device."""

from textreid_tpu.data import make_data_loader, make_synthetic_dataset

__all__ = ["make_data_loader", "make_synthetic_dataset"]
