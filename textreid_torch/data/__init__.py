"""The host-side data pipeline of the port: its own copy of
``textreid_tpu/data`` (numpy and PIL only).  Batches are numpy arrays;
the callers move them to the device."""

from .datasets import (
    ConcatDataset,
    CUHKPEDESDataset,
    ICFGPEDESDataset,
    make_synthetic_dataset,
)
from .loader import DataLoader, build_dataset, make_data_loader
from .sampler import TripletSampler
from .transforms import Transform, build_transforms

__all__ = [
    "CUHKPEDESDataset",
    "ICFGPEDESDataset",
    "ConcatDataset",
    "make_synthetic_dataset",
    "DataLoader",
    "build_dataset",
    "make_data_loader",
    "TripletSampler",
    "Transform",
    "build_transforms",
]
