"""Dataset name -> on-disk layout registry.

Mirrors the reference catalog (`reference/lib/config/paths_catalog.py:
6-34`) and extends it with ICFG-PEDES (a reference README TODO item).
"""

import os


class DatasetCatalog:
    DATA_DIR = "datasets"
    DATASETS = {
        "cuhkpedes_train": {
            "img_dir": "cuhkpedes",
            "ann_file": "cuhkpedes/annotations/train.json",
        },
        "cuhkpedes_val": {
            "img_dir": "cuhkpedes",
            "ann_file": "cuhkpedes/annotations/val.json",
        },
        "cuhkpedes_test": {
            "img_dir": "cuhkpedes",
            "ann_file": "cuhkpedes/annotations/test.json",
        },
        "icfgpedes_train": {
            "img_dir": "icfgpedes",
            "ann_file": "icfgpedes/annotations/train.json",
        },
        "icfgpedes_test": {
            "img_dir": "icfgpedes",
            "ann_file": "icfgpedes/annotations/test.json",
        },
    }

    @staticmethod
    def get(root: str, name: str) -> dict:
        if name not in DatasetCatalog.DATASETS:
            raise RuntimeError(f"Dataset not available: {name}")
        attrs = DatasetCatalog.DATASETS[name]
        factory = "ICFGPEDESDataset" if name.startswith("icfg") else "CUHKPEDESDataset"
        return {
            "factory": factory,
            "args": {
                "root": os.path.join(root, DatasetCatalog.DATA_DIR, attrs["img_dir"]),
                "ann_file": os.path.join(
                    root, DatasetCatalog.DATA_DIR, attrs["ann_file"]
                ),
            },
        }
