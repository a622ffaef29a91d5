"""Input-pipeline throughput: the port's training loader in images a second
on a synthetic split, against the demand of the flagship's train step.

Counterpart of the repository's ``tools/bench_loader.py``: one synthetic
CUHK-PEDES-schema train split (JPEGs of ``--raw-height`` x ``--raw-width``
on disk), then the train path end to end on the host (decode -> resize ->
augment -> collate, the PK ``TripletSampler``, ``--num-workers`` threads;
``data/loader.py``), each batch copied to ``--device`` as the trainer copies
it (``engine/trainer.py:to_device``), epoch by epoch: epoch 1 is the cold
(decode-bound) number, later epochs with ``DATALOADER.CACHE_IMAGES`` show
the decoded-image cache.  Each epoch's rate is timed from the first
batch's arrival to the last's, over the images after the first batch, so
that starting the threads and filling the pipeline do not count (the
whole epoch's rate and the first batch's wait are reported beside it); an
epoch needs two batches at least.  The reference's torch ``DataLoader`` half of the
repository tool (and its ``--skip-reference``) is not part of this
package: it runs the upstream code, which the port does not carry.

    python -m textreid_torch.tools.bench_loader --ids 64 --imgs-per-id 4 \
        --batch 32 --epochs 3 [--step-ms 85] [--output loader.json] \
        [--device cuda|cpu]

``--step-ms`` (none by default) states the step time the loader must keep
up with: the JSON then gives the demand, the flagship step's 128 images
over that time, beside the measured rates.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

FLAGSHIP_BATCH = 128


def build_cfg(root, batch, height, width, num_workers):
    from ..config import get_default_cfg

    cfg = get_default_cfg()
    cfg.ROOT = root
    cfg.DATASETS.TRAIN = ("cuhkpedes_train",)
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = height, width
    cfg.INPUT.USE_AUG = True
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.DATALOADER.IMS_PER_ID = 4
    cfg.DATALOADER.NUM_WORKERS = num_workers
    return cfg


def bench_loader(cfg, epochs, device, cache=False):
    """Per epoch of the train loader, batches delivered on ``device``:
    {"steady": img/s after the first batch, "whole": img/s over the whole
    epoch, "first": seconds to the first batch, "batches": batches}, each
    a list over the epochs."""
    import torch

    from ..data import make_data_loader
    from ..engine.trainer import to_device

    if cache:
        cfg = cfg.clone()
        cfg.DATALOADER.CACHE_IMAGES = True
    loader = make_data_loader(cfg, is_train=True, seed=0)

    def arrived():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    out = {"steady": [], "whole": [], "first": [], "batches": []}
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = n_first = batches = 0
        for batch in loader:
            n += int(to_device(batch, device)["pixels"].shape[0])
            batches += 1
            if not n_first:
                n_first, t_first = n, arrived()
        t_end = arrived()
        if batches < 2:
            raise ValueError(f"epoch {epoch + 1} gave {batches} batch: the "
                             "rate is timed after the first")
        out["steady"].append((n - n_first) / (t_end - t_first))
        out["whole"].append(n / (t_end - t0))
        out["first"].append(t_first - t0)
        out["batches"].append(batches)
    return out


def warm(rates):
    return max(rates[1:]) if len(rates) > 1 else rates[0]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="the training loader's img/s on a synthetic split")
    parser.add_argument("--ids", type=int, default=64)
    parser.add_argument("--imgs-per-id", type=int, default=4)
    parser.add_argument("--raw-height", type=int, default=300)
    parser.add_argument("--raw-width", type=int, default=100,
                        help="on-disk JPEG size (CUHK-PEDES crops are "
                        "~100x300 pedestrians)")
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--step-ms", type=float, default=None,
                        help="a flagship step time in ms: report the "
                        f"demand, {FLAGSHIP_BATCH} images over it")
    parser.add_argument("--output", default="",
                        help="write the result JSON here")
    parser.add_argument("--device", default="cuda",
                        help="where batches are delivered; 'cuda' raises "
                        "without a card")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ..data import make_synthetic_dataset
    from ..utils.platform import require_cuda

    device = require_cuda(args.device)
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(
            os.path.join(root, "datasets", "cuhkpedes"),
            num_identities=args.ids, images_per_id=args.imgs_per_id,
            image_size=(args.raw_height, args.raw_width), max_tokens=60,
            vocab_size=5000, split="train", seed=0)
        cfg = build_cfg(root, args.batch, args.height, args.width,
                        args.num_workers)
        cold = bench_loader(cfg, args.epochs, device)
        cached = bench_loader(cfg, args.epochs, device, cache=True)

    demand = (FLAGSHIP_BATCH / (args.step_ms / 1e3) if args.step_ms
              else None)
    result = {
        "n_images": args.ids * args.imgs_per_id,
        "raw_size": [args.raw_height, args.raw_width],
        "target_size": [args.height, args.width],
        "batch": args.batch,
        "batches_per_epoch": cold["batches"][0],
        "num_workers": args.num_workers,
        "host_cpus": os.cpu_count(),
        "epochs": args.epochs,
        "device": str(device),
        "ours_steady_imgs_per_s_by_epoch": cold["steady"],
        "ours_imgs_per_s_by_epoch": cold["whole"],
        "first_batch_s_by_epoch": cold["first"],
        "ours_cold_imgs_per_s": cold["steady"][0],
        "ours_warm_imgs_per_s": warm(cold["steady"]),
        "ours_cached_steady_imgs_per_s_by_epoch": cached["steady"],
        "ours_cached_imgs_per_s_by_epoch": cached["whole"],
        "cached_first_batch_s_by_epoch": cached["first"],
        "ours_cached_warm_imgs_per_s": warm(cached["steady"]),
        "step_ms": args.step_ms,
        "demand_imgs_per_s": demand,
        "cold_over_demand": (cold["steady"][0] / demand if demand
                             else None),
        "notes": [
            "steady: img/s from the first batch's arrival to the last's, "
            "over the images after the first batch; cold and warm are "
            "steady rates (epoch 1, the best later epoch)",
            "uint8 NHWC batches copied to the device as the trainer copies "
            "them (pinned, non-blocking); normalize and erase run on the "
            "device inside the step",
            "cached: DATALOADER.CACHE_IMAGES (decoded-image cache; warm "
            "epochs skip the JPEG decode)",
            f"demand: the flagship step's {FLAGSHIP_BATCH} images over "
            "--step-ms",
        ],
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
