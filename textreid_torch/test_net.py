"""Evaluation CLI (counterpart of the JAX package's ``test_net.py``).

    python -m textreid_torch.test_net --root ROOT --config-file CFG.yaml \
        --checkpoint-file X.pth [--load-result] [--device cuda|cpu] \
        [KEY VALUE ...]

The reference argument surface (``--root``, ``--config-file``,
``--checkpoint-file``, ``--load-result``, trailing dotted config overrides)
plus ``--device`` (default ``cuda``, which raises when no card is present).
For each test set of ``DATASETS.TEST``: encode every (image, caption) pair,
score text @ image^T, and log the t2i / re-t2i / i2t / re-i2t grid of
CMC@1/5/10 and mAP with k-reciprocal re-ranking.  With ``--load-result``
the run writes ``ROOT/output/<config dir>/<config name>/inference/<test
set>/inference_data.npz`` and a later run replays it instead of encoding.

``--checkpoint-file`` is a reference-layout ``.pth`` or one of this
package's checkpoints (``best.pth``, ``epoch_N.pth``); an orbax directory
of the JAX package is not supported (it raises): export it with
``tools/export_torch.py``.

Under ``torchrun --nproc-per-node N -m textreid_torch.test_net ...`` (or
``--init-method`` with ``RANK`` and ``WORLD_SIZE``) each rank encodes its
share of the eval batches on its card and every rank scores the gathered
embeddings: the one-process grid, logged by rank 0, which alone writes
``inference_data.npz``.
"""

from __future__ import annotations

import argparse
import os

from .train_net import add_distributed_arguments, join_process_group


def main(argv=None):
    """Evaluate; returns ``{test set: t2i CMC@1}``."""
    parser = argparse.ArgumentParser(
        description="textreid_torch image-text matching inference")
    parser.add_argument("--root", default="./", type=str)
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--checkpoint-file", default="", metavar="FILE",
                        type=str)
    parser.add_argument("--load-result", action="store_true",
                        help="save inference_data.npz, or replay it when it "
                             "is there")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    add_distributed_arguments(parser)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted config overrides: KEY VALUE ...")
    args = parser.parse_args(argv)

    from .config import get_default_cfg
    from .data import make_data_loader
    from .engine.inference import inference
    from .parallel.mesh import destroy_process_group, rank
    from .utils.bootstrap import build_eval_model
    from .utils.logger import setup_logger
    from .utils.platform import compute_dtype, require_cuda

    device = join_process_group(require_cuda(args.device), args)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    cfg.freeze()

    output_dir = os.path.join(
        args.root, "output", "/".join(args.config_file.split("/")[-2:])[:-5])
    model = build_eval_model(cfg, args.checkpoint_file, device,
                             compute_dtype(cfg, device))
    data_loaders_val = make_data_loader(cfg, is_train=False)

    top1 = {}
    for dataset_name, loader in zip(cfg.DATASETS.TEST, data_loaders_val):
        output_folder = os.path.join(output_dir, "inference", dataset_name)
        os.makedirs(output_folder, exist_ok=True)
        logger = setup_logger("PersonSearch", output_folder, rank())
        logger.info("Using %s", next(model.parameters()).device)
        logger.info("%s", cfg)
        top1[dataset_name] = inference(
            model, loader, dataset_name=dataset_name,
            output_folder=output_folder if args.load_result else "",
            save_data=args.load_result, rerank=True)
    destroy_process_group()
    return top1


if __name__ == "__main__":
    main()
