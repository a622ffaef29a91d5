"""Export a checkpoint to the reference's torch ``.pth`` layout.

Counterpart of the repository's ``tools/export_torch.py``: a model trained
by this package (``best.pth``, ``epoch_N.pth``: ``utils/checkpoint.py``'s
checkpoints) or a reference ``.pth`` becomes the ``{"model": state_dict}``
the upstream torch code loads unchanged — query towers under
``visual_model.`` / ``textual_model.``, embed layers and the loss
projection under ``embed_model.``, the MoCo key encoders, queues and
pointer in the reference's names and buffer shapes; the optimizer and the
progress are dropped (``utils/weight_convert.py:
export_reference_state_dict``).  Only the bi-GRU text tower is exportable
(the reference has no transformer branch).

    python -m textreid_torch.tools.export_torch --root $ROOT \
        --config-file configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml \
        --checkpoint-file output/.../best.pth --output exported.pth \
        [--device cuda|cpu] [KEY VALUE ...]

The state is built for the config on ``--device`` (default ``cuda``, which
raises without a card) and the checkpoint installed into it strictly, so a
file that does not match the config raises before anything is written.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="export a checkpoint to the reference torch layout")
    parser.add_argument("--root", default="./")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--checkpoint-file", required=True,
                        help="a checkpoint of this package (best.pth, "
                        "epoch_N.pth) or a reference .pth to re-export")
    parser.add_argument("--output", required=True, help=".pth file to write")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Export; returns the written state dict (CPU tensors)."""
    args = parse_args(argv)

    from ..config import get_default_cfg
    from ..utils import setup_logger
    from ..utils.bootstrap import build_train_state, install_checkpoint
    from ..utils.platform import require_cuda
    from ..utils.weight_convert import (
        export_reference_state_dict,
        save_reference_state_dict,
    )

    device = require_cuda(args.device)
    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    cfg.freeze()

    logger = setup_logger("PersonSearch")
    # parameter shapes come from the config; no dataset needed on disk
    state = build_train_state(cfg, device)
    kind = install_checkpoint(state, args.checkpoint_file)
    sd = export_reference_state_dict(cfg, state.state_dict())
    save_reference_state_dict(sd, args.output)
    logger.info("Wrote %s: %d tensors (reference layout, head=%s) from %s "
                "checkpoint %s", args.output, len(sd),
                cfg.MODEL.EMBEDDING.EMBED_HEAD, kind, args.checkpoint_file)
    return sd


if __name__ == "__main__":
    main()
