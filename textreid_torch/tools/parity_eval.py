"""The release gate (``PARITY.md``): a checkpoint's retrieval metrics
against expected numbers within a budget.

Counterpart of the repository's ``tools/parity_eval.py``:

    python -m textreid_torch.tools.parity_eval --root $ROOT \
        --config-file configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml \
        --checkpoint-file best.pth \
        [--expected 64.08,81.73,88.19,60.08] [--budget 0.2] \
        [--output-folder out/parity] [--device cuda|cpu] [KEY VALUE ...]

The model is built in f32 (``utils/bootstrap.py:build_eval_model``; a gate
wants exactness) from a reference-layout ``.pth`` or a checkpoint of this
package.  The full protocol of ``test_net`` runs on the first of
``DATASETS.TEST``: both directions, with and without k-reciprocal
re-ranking; the grid is logged, the t2i R1, R5, R10 and mAP are compared
against ``--expected`` (default: the paper's row, ``BASELINE.md``) within
``--budget`` points (default 0.2), and the run exits 1 when one falls
outside.  ``--output-folder`` gets the dual-format ``inference_data.npz``
(the embeddings and the reference's similarity matrices), which
``test_net --load-result`` replays.  ``--device`` defaults to ``cuda``,
which raises without a card.

The repository tool's ``--torch-compare`` (the towers against the upstream
torch code) is not here: this package is the torch code, and the upstream
code it would compare with is not part of the repository.
"""

from __future__ import annotations

import argparse
import os

METRICS = ("R1", "R5", "R10", "mAP")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="the release parity gate")
    parser.add_argument("--root", default="./")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--checkpoint-file", required=True)
    parser.add_argument(
        "--expected", default="64.08,81.73,88.19,60.08",
        help="expected t2i R1,R5,R10,mAP (default: BASELINE.md paper row)")
    parser.add_argument("--budget", type=float, default=0.2,
                        help="max |got - expected| per metric, in points")
    parser.add_argument("--output-folder", default="",
                        help="write the dual-format inference_data.npz here")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def t2i_row(results: dict) -> list:
    """The gated numbers: t2i CMC@1, @5, @10 and mAP, in points."""
    cmc = results["t2i"]["cmc"]
    return [float(cmc[0]), float(cmc[1]), float(cmc[2]),
            float(results["t2i"]["mAP"])]


def gate(got, expected, budget, logger) -> list:
    """Log each metric against its expected value; the names outside the
    budget."""
    failed = []
    for name, g, e in zip(METRICS, got, expected):
        delta = g - e
        ok = abs(delta) <= budget
        logger.info("t2i %-4s got %6.2f  expected %6.2f  delta %+5.2f  [%s]",
                    name, g, e, delta, "OK" if ok else "FAIL")
        if not ok:
            failed.append(name)
    return failed


def main(argv=None) -> dict:
    """Run the gate; returns the results grid when it passes, exits 1 when
    it fails."""
    args = parse_args(argv)

    import torch

    from ..config import get_default_cfg
    from ..data import make_data_loader
    from ..engine.inference import compute_embeddings, save_inference_data
    from ..evaluation.metrics import evaluation, format_results_table
    from ..utils import setup_logger
    from ..utils.bootstrap import build_eval_model
    from ..utils.platform import require_cuda

    device = require_cuda(args.device)
    expected = [float(v) for v in args.expected.split(",")]
    if len(expected) != len(METRICS):
        raise ValueError(f"--expected takes {len(METRICS)} numbers "
                         f"({','.join(METRICS)}); got {args.expected!r}")
    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    cfg.freeze()

    logger = setup_logger("PersonSearch")
    model = build_eval_model(cfg, args.checkpoint_file, device,
                             torch.float32)
    loader = make_data_loader(cfg, is_train=False)[0]
    embeds = compute_embeddings(model, loader)
    results = evaluation(
        embeds["v_embed"], embeds["t_embed"], embeds["pids"], embeds["pids"],
        embeds["image_ids"], topk=(1, 5, 10), rerank=True, device=device)
    logger.info("\n%s", format_results_table(results))

    if args.output_folder:
        os.makedirs(args.output_folder, exist_ok=True)
        cache = os.path.join(args.output_folder, "inference_data.npz")
        save_inference_data(cache, embeds, results)
        logger.info("Dual-format npz for replay: %s", cache)

    failed = gate(t2i_row(results), expected, args.budget, logger)
    if failed:
        logger.error("PARITY GATE FAILED (budget %.2f pts): %s",
                     args.budget, ", ".join(failed))
        raise SystemExit(1)
    logger.info("PARITY GATE PASSED (budget %.2f pts)", args.budget)
    return results


if __name__ == "__main__":
    main()
