"""Build and persist a serving retrieval index from a checkpoint.

Counterpart of ``tools/build_index.py``: encode a dataset's gallery images
(one row per unique image) through the visual tower once, L2-normalize,
and write an atomic index file that serving replicas load with
``RetrievalIndex.load_index``.

  python -m textreid_torch.tools.build_index --root $ROOT \
      --config-file configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml \
      --checkpoint-file model.pth --output gallery.idx [--quantize] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="./")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--checkpoint-file", required=True,
                        help="reference-layout .pth")
    parser.add_argument("--output", required=True,
                        help="index file to write (atomic)")
    parser.add_argument("--text-calib-out", default="",
                        help="also write an npz of dataset captions "
                        "(token_ids, lengths) beside the index")
    parser.add_argument("--text-calib-rows", type=int, default=2048,
                        help="caption rows to sample into --text-calib-out")
    parser.add_argument("--quantize", action="store_true",
                        help="also store the int8 form of the gallery (quant_values, quant_scales) in the index")
    parser.add_argument("--dataset", default="",
                        help="catalog name; default: first DATASETS.TEST")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..config import get_default_cfg
    from ..data import make_data_loader
    from ..serving import RetrievalIndex
    from ..utils import setup_logger
    from ..utils.bootstrap import build_eval_model
    from ..utils.platform import compute_dtype

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    if args.dataset:
        cfg.DATASETS.TEST = (args.dataset,)
    cfg.freeze()

    logger = setup_logger("PersonSearch")
    model = build_eval_model(cfg, args.checkpoint_file, args.device,
                             compute_dtype(cfg, args.device))
    index = RetrievalIndex(model, quantize=args.quantize)
    loader = make_data_loader(cfg, is_train=False)[0]

    # one gallery row per unique image (the eval protocol's dedupe); meta
    # carries the image ids
    seen = set()
    batches, metas, cur_px, cur_ids = [], [], [], []
    calib_ids, calib_lens = [], []
    batch_size = cfg.TEST.IMS_PER_BATCH
    for item_batch in loader:
        valid = item_batch.get("valid")
        n = int(valid.sum()) if valid is not None else len(
            item_batch["image_ids"])
        if args.text_calib_out and sum(
                len(c) for c in calib_ids) < args.text_calib_rows:
            calib_ids.append(np.asarray(item_batch["token_ids"][:n]))
            calib_lens.append(np.asarray(item_batch["lengths"][:n]))
        for i in range(n):
            img_id = int(item_batch["image_ids"][i])
            if img_id in seen:
                continue
            seen.add(img_id)
            cur_px.append(np.asarray(item_batch["pixels"][i]))
            cur_ids.append(img_id)
            if len(cur_px) == batch_size:
                batches.append(np.stack(cur_px))
                metas.extend(cur_ids)
                cur_px, cur_ids = [], []
    if cur_px:  # pad the tail to the batch shape; valid_rows drops the pad
        pad = batch_size - len(cur_px)
        batches.append(np.stack(cur_px + [cur_px[-1]] * pad))
        metas.extend(cur_ids)

    index.build_gallery(batches, meta=np.asarray(metas),
                        valid_rows=len(metas))
    index.save_index(args.output)
    logger.info("Wrote %s: %d rows x %d dims", args.output,
                index.gallery.shape[0], index.gallery.shape[1])
    if args.text_calib_out:
        ids = np.concatenate(calib_ids)[: args.text_calib_rows]
        lens = np.concatenate(calib_lens)[: args.text_calib_rows]
        tmp = args.text_calib_out + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, token_ids=ids.astype(np.int32),
                     lengths=lens.astype(np.int32))
        os.replace(tmp, args.text_calib_out)
        logger.info("Wrote %s: %d caption rows", args.text_calib_out,
                    len(ids))
    return index


if __name__ == "__main__":
    main()
