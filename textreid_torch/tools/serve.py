"""Run the online text -> person retrieval service on the port.

Counterpart of ``tools/serve.py``: boots the towers from a reference-layout
checkpoint, loads a gallery index, and serves JSON search over HTTP through
``textreid_torch.server`` (standard library and numpy).

  python -m textreid_torch.tools.serve --root $ROOT \
      --config-file configs/cuhkpedes/moco_gru_cliprn50_ls_bs128_2048.yaml \
      --checkpoint-file model.pth --index-file gallery.idx \
      [--vocab-file word2id.json] [--port 8080] [--quantize] \
      [--int8-text-calib calib.npz] [--device cuda]

Then:
  curl localhost:8080/healthz
  curl -XPOST localhost:8080/search -d '{"token_ids": [[12, 7, 44]], "k": 5}'
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="./")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--checkpoint-file", required=True,
                        help="reference-layout .pth")
    parser.add_argument("--index-file", required=True,
                        help="gallery index from build_index (either package)")
    parser.add_argument("--vocab-file", default="",
                        help="word -> id JSON enabling plain-text queries")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--query-batch", type=int, default=64)
    parser.add_argument("--batch-window-ms", default="0",
                        help="coalesce concurrent requests into one device "
                        "batch within this window (0 = off, 'auto' = size "
                        "from the measured device time)")
    parser.add_argument("--reload-dir", default="",
                        help="enable POST /reload_index for index files "
                        "inside this directory (disabled when empty)")
    parser.add_argument("--k-buckets", default="10,100,1000",
                        help="comma-separated canonical k values; the "
                        "largest is the service's max k")
    parser.add_argument("--quantize", action="store_true",
                        help="rank from the int8 form of the gallery (a quarter of the float gallery's bytes)")
    parser.add_argument("--int8-text-calib", default="",
                        help="caption npz (token_ids, lengths) from "
                        "tools.build_index --text-calib-out; enables the "
                        "int8-dataflow text transformer for query encode "
                        "(text-transformer towers only)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def calibration_chunks(path: str, max_len: int, batch: int):
    """The caption sample at ``path`` as fixed-shape ``(token_ids [batch,
    max_len], lengths [batch])`` chunks: the captions padded or cut to the
    service's query length, a ragged tail dropped unless it is all there
    is."""
    import numpy as np

    with np.load(path) as calib:
        ids, lens = calib["token_ids"], calib["lengths"]
    if ids.shape[1] < max_len:
        ids = np.pad(ids, ((0, 0), (0, max_len - ids.shape[1])))
    ids = ids[:, :max_len]
    lens = np.minimum(lens, max_len)
    n_full = (len(ids) // batch) * batch or len(ids)
    return [(ids[s:s + batch], lens[s:s + batch])
            for s in range(0, n_full, batch)], n_full


def build_server(argv=None):
    """Boot a replica from checkpoint + index (no dataset) and warm it up.
    Returns ``(service, server)``; the server is bound but not started."""
    args = parse_args(argv)

    import numpy as np

    from ..config import get_default_cfg
    from ..server import RetrievalService, SimpleTokenizer, make_server
    from ..serving import RetrievalIndex
    from ..utils import setup_logger
    from ..utils.bootstrap import build_eval_model
    from ..utils.platform import compute_dtype

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.ROOT = args.root
    cfg.freeze()

    logger = setup_logger("PersonSearch")
    model = build_eval_model(cfg, args.checkpoint_file, args.device,
                             compute_dtype(cfg, args.device))
    index = RetrievalIndex(model, query_batch=args.query_batch,
                           quantize=args.quantize)
    index.load_index(args.index_file)
    logger.info("Index: %d rows x %d dims", index.gallery.shape[0],
                index.gallery.shape[1])

    if args.int8_text_calib:
        chunks, rows = calibration_chunks(
            args.int8_text_calib, cfg.INPUT.MAX_TEXT_LENGTH, args.query_batch)
        index.enable_int8_text(chunks)
        logger.info("int8 text encode enabled (%d calibration captions)",
                    rows)

    tokenizer = (SimpleTokenizer.from_file(args.vocab_file)
                 if args.vocab_file else None)
    window = (args.batch_window_ms if args.batch_window_ms == "auto"
              else float(args.batch_window_ms))
    service = RetrievalService(
        index, max_text_length=cfg.INPUT.MAX_TEXT_LENGTH,
        tokenizer=tokenizer, batch_window_ms=window,
        k_buckets=[int(b) for b in args.k_buckets.split(",")],
        reload_dir=args.reload_dir,
        image_shape=(cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH))

    # the first search builds the kernels and warms cuDNN: pay it before
    # accepting traffic
    warm_ids = np.ones((1, cfg.INPUT.MAX_TEXT_LENGTH), np.int32)
    service.search({"token_ids": warm_ids.tolist(), "lengths": [1]})
    logger.info("Warmup done")

    server = make_server(service, host=args.host, port=args.port)
    logger.info("Serving on http://%s:%d", *server.server_address)
    return service, server


def main(argv=None):
    import logging
    import signal
    import threading

    _, server = build_server(argv)
    logger = logging.getLogger("PersonSearch")

    # SIGTERM: stop accepting, drain in-flight requests, exit 0.
    # shutdown() must not run on the serve_forever thread itself.
    def _graceful(signum, frame):
        logger.info("SIGTERM: draining in-flight requests and exiting")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    server.server_close()  # joins in-flight handlers
    logger.info("Drained; bye")


if __name__ == "__main__":
    main()
