"""Quickstart: train, evaluate and serve on a synthetic dataset (the port's
walk of the repository's ``examples/quickstart.py``).

    python -m textreid_torch.quickstart [--device cuda|cpu] [--root DIR]

In a couple of minutes on the CPU: a synthetic CUHK-PEDES-schema dataset
(8 identities x 4 images to train, 4 x 2 to test, 64x32), the example's
tiny config (ResNet-18, bi-GRU with 32 units, MoCo K=16, 2 epochs), two
epochs through the port's trainer with an evaluation and a checkpoint
after each (``train_net.train``), the test set evaluated with re-ranking,
a ``RetrievalIndex`` built and searched, and one ``/search`` answered over
the port's HTTP server.  Swap the synthetic dataset for real CUHK-PEDES
(``DATA.md``) to reproduce the paper's workflow.  ``--device`` defaults to
``cuda`` (which raises without a card); there the text tower runs K1
(forward and backward, H=32) and the index K2 (D=32).  ``--root`` defaults
to a new temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import urllib.request

import numpy as np


def quickstart_cfg(root: str):
    """The example's config, rooted at ``root``, frozen."""
    from .config import get_default_cfg

    cfg = get_default_cfg()
    cfg.ROOT = root
    cfg.DATASETS.TRAIN = ("cuhkpedes_train",)
    cfg.DATASETS.TEST = ("cuhkpedes_test",)
    cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH = 64, 32
    cfg.INPUT.MAX_TEXT_LENGTH = 16
    cfg.INPUT.USE_AUG = True
    cfg.MODEL.VISUAL_MODEL = "resnet18"
    cfg.MODEL.TEXTUAL_MODEL = "bigru"
    cfg.MODEL.NUM_CLASSES = 8
    cfg.MODEL.GRU.VOCABULARY_SIZE = 100
    cfg.MODEL.GRU.EMBEDDING_SIZE = 32
    cfg.MODEL.GRU.NUM_UNITS = 32
    cfg.MODEL.EMBEDDING.EMBED_HEAD = "moco"
    cfg.MODEL.EMBEDDING.FEATURE_SIZE = 32
    cfg.MODEL.EMBEDDING.EPSILON = 0.1
    cfg.MODEL.MOCO.K = 16
    cfg.MODEL.MOCO.FC = False
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.NUM_EPOCHS = 2
    cfg.SOLVER.BASE_LR = 3e-4
    cfg.SOLVER.WARMUP_EPOCHS = 0
    cfg.TEST.IMS_PER_BATCH = 8
    cfg.DATALOADER.IMS_PER_ID = 2
    cfg.freeze()
    return cfg


def main(argv=None) -> dict:
    """Run the walk; returns ``{"top1", "matches", "http_meta",
    "output_dir", "steps"}`` (``steps``: the train steps taken)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    parser.add_argument("--root", default="",
                        help="workspace (default: a new temporary "
                        "directory)")
    args = parser.parse_args(argv)

    from .data import make_data_loader, make_synthetic_dataset
    from .engine.inference import inference
    from .server import RetrievalService, make_server
    from .serving import RetrievalIndex
    from .train_net import train
    from .utils import setup_logger
    from .utils.platform import require_cuda

    device = require_cuda(args.device)
    root = args.root or tempfile.mkdtemp(prefix="textreid_quickstart_")
    ds = os.path.join(root, "datasets", "cuhkpedes")
    make_synthetic_dataset(ds, num_identities=8, images_per_id=4,
                           image_size=(64, 32), max_tokens=16, split="train")
    make_synthetic_dataset(ds, num_identities=4, images_per_id=2,
                           image_size=(64, 32), max_tokens=16, split="test",
                           seed=1)
    cfg = quickstart_cfg(root)
    out_dir = os.path.join(root, "output")
    os.makedirs(out_dir, exist_ok=True)
    setup_logger("PersonSearch", out_dir)

    # --- train (2 epochs, with validation + checkpoints) -------------------
    state, _ = train(cfg, out_dir, device)

    # --- evaluate ----------------------------------------------------------
    model = state.model.eval()
    val_loader = make_data_loader(cfg, is_train=False)[0]
    top1 = inference(model, val_loader, rerank=True)
    print(f"t2i Rank-1 after {cfg.SOLVER.NUM_EPOCHS} epochs: {top1:.2f}")

    # --- serve -------------------------------------------------------------
    index = RetrievalIndex(model, query_batch=8)
    rng = np.random.RandomState(0)
    gallery_batches = [rng.randint(0, 255, (4, 64, 32, 3), dtype=np.uint8)
                       for _ in range(2)]
    index.build_gallery(gallery_batches, meta=np.arange(8))
    token_ids = rng.randint(1, 100, (2, 16)).astype(np.int32)
    lengths = np.array([16, 7], np.int32)
    _, matches = index.search(token_ids, lengths, k=3)
    print("serving top-3 matches:", np.asarray(matches).tolist())

    # --- or over HTTP (server.py; tools/serve.py for the CLI) -------------
    service = RetrievalService(index, max_text_length=16)
    httpd = make_server(service)  # port=0 -> OS-assigned
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address
        req = urllib.request.Request(
            f"http://{host}:{port}/search",
            data=json.dumps({"token_ids": token_ids.tolist(),
                             "lengths": lengths.tolist(), "k": 3}).encode())
        with urllib.request.urlopen(req) as resp:
            http_meta = json.loads(resp.read())["meta"]
        print("HTTP top-3 matches:", http_meta)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print("quickstart OK")
    return {"top1": top1, "matches": np.asarray(matches).tolist(),
            "http_meta": http_meta, "output_dir": out_dir,
            "steps": state.step}


if __name__ == "__main__":
    main()
