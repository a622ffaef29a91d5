"""A registry of tiny cells for the CPU tests: the flagship's RN50 (its
widths are fixed) at 32x16, a 2-layer ViT, a small bi-GRU and head, 8
rows a batch; the real drivers and metric readers."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.harness.registry import BENCH_DIR, Registry

CFG = {
    "MODEL": {"FREEZE": False, "TEXTUAL_MODEL": "bigru", "NUM_CLASSES": 16,
              "VISUAL_MODEL": "m_resnet50", "RESNET": {"RES5_STRIDE": 1},
              "GRU": {"ONEHOT": "clip_vit", "EMBEDDING_SIZE": 16,
                      "NUM_UNITS": 16, "VOCABULARY_SIZE": 40,
                      "DROPOUT_KEEP_PROB": 1.0, "MAX_LENGTH": 10,
                      "NUM_LAYER": 1},
              "EMBEDDING": {"EMBED_HEAD": "moco", "FEATURE_SIZE": 16,
                            "DROPOUT_PROB": 0.0, "EPSILON": 0.1},
              "MOCO": {"FC": False, "K": 16, "M": 0.999}},
    "INPUT": {"HEIGHT": 32, "WIDTH": 16, "USE_AUG": True,
              "PIXEL_MEAN": [0.48145466, 0.4578275, 0.40821073],
              "PIXEL_STD": [0.26862954, 0.26130258, 0.27577711],
              "MAX_TEXT_LENGTH": 12},
    "SOLVER": {"IMS_PER_BATCH": 8, "OPTIMIZER": "Adam", "BASE_LR": 1e-4,
               "BIAS_LR_FACTOR": 2, "VISUAL_LR_FACTOR": 1.0,
               "WEIGHT_DECAY": 4e-5, "WEIGHT_DECAY_BIAS": 0.0,
               "ADAM_ALPHA": 0.9, "ADAM_BETA": 0.999, "GRAD_ACCUM_STEPS": 1,
               "WARMUP_FACTOR": 0.1},
    "TEST": {"IMS_PER_BATCH": 8},
    "TPU": {"COMPUTE_DTYPE": "bfloat16", "ALLOW_RANDOM_VOCAB": True,
            "REMAT": False},
}
RN50 = {"MODEL": {"RESNET": {"WIDTH": 64, "LAYERS": [3, 4, 6, 3],
                             "HEADS": 32, "OUTPUT_DIM": 1024}}}
VIT = {"PATCH_SIZE": 8, "WIDTH": 32, "LAYERS": 2, "HEADS": 2,
       "OUTPUT_DIM": 16}
TRAIN = {"kind": "train", "ring": 4, "identities_per_batch": 2,
         "images_per_identity": 4, "caption_mean": 6.0,
         "caption_sigma": 0.35, "caption_min": 2, "caption_max": 10,
         "erase_prob": 0.5, "erase_scale": [0.02, 0.4],
         "erase_ratio": [0.3, 3.3333333333333335], "steps_read": 3,
         "pattern_grid": [4, 2], "pattern_noise": 64,
         "warmup_steps": 1, "traced_steps": 2}
EVAL = {"kind": "evaluate", "identities": 6, "images": 12,
        "captions": 26, "caption_mean": 6.0, "caption_sigma": 0.35,
        "caption_min": 2, "caption_max": 10, "warmup_evaluations": 1,
        "traced_evaluations": 1,
        "judged_evaluations": 2, "judged_rows": 10, "pattern_grid": [4, 2],
        "pattern_noise": 64, "settle_images": 8}
# on the CPU the program runs float32, as the reference does; the tiny
# RN50's BatchNorm chain at 8 rows reads its float32 round-off some
# hundred times larger in its later steps (a float64 reference reads the
# same)
TRAIN_LIMITS = {"loss_gap": 0.03, "grad_gap": 0.05, "update_gap": 0.2,
                "queue_gap": 1e-3}
EVAL_LIMITS = {"image_embed_gap": 1e-3, "text_embed_gap": 1e-3,
               "similarity_gap": 1e-5, "rerank_rows_gap": 0.05,
               "rank_gap": 1e-3}


def vit_cfg():
    cfg = copy.deepcopy(CFG)
    cfg["MODEL"]["VISUAL_MODEL"] = "vit"
    cfg["MODEL"]["VIT"] = dict(VIT)
    del cfg["MODEL"]["RESNET"]
    return cfg


def registry(tmp: Path) -> Registry:
    """Tiny cells ``tiny-rn50.train``, ``tiny-rn50.eval`` and
    ``tiny-vit.train`` under ``tmp``."""
    for kind in ("configs", "traffic", "limits"):
        (tmp / kind).mkdir(parents=True, exist_ok=True)
    for kind in ("metrics", "drivers"):
        shutil.copytree(BENCH_DIR / kind, tmp / kind, dirs_exist_ok=True)
    files = {
        "configs/tiny-rn50.json": {"name": "tiny-rn50", "cfg": CFG,
                                   "widths": RN50,
                                   "towers": {"image": "modified_resnet",
                                              "text": "bigru"}},
        "configs/tiny-vit.json": {"name": "tiny-vit", "cfg": vit_cfg(),
                                  "widths": {},
                                  "towers": {"image": "vit",
                                             "text": "bigru"}},
        "traffic/train.json": TRAIN, "traffic/eval.json": EVAL,
        "limits/tiny-rn50.train.json": {"limits": TRAIN_LIMITS},
        "limits/tiny-vit.train.json": {"limits": TRAIN_LIMITS},
        "limits/tiny-rn50.eval.json": {"limits": EVAL_LIMITS},
    }
    for rel, body in files.items():
        (tmp / rel).write_text(json.dumps(body))
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cells = {"tiny-rn50.train": "rn50-gru.train.bs128",
             "tiny-rn50.eval": "rn50-gru.eval.cuhkpedes",
             "tiny-vit.train": "vitb16-gru.train.bs128"}
    bench["workloads"] = [
        {"name": "tiny-rn50.train", "config": "tiny-rn50",
         "traffic": "train", "chips": 1},
        {"name": "tiny-rn50.eval", "config": "tiny-rn50", "traffic": "eval",
         "chips": 1},
        {"name": "tiny-vit.train", "config": "tiny-vit", "traffic": "train",
         "chips": 1}]
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "workloads" in m:
                m["workloads"] = [t for t, real in cells.items()
                                  if real in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp, tmp / "BENCHMARK.json")
