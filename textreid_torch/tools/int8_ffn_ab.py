"""Encode-level A/B of K7, the fused int8 FFN (``ops/int8_mm.py:
fused_int8_ffn``), on the int8-dataflow towers of the full-CLIP model.

Counterpart of the repository's ``tools/int8_ffn_ab.py``: the int8 ViT-B/16
(384x128, B=128) and the int8 CLIP text transformer (B=128, T=105), each
timed with ``fused_ffn=False`` (K8 and the plain ``c_proj`` product) against
``fused_ffn=True`` (K7; ``models/int8_vit.py:resolve_fused_ffn``) in turns,
and the minimum cosine between the two settings' embeddings.  The towers
are built as serving builds them (``RetrievalIndex(int8_encode=True)``
calibrated on the first four gallery batches, ``enable_int8_text`` on a
caption sample), on seeded weights of ``config/flagship.py:
flagship_cfg("fullclip")``; ``chip_smoke.py`` times the same cases
(:func:`encode_cases`) beside the float towers.

    python -m textreid_torch.tools.int8_ffn_ab [--output ab.json] \
        [--iters 50] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

BATCH, TOKENS, VOCAB = 128, 105, 49408


def encode_cases(model, image_tower, text_tower, pixels, token_ids,
                 lengths) -> dict:
    """{(tower, setting): forward}: ``("vit" | "text", "float" | "off" |
    "on")``, the bf16 float tower and the int8 tower with ``fused_ffn``
    off and on, on normalized ``pixels`` and on ``token_ids`` /
    ``lengths``."""
    from ..models.int8_text import int8_text_apply
    from ..models.int8_vit import int8_vit_apply

    visual, textual = model.visual_model, model.textual_model
    return {
        ("vit", "float"): lambda: model.encode_image(pixels),
        ("vit", "off"): lambda: int8_vit_apply(visual, image_tower, pixels,
                                               fused_ffn=False),
        ("vit", "on"): lambda: int8_vit_apply(visual, image_tower, pixels,
                                              fused_ffn=True),
        ("text", "float"): lambda: model.encode_text(token_ids, lengths),
        ("text", "on"): lambda: int8_text_apply(textual, text_tower,
                                                token_ids, lengths,
                                                fused_ffn=True),
        ("text", "off"): lambda: int8_text_apply(textual, text_tower,
                                                 token_ids, lengths,
                                                 fused_ffn=False),
    }


def build_towers(device, batch: int = BATCH, tokens: int = TOKENS,
                 seed: int = 0):
    """(model, image tower, text tower, normalized pixels, token ids,
    lengths): the full-CLIP model at full width in bf16 with seeded
    weights, its int8 towers calibrated as serving calibrates them, and one
    batch of each input."""
    import torch

    from ..config import flagship_cfg
    from ..models.model import preprocess_pixels
    from ..serving import RetrievalIndex
    from ..utils.bootstrap import build_eval_model

    cfg = flagship_cfg("fullclip", tokens=tokens)
    model = build_eval_model(cfg, "", device, torch.bfloat16)
    rng = np.random.RandomState(seed)
    pixels = rng.randint(0, 255, (4 * batch, cfg.INPUT.HEIGHT,
                                  cfg.INPUT.WIDTH, 3), dtype=np.uint8)
    lengths = rng.randint(10, tokens, 4 * batch).astype(np.int64)
    ids = np.zeros((4 * batch, tokens), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(1, VOCAB, n)
    index = RetrievalIndex(model, int8_encode=True)
    index.build_gallery([pixels[i:i + batch]
                         for i in range(0, len(pixels), batch)])
    index.enable_int8_text([(ids[i:i + batch], lengths[i:i + batch])
                            for i in range(0, len(ids), batch)])
    x = preprocess_pixels(torch.from_numpy(pixels[:batch]).to(device), None,
                          model.pixel_mean, model.pixel_std)
    return (model, index._int8_image_tower, index._int8_text_tower, x,
            torch.from_numpy(ids[:batch]).to(device),
            torch.from_numpy(lengths[:batch]).to(device))


def time_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after a warm-up: CUDA
    events on a card, the host clock on the CPU (the plain versions)."""
    import time

    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def min_cosine(a, b) -> float:
    a, b = a.float(), b.float()
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-12)
    return float(cos.min())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="encode-level A/B of the fused int8 FFN (K7)")
    parser.add_argument("--output", default="",
                        help="write the report JSON here")
    parser.add_argument("--iters", type=int, default=50,
                        help="forwards a timing")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises without a card "
                        "('cpu' times the plain versions on the host)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from ..utils.platform import require_cuda

    device = require_cuda(args.device)
    model, v_tower, t_tower, x, ids, lens = build_towers(device)
    cases = encode_cases(model, v_tower, t_tower, x, ids, lens)
    report = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"), "batch": BATCH,
              "tokens": TOKENS, "iters": args.iters}
    with torch.inference_mode():
        times = {}
        for _ in range(2):  # in turns: each setting timed twice apart
            for key, fn in cases.items():
                times.setdefault(key, []).append(
                    time_ms(fn, args.iters, device))
        for (tower, setting), ms in times.items():
            report[f"{tower}_{setting}_ms"] = float(np.mean(ms))
        for tower in ("vit", "text"):
            report[f"{tower}_ffn_min_cosine"] = min_cosine(
                cases[(tower, "off")](), cases[(tower, "on")]())
    print(json.dumps(report), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
