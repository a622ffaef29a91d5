"""The shape-counted operations (``harness/flops.py``) against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
forward at the configurations' full widths (on the meta device: shapes
only)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops
from benchmark.harness.registry import BENCH_DIR, reference_cfg
from benchmark.reference import model as reference

CONFIGS = ("clip-rn50-bigru", "clip-vitb16-bigru")


def counted(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(params=CONFIGS)
def cfg(request):
    with open(BENCH_DIR / "configs" / f"{request.param}.json") as f:
        return reference_cfg(json.load(f))


def meta_weights(cfg):
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in reference.param_spec(cfg)}


def test_image_tower_operations_equal_the_counter(cfg):
    n = 2
    inp = cfg["INPUT"]
    w = meta_weights(cfg)
    pixels = torch.empty((n, inp["HEIGHT"], inp["WIDTH"], 3),
                         dtype=torch.uint8, device="meta")
    got = counted(lambda: reference.encode_image(
        w, cfg, pixels, None, False, reference.Precision()))
    assert got == flops.image_forward(cfg, n)


def test_text_tower_and_embeddings_equal_the_counter(cfg):
    n, seq = 2, cfg["INPUT"]["MAX_TEXT_LENGTH"]
    w = meta_weights(cfg)
    ids = torch.zeros((n, seq), dtype=torch.long, device="meta")
    lengths = torch.full((n,), 7, dtype=torch.long, device="meta")
    q = reference.Precision()

    def forward():
        feat = reference.encode_text(w, cfg, ids, lengths, lengths.max(), q)
        reference.embed_text(w, feat, q)
        reference.embed_image(w, torch.empty(
            (n, reference.visual_out(cfg)), device="meta"), q)

    assert counted(forward) == (flops.text_forward(cfg, n)
                                + flops.embed_forward(cfg, n))


def test_step_counts_four_tower_forwards_and_three_heads(cfg):
    n = cfg["SOLVER"]["IMS_PER_BATCH"]
    assert flops.train_step(cfg) == (4 * flops.encode_forward(cfg, n)
                                     + 3 * flops.heads_forward(cfg, n))
