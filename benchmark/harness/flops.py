"""Model operations counted from a configuration's layer shapes: 2 M N K a
product, 2 N Co Ho Wo Ci kh kw a convolution, as
``torch.utils.flop_counter.FlopCounterMode`` counts the plain reference's
forward (``benchmark/tests/test_bench_flops.py`` holds them equal).  Each
tower counts its own (``forward_ops`` in ``reference/image/<name>.py`` and
``reference/text/<name>.py``).  The count is the model's, whatever
implements it: the attention pool attends from the mean token alone, the
bi-GRU runs over the padded token grid."""

from __future__ import annotations

from ..reference.model import tower, visual_out


def image_forward(cfg: dict, n: int = 1) -> int:
    return tower("image", cfg).forward_ops(cfg, n)


def text_forward(cfg: dict, n: int = 1) -> int:
    return tower("text", cfg).forward_ops(cfg, n)


def embed_forward(cfg: dict, n: int = 1) -> int:
    d = cfg["MODEL"]["EMBEDDING"]["FEATURE_SIZE"]
    return 2 * n * d * (visual_out(cfg) + tower("text", cfg).out_dim(cfg))


def encode_forward(cfg: dict, n: int = 1) -> int:
    """One (image, caption) pair's towers and embedding layers, ``n``
    pairs."""
    return image_forward(cfg, n) + text_forward(cfg, n) + embed_forward(cfg, n)


def heads_forward(cfg: dict, n: int) -> int:
    """The MoCo loss tail of a batch of ``n``: the identity logits of both
    modalities, both InfoNCE queue products and the alignment
    similarity."""
    m = cfg["MODEL"]
    d = m["EMBEDDING"]["FEATURE_SIZE"]
    return (2 * 2 * n * d * m["NUM_CLASSES"] + 2 * 2 * n * d * m["MOCO"]["K"]
            + 2 * n * n * d)


def train_step(cfg: dict) -> int:
    """A MoCo step: the query towers and heads forward and backward (3x
    their forward) and the key towers' forward."""
    n = cfg["SOLVER"]["IMS_PER_BATCH"]
    return 4 * encode_forward(cfg, n) + 3 * heads_forward(cfg, n)
