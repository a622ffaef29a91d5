"""What the benchmark takes from the program under test
(``textreid_torch``): its configuration tree, the weights it is given,
and its kernels' launch counters.  Imported only inside the functions
that need it, so the reference and the harness's own modules load
without the program."""

from __future__ import annotations

from typing import Dict


def program_cfg(config: dict):
    """The program's configuration: its defaults with the configuration
    file's ``cfg`` written over them."""
    from textreid_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_other(config["cfg"])
    return cfg


def load_weights(model, weights: Dict) -> None:
    """Copy the run's weights into ``model`` (cast to its parameters'
    dtype).  Every tensor of the model's state but BatchNorm's batch
    counter must be given, and nothing else."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the program's model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")


def launch_counts() -> Dict[str, int]:
    """The launch counters of the port's kernels: K1's forward and
    backward (``ops/gru.py``), K5 and K6 (``ops/attention.py``)."""
    from textreid_torch.ops import attention, gru

    return {"k1_fwd": gru.bigru_pooled_scan.launches,
            "k1_bwd": gru.bigru_pooled_bwd.launches,
            "k5": attention.fused_attention.launches,
            "k6": attention.fused_attention_bwd.launches}
