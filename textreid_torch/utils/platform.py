"""Device and dtype selection (counterpart of ``textreid_tpu/utils/platform.py``)."""

from __future__ import annotations

import torch


def require_cuda(device) -> torch.device:
    """Resolve ``device``; raise when CUDA is asked for and no card is
    present.  Nothing in the port continues on the CPU behind the caller's
    back."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is False (no CUDA card or a CPU-only torch build)")
        # Parity with the reference: a float32 matmul or convolution runs
        # in full float32, never silently in TF32 (cuDNN's default for
        # convolutions), so f32 results are comparable with the JAX package.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def compute_dtype(cfg, device) -> torch.dtype:
    """The dtype the towers run in.  ``cfg.TPU.COMPUTE_DTYPE`` names the
    accelerator's dtype (the key predates the port; on CUDA it is read as
    it is on a TPU), and ``cfg.DTYPE`` applies on the CPU."""
    name = (cfg.TPU.COMPUTE_DTYPE if torch.device(device).type == "cuda"
            else cfg.DTYPE)
    return torch.bfloat16 if name == "bfloat16" else torch.float32
