"""Loss library (counterpart of ``textreid_tpu/models/losses.py``).

Only ``l2_normalize`` is ported so far: it is the one the serving path
needs.  The training losses come with the train step.
"""

from __future__ import annotations

import torch

# torch.nn.functional.normalize clamps the norm at 1e-12; so does the JAX
# package.
_NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = _NORM_EPS) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
