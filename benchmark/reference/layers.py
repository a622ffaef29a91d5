"""What the reference's towers share: the rounding of every tower
product's operands (``Precision``), the parameter entries of a
BatchNorm and of a linear layer, and the plain layers themselves."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str]]

BN_EPS = 1e-5
LN_EPS = 1e-5


class Precision:
    """The rounding applied to both operands of every tower product."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        # float8 e4m3 at a per-tensor scale that maps the largest
        # magnitude to 448; the rounding is seen by the forward pass only
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        rounded = (x.detach() * scale).to(torch.float8_e4m3fn).to(
            x.dtype) / scale
        return x + (rounded - x.detach())


def bn_of(name: str, c: int, kind: str = "norm") -> Spec:
    return [(f"{name}.weight", (c,), kind), (f"{name}.bias", (c,), "bias"),
            (f"{name}.running_mean", (c,), "running_mean"),
            (f"{name}.running_var", (c,), "running_var")]


def linear(name: str, cin: int, cout: int) -> Spec:
    return [(f"{name}.weight", (cout, cin), "matrix"),
            (f"{name}.bias", (cout,), "bias")]


def conv(x, w, q: Precision, stride=1, padding=0):
    return F.conv2d(q(x), q(w), None, stride, padding)


def dense(x, w, b, q: Precision):
    return q(x) @ q(w).T + b


def batch_norm(x, P: Params, name: str, train: bool,
               record: Optional[dict] = None):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if record is not None:
            record[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS)
    return ((x - mean[None, :, None, None]) * (inv * w)[None, :, None, None]
            + b[None, :, None, None])


def layer_norm(x, P: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)
