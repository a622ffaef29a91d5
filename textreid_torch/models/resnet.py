"""Torchvision-layout ResNet visual encoder (counterpart of
``textreid_tpu/models/resnet.py``): BasicBlock / Bottleneck stages,
configurable res5 stride and dilation, global average pool; resnet18 to
resnet152.

Module and parameter names are torchvision's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``, ``layer1.0.downsample.1``,
...), so a reference ``.pth`` loads with a plain ``load_state_dict``; no
ImageNet archive is read (the JAX package loads none either).  As in
``models/m_resnet.py``, convolutions are ``F.conv2d`` through cuDNN, every
layer runs in the dtype of its input with its parameters cast on use, and
BatchNorm goes through ``common.batch_norm`` (eval: running statistics;
train: f32 batch statistics and flax's ``momentum=0.9`` update of the
running ones, towards the biased batch variance).  NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, conv2d

ARCH_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=dilation * (k // 2), dilation=dilation,
                     bias=False)


class _Block(nn.Module):
    """What both blocks share: the projection shortcut and the residual."""

    def _shortcut(self, inplanes: int, out_planes: int, stride: int) -> None:
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(
                _conv(inplanes, out_planes, 1, stride),
                nn.BatchNorm2d(out_planes))

    def _residual(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = batch_norm(conv2d(x, conv), bn)
        return F.relu(out + identity)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self._shortcut(inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        return self._residual(x, batch_norm(conv2d(out, self.conv2),
                                            self.bn2))


class TorchBottleneck(_Block):
    """Torchvision's bottleneck: the stride on the 3x3 convolution (no
    anti-aliasing pool, unlike CLIP's)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self._shortcut(inplanes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = F.relu(batch_norm(conv2d(out, self.conv2), self.bn2))
        return self._residual(x, batch_norm(conv2d(out, self.conv3),
                                            self.bn3))


class ResNet(nn.Module):
    """``[B, 3, H, W] -> [B, 512 * expansion]``."""

    def __init__(self, block: str, layers: Sequence[int],
                 res5_stride: int = 2, res5_dilation: int = 1):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else TorchBottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        stages = ((64, 1, 1), (128, 2, 1), (256, 2, 1),
                  (512, res5_stride, res5_dilation))
        for i, ((planes, stride, dilation), blocks) in enumerate(
                zip(stages, layers), 1):
            stage = []
            for b in range(blocks):
                stage.append(block_cls(inplanes, planes,
                                       stride if b == 0 else 1, dilation))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{i}", nn.Sequential(*stage))
        self.out_channels = inplanes
        # torchvision's initialisation
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x.mean(dim=(2, 3))


def build_resnet(cfg) -> ResNet:
    """Builder mirroring ``textreid_tpu/models/resnet.py:build_resnet``."""
    arch = cfg.MODEL.VISUAL_MODEL
    if arch not in ARCH_LAYERS:
        raise NotImplementedError(arch)
    block, layers = ARCH_LAYERS[arch]
    return ResNet(block, layers, res5_stride=cfg.MODEL.RESNET.RES5_STRIDE,
                  res5_dilation=cfg.MODEL.RESNET.RES5_DILATION)
