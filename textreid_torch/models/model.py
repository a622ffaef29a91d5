"""Model composition (counterpart of ``textreid_tpu/models/model.py``):
visual tower + textual tower + the two retrieval embedding layers.

Submodule names are the reference torch layout's: ``visual_model``,
``textual_model`` and ``embed_model.{v,t}_embed_layer``, so a reference
state dict loads with ``load_state_dict`` (see
``utils/weight_convert.py:load_reference_state_dict``).  Only the serving
half exists so far: the MoCo key encoders, queues, projectors and the loss
projection come with the train step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.vocab import frozen_table_initializer
from .gru import BiGRUEncoder, build_bigru
from .m_resnet import build_m_resnet


def preprocess_pixels(images: torch.Tensor, erase: Optional[torch.Tensor],
                      pixel_mean: torch.Tensor,
                      pixel_std: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC on the device, with the
    RandomErasing rectangle (``[apply, top, left, h, w]`` per sample) filled
    with the RAW pixel mean written into the normalized image, the
    torchvision quirk the reference inherits."""
    x = (images.float() / 255.0 - pixel_mean) / pixel_std
    if erase is not None:
        h, w = x.shape[1], x.shape[2]
        rows = torch.arange(h, device=x.device)[None, :, None]
        cols = torch.arange(w, device=x.device)[None, None, :]
        e = erase.to(x.device).long()[:, :, None, None]  # [B, 5, 1, 1]
        in_rect = ((rows >= e[:, 1]) & (rows < e[:, 1] + e[:, 3])
                   & (cols >= e[:, 2]) & (cols < e[:, 2] + e[:, 4])
                   & e[:, 0].bool())
        x = torch.where(in_rect[..., None], pixel_mean, x)
    return x


class EmbedHead(nn.Module):
    """The retrieval embedding layers of the reference MoCo head."""

    def __init__(self, v_in: int, t_in: int, feature_size: int):
        super().__init__()
        self.v_embed_layer = nn.Linear(v_in, feature_size)
        self.t_embed_layer = nn.Linear(t_in, feature_size)
        for layer in (self.v_embed_layer, self.t_embed_layer):
            nn.init.kaiming_normal_(layer.weight, mode="fan_out")
            nn.init.zeros_(layer.bias)


class TextReIDModel(nn.Module):
    """Two-tower text/image retrieval model (serving half)."""

    def __init__(self, visual: nn.Module, textual: BiGRUEncoder,
                 feature_size: int,
                 pixel_mean: Sequence[float] = (0.485, 0.456, 0.406),
                 pixel_std: Sequence[float] = (0.229, 0.224, 0.225)):
        super().__init__()
        self.visual_model = visual
        self.textual_model = textual
        self.embed_model = EmbedHead(visual.out_channels,
                                     textual.out_channels, feature_size)
        # float32 whatever the model dtype: preprocessing runs in f32
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_model.v_embed_layer.weight.dtype

    def encode_image(self, images: torch.Tensor,
                     erase: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC pixels (uint8, or already normalized float) -> features."""
        if images.dtype == torch.uint8:
            images = preprocess_pixels(images, erase, self.pixel_mean,
                                       self.pixel_std)
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
        return self.visual_model(x)

    def encode_text(self, token_ids: torch.Tensor, lengths: torch.Tensor,
                    pool_mode: Optional[str] = None) -> torch.Tensor:
        return self.textual_model(token_ids, lengths, pool_mode)

    def embed_image(self, feat: torch.Tensor) -> torch.Tensor:
        return self.embed_model.v_embed_layer(feat)

    def embed_text(self, feat: torch.Tensor) -> torch.Tensor:
        return self.embed_model.t_embed_layer(feat)


def build_model(cfg, device="cpu", dtype=torch.float32) -> TextReIDModel:
    """Seeded (``cfg.SEED``) eval-mode model for ``cfg`` on ``device`` in
    ``dtype``.  Only the CLIP ModifiedResNet + bi-GRU family is ported."""
    if cfg.MODEL.VISUAL_MODEL not in ("m_resnet", "m_resnet50", "m_resnet101"):
        raise NotImplementedError(
            f"visual tower {cfg.MODEL.VISUAL_MODEL!r} is not ported yet "
            "(ROADMAP Queue A: torchvision ResNet, ViT and text-transformer "
            "towers)")
    if cfg.MODEL.TEXTUAL_MODEL != "bigru":
        raise NotImplementedError(
            f"textual tower {cfg.MODEL.TEXTUAL_MODEL!r} is not ported yet "
            "(ROADMAP Queue A: ViT and text-transformer towers)")
    table_init = frozen_table_initializer(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.SEED)
        model = TextReIDModel(
            visual=build_m_resnet(cfg),
            textual=build_bigru(cfg, table_init() if table_init else None),
            feature_size=cfg.MODEL.EMBEDDING.FEATURE_SIZE,
            pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
            pixel_std=tuple(cfg.INPUT.PIXEL_STD),
        )
    model.to(device=device, dtype=dtype)
    # .to(dtype) casts every floating buffer; keep the pixel stats in f32
    model.pixel_mean = model.pixel_mean.float()
    model.pixel_std = model.pixel_std.float()
    return model.eval()
