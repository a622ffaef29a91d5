"""Model composition (counterpart of ``textreid_tpu/models/model.py``):
visual tower + textual tower + the retrieval embedding layers, the MoCo
MLP projectors (``MOCO.FC``) and the loss's classifier projection.

Submodule names are the reference torch layout's: ``visual_model``,
``textual_model``, ``embed_model.{v,t}_embed_layer``,
``embed_model.{v,t}_fc_q`` and ``embed_model.loss_evaluator.projection``,
so a reference state dict loads with ``load_state_dict`` (see
``utils/weight_convert.py:load_reference_state_dict``).  The MoCo key
encoders and queues live in the train state (``engine/state.py``).

Parameters keep their dtype (f32 masters when training); the towers run in
``compute_dtype`` by casting them on use (``models/common.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.vocab import frozen_table_initializer
from .common import linear
from .gru import build_bigru
from .m_resnet import build_m_resnet
from .text_transformer import build_text_transformer
from .vit import build_vit

M_RESNETS = ("m_resnet", "m_resnet50", "m_resnet101")
# towers with BatchNorm: the port has no parity test of their batch
# statistics in the train step yet
BN_TOWERS = M_RESNETS + ("resnet18", "resnet34", "resnet50", "resnet101",
                         "resnet152")
TEXT_TRANSFORMERS = ("transformer", "clip_transformer")


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


class MLPProjector(nn.Sequential):
    """The 2-layer MoCo projector used when ``MOCO.FC`` is True (reference
    ``v_fc_q``: Linear, ReLU, Linear; kaiming fan-out init, zero bias)."""

    def __init__(self, in_features: int, feature_size: int):
        super().__init__(nn.Linear(in_features, feature_size), nn.ReLU(),
                         nn.Linear(feature_size, feature_size))
        for layer in (self[0], self[2]):
            nn.init.kaiming_normal_(layer.weight, mode="fan_out")
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(torch.relu(linear(x, self[0])), self[2])


class LossEvaluator(nn.Module):
    """Holder of the identity loss's classifier ``projection``
    ``[feature_size, num_classes]`` (xavier-uniform, kept in f32)."""

    def __init__(self, feature_size: int, num_classes: int):
        super().__init__()
        self.projection = nn.Parameter(torch.empty(feature_size, num_classes))
        nn.init.xavier_uniform_(self.projection)


class EmbedHead(nn.Module):
    """The reference MoCo head's parameters: embedding layers, optional
    projectors, the loss projection."""

    def __init__(self, v_in: int, t_in: int, feature_size: int,
                 num_classes: int = 0, moco_fc: bool = False):
        super().__init__()
        self.v_embed_layer = nn.Linear(v_in, feature_size)
        self.t_embed_layer = nn.Linear(t_in, feature_size)
        for layer in (self.v_embed_layer, self.t_embed_layer):
            nn.init.kaiming_normal_(layer.weight, mode="fan_out")
            nn.init.zeros_(layer.bias)
        # created after the embed layers, so a seed gives the serving
        # weights it gave before these existed
        self.moco_fc = moco_fc
        if moco_fc:
            self.v_fc_q = MLPProjector(v_in, feature_size)
            self.t_fc_q = MLPProjector(t_in, feature_size)
        if num_classes:
            self.loss_evaluator = LossEvaluator(feature_size, num_classes)


class TextReIDModel(nn.Module):
    """Two-tower text/image retrieval model (serving half)."""

    def __init__(self, visual: nn.Module, textual: nn.Module,
                 feature_size: int,
                 pixel_mean: Sequence[float] = (0.485, 0.456, 0.406),
                 pixel_std: Sequence[float] = (0.229, 0.224, 0.225),
                 num_classes: int = 0, moco_fc: bool = False):
        super().__init__()
        self.visual_model = visual
        self.textual_model = textual
        self.embed_model = EmbedHead(visual.out_channels,
                                     textual.out_channels, feature_size,
                                     num_classes, moco_fc)
        # dtype the towers run in; None = the parameters' dtype
        self.compute_dtype: Optional[torch.dtype] = None
        # float32 whatever the model dtype: preprocessing runs in f32
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the towers run in."""
        return (self.compute_dtype
                or self.embed_model.v_embed_layer.weight.dtype)

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
        return self.textual_model(token_ids, lengths, pool_mode, self.dtype)

    def embed_image(self, feat: torch.Tensor) -> torch.Tensor:
        return linear(feat, self.embed_model.v_embed_layer)

    def embed_text(self, feat: torch.Tensor) -> torch.Tensor:
        return linear(feat, self.embed_model.t_embed_layer)

    # -- MoCo contrastive projections (the embed layers when FC is off) ---
    def project_image(self, feat: torch.Tensor) -> torch.Tensor:
        if self.embed_model.moco_fc:
            return self.embed_model.v_fc_q(feat)
        return self.embed_image(feat)

    def project_text(self, feat: torch.Tensor) -> torch.Tensor:
        if self.embed_model.moco_fc:
            return self.embed_model.t_fc_q(feat)
        return self.embed_text(feat)

    @property
    def projection(self) -> torch.Tensor:
        return self.embed_model.loss_evaluator.projection


def build_visual_model(cfg) -> nn.Module:
    name = cfg.MODEL.VISUAL_MODEL
    if name in M_RESNETS:
        return build_m_resnet(cfg)
    if name.startswith("clip_vit") or name == "vit":
        return build_vit(cfg)
    raise NotImplementedError(
        f"visual tower {name!r} is not ported yet (ROADMAP Queue A item 10: "
        "torchvision ResNet)")


def build_textual_model(cfg, frozen_table=None) -> nn.Module:
    """The bi-GRU, or the CLIP text transformer."""
    name = cfg.MODEL.TEXTUAL_MODEL
    if name == "bigru":
        return build_bigru(cfg, frozen_table)
    if name in TEXT_TRANSFORMERS:
        return build_text_transformer(cfg)
    raise NotImplementedError(f"unknown textual tower {name!r}")


def build_model(cfg, device="cpu", dtype=torch.float32,
                compute_dtype: Optional[torch.dtype] = None,
                train: bool = False) -> TextReIDModel:
    """Seeded (``cfg.SEED``) model for ``cfg`` on ``device``, parameters in
    ``dtype``, towers running in ``compute_dtype`` (default ``dtype``).
    ``train=True`` returns it in train mode and refuses the BatchNorm
    towers, whose batch statistics no parity test covers yet, and the text
    transformer, whose train step none covers."""
    name = cfg.MODEL.VISUAL_MODEL
    if train and name in BN_TOWERS:
        raise NotImplementedError(
            f"training the BatchNorm tower {name!r} is not ported yet "
            "(ROADMAP Queue A item 3: BN batch statistics in the train step)")
    if train and cfg.MODEL.TEXTUAL_MODEL in TEXT_TRANSFORMERS:
        raise NotImplementedError(
            "training the CLIP text transformer is not ported yet (ROADMAP "
            "Queue A item 7: a two-step parity test of the full-CLIP train "
            "step); the tower serves and evaluates")
    table_init = frozen_table_initializer(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.SEED)
        model = TextReIDModel(
            visual=build_visual_model(cfg),
            textual=build_textual_model(
                cfg, table_init() if table_init else None),
            feature_size=cfg.MODEL.EMBEDDING.FEATURE_SIZE,
            pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
            pixel_std=tuple(cfg.INPUT.PIXEL_STD),
            num_classes=cfg.MODEL.NUM_CLASSES,
            moco_fc=(cfg.MODEL.EMBEDDING.EMBED_HEAD == "moco"
                     and bool(cfg.MODEL.MOCO.FC)),
        )
    model.to(device=device, dtype=dtype)
    # .to(dtype) casts every floating buffer; keep the pixel stats in f32
    model.pixel_mean = model.pixel_mean.float()
    model.pixel_std = model.pixel_std.float()
    # the loss projection stays f32 whatever the model dtype
    model.embed_model.loss_evaluator.float()
    model.compute_dtype = compute_dtype
    return model.train(train)
