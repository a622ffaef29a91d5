"""Int8-dataflow CLIP ModifiedResNet trunk: int8 activations between the
convolutions (counterpart of ``textreid_tpu/models/int8_tower.py``).

A post-training-quantized inference graph for the gallery encode:

* every convolution + BatchNorm pair folds into one int8 convolution
  (eval-mode BatchNorm is ``g conv(x) + b`` with ``g = gamma / sqrt(var +
  eps)``: ``g`` folds into the kernel, ``b`` into the epilogue's bias);
* activations are quantized once an edge with static per-channel scales
  from a calibration pass, and the per-input-channel scales fold into the
  consumer's kernel (``conv(x_q s[ci], w) == conv(x_q, w s[ci])``), so the
  tensors between the convolutions are int8, NHWC;
* each convolution is im2col and an int8 product (``torch._int_mm``, a
  library call, as JAX leaves its convolutions to XLA), then one fused
  epilogue, E1 (``ops/int8_conv.py:int8_conv_epilogue``): ``int32 * s_w +
  b [+ residual] [relu] / s_next -> round -> int8``, the residual read as
  int8 and decoded inline, so no float feature map goes to device memory
  and back;
* the anti-alias average pools run on the int8 tensors in integer
  arithmetic (E2, ``ops/int8_conv.py:int8_avg_pool``);
* the attention pool and the embedding head stay in the model's dtype.

Sites whose only consumers are unpadded 1x1 convolutions (a block's
``.conv1`` and ``.conv3`` inputs) carry ReLU outputs as zero-point-128
int8, ``x ~ (q + 128) s`` with ``s = amax / 254``: the shift folds into a
per-channel bias computed from the quantized kernel, which is exact only
where no zero padding is read.  3x3 consumers (the stem, ``.conv2``) stay
symmetric, so that padding decodes to 0.

The epilogues round half away from zero (+-0.5 and truncation), in f32 or,
with ``epilogue_dtype=torch.bfloat16``, in bf16.  ``float_blocks`` keeps
the stem and the first N bottlenecks as folded bf16 convolutions (cuDNN)
instead.  Calibration needs no labels: batches with the serving input
distribution (the first gallery batches) run through the folded float
graph, the float tower's eval forward, recording the per-channel abs-max
at every convolution input; on the card with TF32 off, so that the
recorded ranges are f32's.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.int8_conv import (flatten_weight, int8_avg_pool, int8_conv2d,
                             int8_conv_epilogue)
from .int8_vit import accumulate_amax
from .losses import l2_normalize
from .m_resnet import ModifiedResNet
from .model import preprocess_pixels

# (unit, BatchNorm, stride) of the stem's three 3x3 convolutions
STEM_UNITS = (("conv1", "bn1", 2), ("conv2", "bn2", 1), ("conv3", "bn3", 1))


class BlockSpec(NamedTuple):
    name: str         # "layer{stage}_{index}", the JAX package's name
    stage: int
    index: int
    stride: int
    has_downsample: bool


@dataclass
class Int8ConvTower:
    """A prepared int8 trunk on one device.

    ``units``: name -> ``{"w_q": int8 [K, co] (rows in (kh, kw, ci) order,
    zero rows to K's multiple of 8, the transpose of a contiguous ``[co,
    K]``), "s_w": f32 [co], "b": f32 [co], "kernel": kh}``, or for a unit of
    the bf16 front ``{"w": bf16 [co, ci, kh, kw], "b": f32 [co], "kernel":
    kh}``; ``scales``: site -> f32 ``[channels]``; ``inv``: site -> ``1 /
    scale`` in f32, computed once here, read by E1 and its plain version
    alike."""

    units: Dict[str, dict]
    scales: Dict[str, torch.Tensor]
    inv: Dict[str, torch.Tensor]


def trunk_specs(visual: ModifiedResNet) -> List[BlockSpec]:
    """The bottlenecks in forward order."""
    specs = []
    for stage in range(1, 5):
        for index, block in enumerate(getattr(visual, f"layer{stage}")):
            pool = block.avgpool
            stride = pool.kernel_size if isinstance(pool,
                                                    torch.nn.AvgPool2d) else 1
            specs.append(BlockSpec(f"layer{stage}_{index}", stage, index,
                                   int(stride), block.downsample is not None))
    return specs


def _block(visual: ModifiedResNet, spec: BlockSpec):
    return getattr(visual, f"layer{spec.stage}")[spec.index]


def fold_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d,
            eps: float = 1e-5):
    """Eval-mode convolution + BatchNorm -> (folded f32 OIHW kernel, f32
    bias)."""
    g = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.float() + eps)
    b = bn.bias.detach().float() - bn.running_mean.float() * g
    return conv.weight.detach().float() * g[:, None, None, None], b


def is_asym_site(site: str) -> bool:
    """A block's ``.conv1`` and ``.conv3`` inputs: read only by unpadded 1x1
    convolutions (see the module docstring)."""
    return "." in site and site.rsplit(".", 1)[1] in ("conv1", "conv3")


@contextmanager
def tf32_off():
    """f32 convolutions in f32 on the card (cuDNN's TF32 default would move
    every recorded abs-max); the flag is put back afterwards."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Folded float graph (calibration / agreement reference)
# ---------------------------------------------------------------------------

def _conv_f32(x, w, stride):
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _bias(b):
    return b[:, None, None]


def folded_trunk_float(visual: ModifiedResNet, x: torch.Tensor,
                       record: Optional[dict] = None) -> torch.Tensor:
    """The eval-mode float trunk with every convolution + BatchNorm folded,
    on normalized NHWC pixels -> f32 NHWC features; with ``record``, the
    per-channel abs-max at every convolution input (the sites of the int8
    graph).  The first block's input site is recorded before the stem's
    pool, and a strided block's ``.conv3`` site before its pool: the int8
    graph quantizes before the (scale-preserving) integer pools, and the
    pooled maximum is smaller."""
    def rec(site, v):
        if record is not None:
            record[site] = v.abs().amax(dim=(0, 2, 3))

    x = x.float().permute(0, 3, 1, 2)
    specs = trunk_specs(visual)
    for name, bn, stride in STEM_UNITS:
        w, b = fold_bn(getattr(visual, name), getattr(visual, bn))
        rec(name, x)
        x = torch.relu(_conv_f32(x, w, stride) + _bias(b))
    rec(f"{specs[0].name}.conv1", x)
    x = F.avg_pool2d(x, 2)
    for bi, spec in enumerate(specs):
        blk = _block(visual, spec)
        w1, b1 = fold_bn(blk.conv1, blk.bn1)
        w2, b2 = fold_bn(blk.conv2, blk.bn2)
        w3, b3 = fold_bn(blk.conv3, blk.bn3)
        if bi > 0:
            rec(f"{spec.name}.conv1", x)
        out = torch.relu(_conv_f32(x, w1, 1) + _bias(b1))
        rec(f"{spec.name}.conv2", out)
        out = torch.relu(_conv_f32(out, w2, 1) + _bias(b2))
        rec(f"{spec.name}.conv3", out)
        if spec.stride > 1:
            out = F.avg_pool2d(out, spec.stride)
        out = _conv_f32(out, w3, 1) + _bias(b3)
        identity = x
        if spec.has_downsample:
            if spec.stride > 1:
                identity = F.avg_pool2d(identity, spec.stride)
            _, conv, bn = blk.downsample
            wd, bd = fold_bn(conv, bn)
            identity = _conv_f32(identity, wd, 1) + _bias(bd)
            # the branch's output is requantized too (symmetric: signed,
            # before the ReLU), so that the residual add reads int8
            rec(f"{spec.name}.downsample_out", identity)
        x = torch.relu(out + identity)
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Preparation: calibration + weight quantization
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_amax(visual: ModifiedResNet, batches, pixel_mean,
                   pixel_std) -> Dict[str, torch.Tensor]:
    """Per-channel abs-max at every convolution input over calibration
    batches (``[B, H, W, 3]`` uint8, or already normalized float), the
    elementwise max across batches."""
    device = visual.conv1.weight.device
    acc: Dict[str, torch.Tensor] = {}
    with tf32_off():
        for pixels in batches:
            pixels = torch.as_tensor(pixels).to(device)
            if pixels.dtype == torch.uint8:
                pixels = preprocess_pixels(pixels, None, pixel_mean,
                                           pixel_std)
            record: dict = {}
            folded_trunk_float(visual, pixels, record)
            accumulate_amax(acc, record)
    if not acc:
        raise ValueError("calibration needs at least one batch")
    return acc


def _units_of(visual: ModifiedResNet):
    """(unit name, conv, bn, input site) of every convolution in forward
    order; the downsample reads the block's input, the ``.conv1`` site (the
    pool between them preserves the scale)."""
    for name, bn, _ in STEM_UNITS:
        yield name, getattr(visual, name), getattr(visual, bn), name
    for spec in trunk_specs(visual):
        blk = _block(visual, spec)
        n = spec.name
        for i in (1, 2, 3):
            yield (f"{n}.conv{i}", getattr(blk, f"conv{i}"),
                   getattr(blk, f"bn{i}"), f"{n}.conv{i}")
        if spec.has_downsample:
            _, conv, bn = blk.downsample
            yield f"{n}.downsample", conv, bn, f"{n}.conv1"


def _front_units(visual: ModifiedResNet, float_blocks: int) -> set:
    """Names of the units the bf16 front keeps: the stem and the first
    ``float_blocks`` bottlenecks (none when it is 0)."""
    if float_blocks <= 0:
        return set()
    names = {name for name, _, _ in STEM_UNITS}
    for spec in trunk_specs(visual)[:float_blocks]:
        names |= {f"{spec.name}.conv{i}" for i in (1, 2, 3)}
        names.add(f"{spec.name}.downsample")
    return names


@torch.no_grad()
def prepare_int8_tower(visual: ModifiedResNet,
                       amax: Dict[str, torch.Tensor],
                       float_blocks: int = 0) -> Int8ConvTower:
    """Fold the BatchNorms, fold the per-input-channel activation scales
    into the kernels, and quantize the kernels per output channel.
    ``float_blocks`` keeps the stem and the first N bottlenecks as folded
    bf16 units (``int8_trunk_apply`` takes the same value)."""
    scales = {s: a.float().clamp_min(1e-8) / (254.0 if is_asym_site(s)
                                                else 127.0)
              for s, a in amax.items()}
    front = _front_units(visual, float_blocks)
    units: Dict[str, dict] = {}
    for name, conv, bn, in_site in _units_of(visual):
        w, b = fold_bn(conv, bn)
        kernel = w.shape[-1]
        if name in front:
            units[name] = {"w": w.to(torch.bfloat16), "b": b,
                           "kernel": kernel}
            continue
        w_eff = w * scales[in_site][None, :, None, None]
        s_w = w_eff.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
        w_q = torch.round(w_eff / s_w[:, None, None, None]).clamp(
            -127, 127)
        if is_asym_site(in_site):
            # the consumer reads q = x / s - 128: conv(x / s, w) =
            # conv(q, w) + 128 sum w, exact for the int8 kernel itself
            b = b + 128.0 * s_w * w_q.sum(dim=(1, 2, 3))
        units[name] = {"w_q": flatten_weight(w_q.to(torch.int8)),
                       "s_w": s_w, "b": b, "kernel": kernel}
    return Int8ConvTower(units=units, scales=scales,
                         inv={s: torch.reciprocal(v)
                              for s, v in scales.items()})


# ---------------------------------------------------------------------------
# int8 inference graph
# ---------------------------------------------------------------------------

def _int8_conv(tower: Int8ConvTower, name: str, xq, stride=1):
    u = tower.units[name]
    k = u["kernel"]
    return int8_conv2d(xq, u["w_q"], (k, k), (stride, stride),
                       (k // 2, k // 2))


def _float_unit(tower: Int8ConvTower, name: str, xf, stride=1):
    """A folded bf16 convolution + bias of the front, NCHW; output bf16."""
    u = tower.units[name]
    y = F.conv2d(xf.to(torch.bfloat16), u["w"], stride=stride,
                 padding=u["kernel"] // 2)
    return y + _bias(u["b"].to(torch.bfloat16))


def _float_front(visual, tower, specs, x, float_blocks):
    """The stem and the first ``float_blocks`` bottlenecks as folded bf16
    convolutions (cuDNN), NCHW bf16 out."""
    xf = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    for name, _, stride in STEM_UNITS:
        xf = torch.relu(_float_unit(tower, name, xf, stride))
    xf = F.avg_pool2d(xf, 2)
    for spec in specs[:float_blocks]:
        n = spec.name
        f = torch.relu(_float_unit(tower, f"{n}.conv1", xf))
        f = torch.relu(_float_unit(tower, f"{n}.conv2", f))
        if spec.stride > 1:
            f = F.avg_pool2d(f, spec.stride)
        f = _float_unit(tower, f"{n}.conv3", f)
        identity = xf
        if spec.has_downsample:
            if spec.stride > 1:
                identity = F.avg_pool2d(identity, spec.stride)
            identity = _float_unit(tower, f"{n}.downsample", identity)
        xf = torch.relu(f + identity)
    return xf


@torch.no_grad()
def int8_trunk_apply(visual: ModifiedResNet, tower: Int8ConvTower,
                     x: torch.Tensor,
                     epilogue_dtype: torch.dtype = torch.float32,
                     float_blocks: int = 0,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Normalized float pixels ``[B, H, W, 3]`` -> the trunk's features
    ``[B, h, w, C]`` in ``out_dtype`` (default: the epilogue dtype), NHWC.
    Between the convolutions of the quantized region the tensors are int8;
    each convolution's epilogue is one E1 launch on the card, each integer
    pool one E2.  ``float_blocks`` must match ``prepare_int8_tower``."""
    ep = epilogue_dtype
    out_name = str(out_dtype or ep).replace("torch.", "")
    specs = trunk_specs(visual)

    def inv(site):
        if ep == torch.float32:
            return tower.inv[site]
        # the reciprocal of the scale in the epilogue dtype, as JAX's
        # _requant takes it
        return torch.reciprocal(tower.scales[site].to(ep)).float()

    def requant(v, site):
        return int8_conv_epilogue(v, inv(site), ep=ep,
                                  out="asym" if is_asym_site(site) else "sym")

    if float_blocks > 0:
        xf = _float_front(visual, tower, specs, x, float_blocks)
        if float_blocks >= len(specs):
            return xf.permute(0, 2, 3, 1).to(out_dtype or ep)
        # the float -> int8 boundary
        xq = requant(xf.permute(0, 2, 3, 1),
                     f"{specs[float_blocks].name}.conv1")
    else:
        xq = requant(x, "conv1")
        first_site = f"{specs[0].name}.conv1"
        for (name, _, stride), nxt in zip(STEM_UNITS,
                                          ("conv2", "conv3", first_site)):
            u = tower.units[name]
            xq = int8_conv_epilogue(
                _int8_conv(tower, name, xq, stride), inv(nxt), u["s_w"],
                u["b"], relu=True, ep=ep,
                out="asym" if is_asym_site(nxt) else "sym")
        xq = int8_avg_pool(xq)

    for i, spec in enumerate(specs):
        if i < float_blocks:
            continue
        n = spec.name
        units = tower.units
        u1, u2, u3 = (units[f"{n}.conv{j}"] for j in (1, 2, 3))
        q2 = int8_conv_epilogue(_int8_conv(tower, f"{n}.conv1", xq),
                                inv(f"{n}.conv2"), u1["s_w"], u1["b"],
                                relu=True, out="sym", ep=ep)
        q3 = int8_conv_epilogue(_int8_conv(tower, f"{n}.conv2", q2),
                                inv(f"{n}.conv3"), u2["s_w"], u2["b"],
                                relu=True, out="asym", ep=ep)
        if spec.stride > 1:
            q3 = int8_avg_pool(q3)
        acc3 = _int8_conv(tower, f"{n}.conv3", q3)
        if spec.has_downsample:
            # the branch is requantized (symmetric), so that the residual
            # add reads int8, not a second int32 map
            idq = int8_avg_pool(xq) if spec.stride > 1 else xq
            ud = units[f"{n}.downsample"]
            site = f"{n}.downsample_out"
            residual = int8_conv_epilogue(
                _int8_conv(tower, f"{n}.downsample", idq), inv(site),
                ud["s_w"], ud["b"], out="sym", ep=ep)
            res_mode, s_res = "sym", tower.scales[site]
        else:
            # the block input is an asymmetric site: (q + 128) s
            residual, res_mode = xq, "asym"
            s_res = tower.scales[f"{n}.conv1"]
        last = i + 1 == len(specs)
        nxt = None if last else f"{specs[i + 1].name}.conv1"
        xq = int8_conv_epilogue(
            acc3, None if last else inv(nxt), u3["s_w"], u3["b"], residual,
            s_res, res_mode, relu=True, ep=ep,
            out=out_name if last else
            ("asym" if is_asym_site(nxt) else "sym"))
    return xq


# ---------------------------------------------------------------------------
# Serving integration
# ---------------------------------------------------------------------------

def build_int8_encoder(model, calib_batches):
    """Calibrate and prepare; returns ``(encode, tower)``, where
    ``encode(pixels)`` maps NHWC pixels (uint8, or already normalized
    float) to normalized embeddings: a drop-in for
    ``serving.RetrievalIndex``'s image encoder.  The trunk's output goes
    through the model's own attention pool and embedding head in the
    model's dtype."""
    visual = model.visual_model
    if not isinstance(visual, ModifiedResNet):
        raise NotImplementedError(
            f"the int8-dataflow trunk takes a ModifiedResNet tower "
            f"(m_resnet50/101); got {type(visual).__name__}: use "
            f"models.quant_tower's interceptor for other towers")
    amax = calibrate_amax(visual, calib_batches, model.pixel_mean,
                          model.pixel_std)
    tower = prepare_int8_tower(visual, amax)

    @torch.no_grad()
    def encode(pixels: torch.Tensor) -> torch.Tensor:
        # uint8 = raw pixels; float = already normalized (normalizing twice
        # would land far outside the calibrated ranges)
        if pixels.dtype == torch.uint8:
            pixels = preprocess_pixels(pixels, None, model.pixel_mean,
                                       model.pixel_std)
        feat = int8_trunk_apply(visual, tower, pixels.float(),
                                out_dtype=model.dtype)
        feat = visual.attnpool(feat.permute(0, 3, 1, 2))
        return l2_normalize(model.embed_image(feat).float(), dim=1)

    return encode, tower
