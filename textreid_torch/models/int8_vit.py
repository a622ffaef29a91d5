"""Int8-dataflow ViT encoder: int8 activations into every block matmul
(counterpart of ``textreid_tpu/models/int8_vit.py``).

A post-training-quantized inference path for the gallery encode.  Per
transformer block (eval semantics of ``models/vit.py:TransformerBlock``):

* LayerNorm affines fold into the consumer: ``Linear(ln(x)) == norm(x) @
  (gamma[:, None] W) + (beta @ W + b)``, so the quantized tensor is the
  unscaled ``norm(x)``;
* every block matmul (qkv, out_proj, c_fc, c_proj) is int8 x int8 -> int32
  with two-level input quantization: static per-channel scales from a
  calibration pass, folded into the weights, and a dynamic per-token scale
  (``ops/requant.py``); weights are quantized per output channel;
* attention stays in the tower dtype through K5; the patchify conv is one
  int8 product over unfolded patches with one dynamic scale per image;
  ``ln_pre``, ``ln_post`` and the final projection stay float.

Where the kernels sit (``int8_block_apply``): K9 ``fused_requant`` before
``qkv`` and ``c_fc`` (``"ln"``) and before ``out_proj`` (``"none"``); then
either K7 ``fused_int8_ffn`` for the whole FFN (``fused_ffn`` on) or K8
``fused_int8_matmul_requant`` for ``c_fc`` + quickGELU + requant followed by
the plain int8 product for ``c_proj`` (``fused_ffn`` off).  The other int8
products go to ``ops.int8_mm.int_matmul``.  On a CUDA tensor each wrapper
launches its kernel or raises; on the CPU each runs its plain version.  K8
and K7 keep the ``c_fc`` output in f32 up to the rounding, where a
composition at the tower dtype would round it to bf16 before the GELU: in
an f32 tower the two are the same, in a bf16 tower the kernels are tighter.

Calibration needs no labels: batches with the serving input distribution run
through the folded float graph (the float tower's eval forward,
reassociated), recording the per-channel abs-max at every matmul input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..ops.attention import fused_attention
from ..ops.int8_mm import (fused_int8_ffn, fused_int8_matmul_requant,
                           int8_matmul, int_matmul)
from ..ops.requant import fused_requant, norm_no_affine, quick_gelu
from .losses import l2_normalize
from .model import preprocess_pixels
from .vit import VisionTransformer

# Quantized-matmul sites inside one block, in forward order.
BLOCK_SITES = ("qkv", "out_proj", "c_fc", "c_proj")


@dataclass
class Int8Tower:
    """A prepared int8 tower (ViT or text transformer) on one device.

    ``units``: site -> ``{"w_q": int8 [ci, co], "s_w": f32 [co], "b": f32
    [co]}``; ``w_q`` is the transpose of a contiguous ``[co, ci]`` tensor,
    the layout both ``torch._int_mm`` and the kernels read without a copy
    (the patchify conv's ``ci`` runs over kernel row, kernel column, input
    channel).  ``scales``: site -> f32 ``[ci]``.  ``consts``: the float
    remainder (class/positional or token/positional tables, the outer
    LayerNorm affines in f32, the projection in bf16).  ``dtype`` is the
    dtype of the residual stream and of attention."""

    units: Dict[str, dict]
    scales: Dict[str, torch.Tensor]
    consts: Dict[str, torch.Tensor]
    dtype: torch.dtype = torch.float32


def _record_amax(record: Optional[dict], site: str, x: torch.Tensor) -> None:
    if record is not None:
        record[site] = x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)


def _ln_affine(x, ln) -> torch.Tensor:
    return norm_no_affine(x) * ln.weight.float() + ln.bias.float()


# ---------------------------------------------------------------------------
# Folded float graph (calibration / agreement reference)
# ---------------------------------------------------------------------------

def folded_block_float(h, block, site_prefix: str,
                       record: Optional[dict] = None):
    """One ``TransformerBlock`` in eval float form with the LN affines
    folded into the consumer matmuls (shared by both towers' calibration
    graphs); f32 throughout."""
    n1 = norm_no_affine(h)
    _record_amax(record, f"{site_prefix}qkv", n1)
    wq = block.attn.in_proj_weight.float().T
    qkv = n1 @ (block.ln_1.weight.float()[:, None] * wq) + (
        block.ln_1.bias.float() @ wq + block.attn.in_proj_bias.float())
    attn = fused_attention(qkv.contiguous(), block.heads, block.causal)
    _record_amax(record, f"{site_prefix}out_proj", attn)
    h = h + attn @ block.attn.out_proj.weight.float().T \
        + block.attn.out_proj.bias.float()

    n2 = norm_no_affine(h)
    _record_amax(record, f"{site_prefix}c_fc", n2)
    wf = block.mlp.c_fc.weight.float().T
    ff = n2 @ (block.ln_2.weight.float()[:, None] * wf) + (
        block.ln_2.bias.float() @ wf + block.mlp.c_fc.bias.float())
    ff = quick_gelu(ff)
    _record_amax(record, f"{site_prefix}c_proj", ff)
    return h + ff @ block.mlp.c_proj.weight.float().T \
        + block.mlp.c_proj.bias.float()


def patch_kernel(vit: VisionTransformer) -> torch.Tensor:
    """``conv1.weight [co, ci, kh, kw]`` as the product's ``[kh kw ci, co]``
    (the JAX kernel's HWIO order, flattened)."""
    w = vit.conv1.weight.float()
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


def unfold_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, gh gw, patch patch C]``, the grid
    row-major and each patch in (row, column, channel) order."""
    batch, height, width, chans = x.shape
    gh, gw = height // patch, width // patch
    x = x[:, :gh * patch, :gw * patch]
    x = x.reshape(batch, gh, patch, gw, patch, chans).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, gh * gw, patch * patch * chans)


def folded_vit_float(vit: VisionTransformer, x: torch.Tensor,
                     record: Optional[dict] = None) -> torch.Tensor:
    """Eval forward of the ViT on normalized NHWC pixels with every
    LN affine folded into its consumer: the module's forward, reassociated,
    recording the per-channel abs-max at every quantization site."""
    xf = x.float()
    _record_amax(record, "patch", xf)
    h = unfold_patches(xf, vit.patch_size) @ patch_kernel(vit)
    cls = vit.class_embedding.float().expand(h.shape[0], 1, -1)
    h = torch.cat([cls, h], dim=1) + vit.positional_embedding.float()
    h = _ln_affine(h, vit.ln_pre)
    for i, block in enumerate(vit.transformer.resblocks):
        h = folded_block_float(h, block, f"block_{i}.", record)
    return _ln_affine(h[:, 0], vit.ln_post) @ vit.proj.float()


# ---------------------------------------------------------------------------
# Preparation: calibration + weight quantization
# ---------------------------------------------------------------------------

def accumulate_amax(acc: Dict[str, torch.Tensor], record: dict) -> None:
    """Elementwise max of ``record`` into ``acc``."""
    for site, amax in record.items():
        prev = acc.get(site)
        acc[site] = amax if prev is None else torch.maximum(prev, amax)


@torch.no_grad()
def calibrate_vit_amax(vit: VisionTransformer, batches, pixel_mean,
                       pixel_std) -> Dict[str, torch.Tensor]:
    """Per-channel abs-max at every quantized-matmul input over calibration
    batches (``[B, H, W, 3]`` uint8 or already normalized float), the
    elementwise max across batches."""
    device = vit.proj.device
    acc: Dict[str, torch.Tensor] = {}
    for pixels in batches:
        pixels = torch.as_tensor(pixels).to(device)
        if pixels.dtype == torch.uint8:
            pixels = preprocess_pixels(pixels, None, pixel_mean, pixel_std)
        record: dict = {}
        folded_vit_float(vit, pixels, record)
        accumulate_amax(acc, record)
    if not acc:
        raise ValueError("calibration needs at least one batch")
    return acc


def activation_scales(amax: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {site: a.float().clamp_min(1e-8) / 127.0
            for site, a in amax.items()}


def quantize_unit(w_eff: torch.Tensor, bias: torch.Tensor) -> dict:
    """``w_eff [ci, co]`` f32 -> per-output-channel symmetric int8."""
    s_w = w_eff.abs().amax(dim=0).clamp_min(1e-12) / 127.0
    w_q = torch.round(w_eff / s_w).clamp(-127, 127).to(torch.int8)
    return {"w_q": w_q.T.contiguous().T, "s_w": s_w,
            "b": bias.detach().float()}


def quantize_block(block, site_prefix: str, scales, units: dict) -> None:
    """Quantize one block's four matmuls, the LN affine folded where a
    LayerNorm feeds the site (shared by the ViT and text towers)."""
    for site, dense_w, dense_b, ln in (
            ("qkv", block.attn.in_proj_weight, block.attn.in_proj_bias,
             block.ln_1),
            ("out_proj", block.attn.out_proj.weight, block.attn.out_proj.bias,
             None),
            ("c_fc", block.mlp.c_fc.weight, block.mlp.c_fc.bias, block.ln_2),
            ("c_proj", block.mlp.c_proj.weight, block.mlp.c_proj.bias, None)):
        w, b = dense_w.float().T, dense_b.float()
        s_in = scales[f"{site_prefix}{site}"]
        if ln is not None:
            units[f"{site_prefix}{site}"] = quantize_unit(
                (ln.weight.float() * s_in)[:, None] * w,
                ln.bias.float() @ w + b)
        else:
            units[f"{site_prefix}{site}"] = quantize_unit(s_in[:, None] * w, b)


@torch.no_grad()
def prepare_int8_vit(vit: VisionTransformer, amax: Dict[str, torch.Tensor],
                     dtype: torch.dtype = torch.float32) -> Int8Tower:
    """Fold the LN affines and the per-input-channel activation scales into
    the weights and quantize them per output channel; ``dtype`` is the
    dtype the tower's residual stream runs in."""
    scales = activation_scales(amax)
    units: Dict[str, dict] = {}
    kernel = patch_kernel(vit)  # [kh kw ci, co]
    per_input = scales["patch"].repeat(kernel.shape[0] // 3)  # ci fastest
    units["patch"] = quantize_unit(
        kernel * per_input[:, None], kernel.new_zeros(kernel.shape[1]))
    for i, block in enumerate(vit.transformer.resblocks):
        quantize_block(block, f"block_{i}.", scales, units)
    consts = {
        "cls": vit.class_embedding.detach().float(),
        "pos": vit.positional_embedding.detach().float(),
        "ln_pre_scale": vit.ln_pre.weight.detach().float(),
        "ln_pre_bias": vit.ln_pre.bias.detach().float(),
        "ln_post_scale": vit.ln_post.weight.detach().float(),
        "ln_post_bias": vit.ln_post.bias.detach().float(),
        "proj": vit.proj.detach().to(torch.bfloat16),
    }
    return Int8Tower(units=units, scales=scales, consts=consts, dtype=dtype)


# ---------------------------------------------------------------------------
# int8 inference graph
# ---------------------------------------------------------------------------

def resolve_fused_ffn(fused_ffn, default: bool) -> bool:
    """``None`` takes the tower's ``default``, a bool forces it; anything
    else raises.  No environment variable is read."""
    if fused_ffn is None:
        return default
    if isinstance(fused_ffn, bool):
        return fused_ffn
    raise ValueError(f"fused_ffn must be None, True or False; got "
                     f"{fused_ffn!r}")


def _site_matmul(tower: Int8Tower, site: str, xq, row_scale):
    u = tower.units[site]
    return int8_matmul(xq, u["w_q"], u["s_w"], u["b"], row_scale, tower.dtype)


def int8_block_apply(h, tower: Int8Tower, site_prefix: str, heads: int,
                     causal: bool = False, fused_ffn=None,
                     fused_ffn_default: bool = False):
    """One ``TransformerBlock`` in int8-dataflow form; the residual stream
    ``h`` stays in ``tower.dtype``."""
    fused = resolve_fused_ffn(fused_ffn, fused_ffn_default)
    scales = tower.scales
    q8, rq = fused_requant(h, scales[f"{site_prefix}qkv"], "ln")
    qkv = _site_matmul(tower, f"{site_prefix}qkv", q8, rq)
    attn = fused_attention(qkv.contiguous(), heads, causal)
    a8, ra = fused_requant(attn, scales[f"{site_prefix}out_proj"], "none")
    h = h + _site_matmul(tower, f"{site_prefix}out_proj", a8, ra)

    f8, rf = fused_requant(h, scales[f"{site_prefix}c_fc"], "ln")
    u1 = tower.units[f"{site_prefix}c_fc"]
    u2 = tower.units[f"{site_prefix}c_proj"]
    s_mid = scales[f"{site_prefix}c_proj"]
    if fused:
        return h + fused_int8_ffn(f8, u1["w_q"], u1["s_w"], u1["b"], rf, s_mid,
                                  u2["w_q"], u2["s_w"], u2["b"],
                                  out_dtype=tower.dtype)
    g8, rg = fused_int8_matmul_requant(f8, u1["w_q"], u1["s_w"], u1["b"], rf,
                                       s_mid, op="gelu")
    return h + _site_matmul(tower, f"{site_prefix}c_proj", g8, rg)


@torch.no_grad()
def int8_vit_apply(vit: VisionTransformer, tower: Int8Tower, x: torch.Tensor,
                   fused_ffn=None) -> torch.Tensor:
    """Normalized float pixels ``[B, H, W, 3]`` -> ``[B, output_dim]``.
    ``fused_ffn``: see :func:`resolve_fused_ffn`; the ViT's default is off
    (K8 then the plain ``c_proj`` product)."""
    resolve_fused_ffn(fused_ffn, False)  # reject a bad value before any work
    batch = x.shape[0]
    fdt = tower.dtype
    consts = tower.consts
    # The patchify conv contracts over the whole receptive field, so its
    # dynamic scale is uniform over everything contracted: one per image.
    xn = x.float() * torch.reciprocal(tower.scales["patch"])
    r_img = xn.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6) * (
        1.0 / 127.0)
    v = xn * torch.reciprocal(r_img)
    v = v + torch.where(v >= 0, 0.5, -0.5)
    xq = v.clamp(-127.0, 127.0).to(torch.int8)
    u = tower.units["patch"]
    h = int_matmul(unfold_patches(xq, vit.patch_size), u["w_q"])
    h = h.float() * u["s_w"] * r_img.reshape(batch, 1, 1)

    h = torch.cat([consts["cls"].expand(batch, 1, -1), h], dim=1)
    h = h + consts["pos"]
    h = (norm_no_affine(h) * consts["ln_pre_scale"]
         + consts["ln_pre_bias"]).to(fdt)
    heads = vit.transformer.resblocks[0].heads
    for i in range(vit.layers):
        h = int8_block_apply(h, tower, f"block_{i}.", heads,
                             fused_ffn=fused_ffn)
    cls_out = (norm_no_affine(h[:, 0]) * consts["ln_post_scale"]
               + consts["ln_post_bias"])
    return cls_out.to(fdt) @ consts["proj"].to(fdt)


# ---------------------------------------------------------------------------
# Serving integration
# ---------------------------------------------------------------------------

def build_int8_vit_encoder(model, calib_batches):
    """Calibrate and prepare; returns ``(encode, tower)``, where
    ``encode(pixels)`` maps NHWC pixels (uint8, or already normalized
    float) to normalized embeddings: a drop-in for
    ``serving.RetrievalIndex``'s image encoder."""
    visual = model.visual_model
    if not isinstance(visual, VisionTransformer):
        raise NotImplementedError(
            f"the int8 ViT encoder needs a VisionTransformer tower; got "
            f"{type(visual).__name__}")
    amax = calibrate_vit_amax(visual, calib_batches, model.pixel_mean,
                              model.pixel_std)
    tower = prepare_int8_vit(visual, amax, model.dtype)

    @torch.no_grad()
    def encode(pixels: torch.Tensor) -> torch.Tensor:
        # uint8 = raw pixels; float = already normalized (normalizing twice
        # would land far outside the calibrated ranges)
        if pixels.dtype == torch.uint8:
            pixels = preprocess_pixels(pixels, None, model.pixel_mean,
                                       model.pixel_std)
        feat = int8_vit_apply(visual, tower, pixels)
        return l2_normalize(model.embed_image(feat).float(), dim=1)

    return encode, tower
