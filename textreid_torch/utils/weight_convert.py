"""Weights between the JAX package, the reference torch layout and the port.

* :func:`state_dict_from_jax` — the JAX ``TrainState`` pieces (as numpy
  arrays) -> a reference-layout state dict for the port's model: query
  towers (CLIP ModifiedResNet, torchvision ResNet or ViT; bi-GRU or text
  transformer), embed layers, MoCo projectors and the loss projection.
  It is the inverse of
  ``textreid_tpu/utils/weight_convert.py``'s importers, written again in
  numpy alone (the port never imports JAX), and it also carries the frozen
  token table, which the reference layout has no slot for.
* :func:`train_state_from_jax` — the same for a whole MoCo train state:
  query and key models, queues and pointer.
* :func:`convert_clip_vit` — a CLIP ViT state dict -> the port's
  ``visual_model`` keys, with the position embedding resized.
* :func:`convert_clip_m_resnet` — the same for a CLIP ModifiedResNet
  (RN50, RN101), BatchNorm running statistics included.
* :func:`convert_clip_text` — the text half of a CLIP state dict -> the
  port's ``textual_model`` keys, the positional table resampled to the
  configured context length.
* :func:`int8_tower_from_jax` — a prepared JAX ``Int8ViT`` / ``Int8Text``
  (numpy arrays) -> the port's prepared ``Int8Tower``.
* :func:`int8_conv_tower_from_jax` — a prepared JAX int8 ModifiedResNet
  trunk (``models/int8_tower.py``'s ``Int8Tower``) -> the port's
  ``Int8ConvTower``.
* :func:`load_reference_state_dict` — a reference ``.pth`` state dict ->
  the port's model, refusing any key it does not know.
* :func:`export_reference_state_dict` — a train state of the port (a
  checkpoint's payload) -> the reference layout the upstream torch code
  loads, MoCo key encoders and queues included: the JAX package's
  ``export_textreid_checkpoint``.

Layout rules: flax conv ``[kh, kw, in, out]`` -> torch ``[out, in, kh, kw]``;
flax dense ``[in, out]`` -> torch ``[out, in]``; our GRU ``fwd_w_ih_l0
[E, 3H]`` -> ``gru.weight_ih_l0 [3H, E]`` (gate order r, z, n); BN
scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var;
LayerNorm scale/bias -> weight/bias.  Queues are ``[K, D]`` in both
packages.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

FROZEN_TABLE_KEY = "textual_model.frozen_token_table"
# Reference checkpoint entries the serving model has no use for: the MoCo
# key encoders and projectors, the queues and the loss's classifier.
_IGNORED = re.compile(
    r"^embed_model\.((v|t)_encoder_k\.|(v|t)_fc_(q|k)\.|loss_evaluator\.|"
    r"(v|t|id)_queue$|queue_ptr$)")
# the reference simple head names its embed layers differently
_SIMPLE_HEAD_NAMES = {
    "embed_model.visual_embed_layer.": "embed_model.v_embed_layer.",
    "embed_model.textual_embed_layer.": "embed_model.t_embed_layer.",
}


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _conv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _linear(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))


def _bn(out: dict, prefix: str, p: dict, s: dict) -> None:
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]
    out[f"{prefix}.running_mean"] = s["mean"]
    out[f"{prefix}.running_var"] = s["var"]
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _dense(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _linear(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = p["bias"]


def _visual(out: dict, prefix: str, params: dict, stats: dict) -> None:
    """A ResNet: the inverse of ``convert_m_resnet`` (CLIP's
    ModifiedResNet: a 3-convolution stem, 3-convolution blocks, the
    attention pool) and of ``convert_resnet`` (torchvision's: one stem
    convolution, 2- or 3-convolution blocks)."""
    for i in (i for i in (1, 2, 3) if f"conv{i}" in params):
        out[f"{prefix}conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
        _bn(out, f"{prefix}bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    for name in (k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        src = f"{prefix}layer{stage}.{block}"
        bp, bs = params[name], stats[name]
        for i in (i for i in (1, 2, 3) if f"conv{i}" in bp):
            out[f"{src}.conv{i}.weight"] = _conv(bp[f"conv{i}"]["kernel"])
            _bn(out, f"{src}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
        if "downsample_conv" in bp:
            out[f"{src}.downsample.0.weight"] = _conv(
                bp["downsample_conv"]["kernel"])
            _bn(out, f"{src}.downsample.1", bp["downsample_bn"],
                bs["downsample_bn"])
    if "attnpool" not in params:
        return
    attn = params["attnpool"]
    out[f"{prefix}attnpool.positional_embedding"] = attn["positional_embedding"]
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(out, f"{prefix}attnpool.{name}", attn[name])


def _ln(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]


def _blocks(out: dict, prefix: str, params: dict) -> None:
    """``block_{i}`` -> ``transformer.resblocks.{i}`` (CLIP's names), for
    the ViT and the text transformer alike."""
    blocks = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("block_"))
    for i in blocks:
        bp, dst = params[f"block_{i}"], f"{prefix}transformer.resblocks.{i}"
        _ln(out, f"{dst}.ln_1", bp["ln_1"])
        _ln(out, f"{dst}.ln_2", bp["ln_2"])
        out[f"{dst}.attn.in_proj_weight"] = _linear(bp["qkv"]["kernel"])
        out[f"{dst}.attn.in_proj_bias"] = bp["qkv"]["bias"]
        _dense(out, f"{dst}.attn.out_proj", bp["out_proj"])
        _dense(out, f"{dst}.mlp.c_fc", bp["c_fc"])
        _dense(out, f"{dst}.mlp.c_proj", bp["c_proj"])


def _vit(out: dict, prefix: str, params: dict) -> None:
    """CLIP ViT: the inverse of ``convert_clip_vit``."""
    out[f"{prefix}conv1.weight"] = _conv(params["patch_embed"]["kernel"])
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"{prefix}{name}"] = params[name]
    _ln(out, f"{prefix}ln_pre", params["ln_pre"])
    _ln(out, f"{prefix}ln_post", params["ln_post"])
    _blocks(out, prefix, params)


def _text_transformer(out: dict, prefix: str, params: dict) -> None:
    """CLIP text transformer: the inverse of the JAX package's
    ``convert_clip_text``."""
    out[f"{prefix}token_embedding.weight"] = params["token_embedding"]
    out[f"{prefix}positional_embedding"] = params["positional_embedding"]
    out[f"{prefix}text_projection"] = params["text_projection"]
    _ln(out, f"{prefix}ln_final", params["ln_final"])
    _blocks(out, prefix, params)


def _textual(out: dict, prefix: str, params: dict) -> None:
    """The text transformer, or the bi-GRU (the inverse of
    ``convert_gru``)."""
    if "text_projection" in params:
        return _text_transformer(out, prefix, params)
    if "token_embedding" in params:
        table = params["token_embedding"].copy()
        table[0] = 0.0  # nn.Embedding(padding_idx=0): the pad row is zero
        out[f"{prefix}embed.weight"] = table
    elif "embed_adapter" in params:
        _dense(out, f"{prefix}embed", params["embed_adapter"])
    layers = sorted(int(k.rsplit("l", 1)[1]) for k in params
                    if k.startswith("fwd_w_ih_l"))
    for layer in layers:
        for src, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for w in ("ih", "hh"):
                out[f"{prefix}gru.weight_{w}_l{layer}{suffix}"] = _linear(
                    params[f"{src}_w_{w}_l{layer}"])


def state_dict_from_jax(pieces: dict) -> dict:
    """JAX ``TrainState`` pieces (``params``, ``batch_stats``,
    ``constants``; any Mapping of array-likes) -> the port's reference-layout
    state dict (numpy values): query towers, embed layers, MoCo projectors
    and loss projection where the params have them, and the frozen token
    table when the text tower has one."""
    params = _numpy_tree(pieces["params"])
    stats = _numpy_tree(pieces.get("batch_stats", {}))
    constants = _numpy_tree(pieces.get("constants", {}))
    out: dict = {}
    if "patch_embed" in params["visual"]:
        _vit(out, "visual_model.", params["visual"])
    else:
        _visual(out, "visual_model.", params["visual"], stats["visual"])
    _textual(out, "textual_model.", params["textual"])
    table = constants.get("textual", {}).get("frozen_token_table")
    if table is not None:
        out[FROZEN_TABLE_KEY] = table
    _dense(out, "embed_model.v_embed_layer", params["v_embed_layer"])
    _dense(out, "embed_model.t_embed_layer", params["t_embed_layer"])
    for tower in ("v", "t"):
        if f"{tower}_fc" in params:
            fc = params[f"{tower}_fc"]
            _dense(out, f"embed_model.{tower}_fc_q.0", fc["fc1"])
            _dense(out, f"embed_model.{tower}_fc_q.2", fc["fc2"])
    if "projection" in params:
        out["embed_model.loss_evaluator.projection"] = params["projection"]
    return out


def train_state_from_jax(pieces: dict) -> dict:
    """A JAX MoCo ``TrainState``'s pieces -> ``{"model", "key_model"}``
    state dicts (see :func:`state_dict_from_jax`; the key model is built
    from ``key_params``/``key_batch_stats``) plus ``v_queue``, ``t_queue``
    ``[K, D]``, ``id_queue [K]`` and ``queue_ptr`` as numpy values, for
    ``engine.state.TrainState.load``; a simple head's (no ``key_params``)
    -> ``{"model"}``."""
    if pieces.get("key_params") is None:
        return {"model": state_dict_from_jax(pieces)}
    constants = pieces.get("constants", {})
    return {
        "model": state_dict_from_jax(pieces),
        "key_model": state_dict_from_jax({
            "params": pieces["key_params"],
            "batch_stats": pieces.get("key_batch_stats", {}),
            "constants": constants}),
        "v_queue": np.asarray(pieces["v_queue"]),
        "t_queue": np.asarray(pieces["t_queue"]),
        "id_queue": np.asarray(pieces["id_queue"]),
        "queue_ptr": int(np.asarray(pieces["queue_ptr"])),
    }


def _bilinear_axis(x: np.ndarray, new_size: int, axis: int) -> np.ndarray:
    """Bilinear resample along one axis with half-pixel centres and no
    antialiasing: torch ``F.interpolate(mode="bilinear",
    align_corners=False)``."""
    old_size = x.shape[axis]
    if old_size == new_size:
        return x
    coords = (np.arange(new_size) + 0.5) * (old_size / new_size) - 0.5
    lo = np.floor(coords).astype(np.int64)
    frac = (coords - lo).astype(x.dtype)
    a = np.take(x, np.clip(lo, 0, old_size - 1), axis=axis)
    b = np.take(x, np.clip(lo + 1, 0, old_size - 1), axis=axis)
    shape = [1] * x.ndim
    shape[axis] = new_size
    frac = frac.reshape(shape)
    return a * (1 - frac) + b * frac


def resize_pos_embed(posemb: np.ndarray, new_grid) -> np.ndarray:
    """Bilinear resize of a CLIP position embedding ``[1 + g*g, W]`` from
    its square grid to ``new_grid``; the class-token row is kept."""
    tok, grid = posemb[:1], posemb[1:]
    side = int(round(len(grid) ** 0.5))
    if side * side != len(grid):
        raise ValueError(f"non-square source grid: {len(grid)} positions")
    grid = grid.reshape(side, side, -1)
    grid = _bilinear_axis(grid, new_grid[0], axis=0)
    grid = _bilinear_axis(grid, new_grid[1], axis=1)
    return np.concatenate(
        [tok, grid.reshape(new_grid[0] * new_grid[1], -1)], axis=0)


def convert_clip_vit(sd: Mapping, layers: int, final_grid=None,
                     prefix: str = "visual_model.") -> dict:
    """CLIP VisionTransformer state dict (a whole CLIP archive's
    ``visual.*`` subtree, or the bare tower) -> the port's ``visual_model``
    keys (numpy values) for the first ``layers`` blocks, the position
    embedding resized to ``final_grid`` when the grids differ.  The port's
    ViT keeps CLIP's names, so this is a rename and the resize."""
    if any(k.startswith("visual.") for k in sd):
        # a whole CLIP archive: its text tower has transformer.resblocks.*
        # keys of its own
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    sd = {k: np.asarray(v) for k, v in sd.items()}
    pos = sd["positional_embedding"]
    if final_grid is not None and len(pos) - 1 != final_grid[0] * final_grid[1]:
        sd["positional_embedding"] = resize_pos_embed(pos, final_grid)
    keep = re.compile(r"^(conv1\.weight|class_embedding|positional_embedding|"
                      r"ln_pre\.|ln_post\.|proj$|transformer\.resblocks\.)")
    block = re.compile(r"^transformer\.resblocks\.(\d+)\.")
    out = {prefix + k: v for k, v in sd.items() if keep.match(k) and not (
        block.match(k) and int(block.match(k).group(1)) >= layers)}
    for i in range(layers):
        if f"{prefix}transformer.resblocks.{i}.attn.in_proj_weight" not in out:
            raise KeyError(f"CLIP ViT state dict has no block {i}")
    return out


def convert_clip_m_resnet(sd: Mapping, final_grid) -> dict:
    """CLIP ModifiedResNet state dict (a whole CLIP archive's ``visual.*``
    subtree, or the bare tower) -> the port's ``ModifiedResNet`` keys
    (numpy values), the attention pool's position embedding resized from
    CLIP's square grid to ``final_grid`` (the JAX package's
    ``convert_m_resnet``).  The port keeps CLIP's names, so this is the
    prefix strip and the resize; BatchNorm's ``num_batches_tracked``,
    which neither package reads, is dropped."""
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    out = {k: np.asarray(v) for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    name = "attnpool.positional_embedding"
    if name in out and len(out[name]) - 1 != final_grid[0] * final_grid[1]:
        out[name] = resize_pos_embed(out[name], final_grid)
    return out


def convert_clip_text(sd: Mapping, layers: int, context_length=None,
                      prefix: str = "textual_model.") -> dict:
    """The text half of a CLIP state dict -> the port's ``textual_model``
    keys (numpy values) for the first ``layers`` blocks.  A CLIP archive
    holds the text tower at the top level (``token_embedding.weight``,
    ``positional_embedding``, ``transformer.resblocks.*``, ``ln_final``,
    ``text_projection``) beside the ``visual.*`` subtree: pass the whole
    dict, the visual keys are ignored.  When ``context_length`` differs
    from the checkpoint's (77), the positional table is resampled linearly
    along the sequence (half-pixel centres, no antialiasing).  The port's
    text transformer keeps CLIP's names, so this is a filter and the
    resize."""
    sd = {k: np.asarray(v) for k, v in sd.items()
          if not k.startswith("visual.")}
    pos = sd["positional_embedding"]
    if context_length is not None and len(pos) != context_length:
        sd["positional_embedding"] = _bilinear_axis(pos, context_length,
                                                    axis=0)
    keep = re.compile(r"^(token_embedding\.weight|positional_embedding|"
                      r"ln_final\.|text_projection$|transformer\.resblocks\.)")
    block = re.compile(r"^transformer\.resblocks\.(\d+)\.")
    out = {prefix + k: v for k, v in sd.items() if keep.match(k) and not (
        block.match(k) and int(block.match(k).group(1)) >= layers)}
    for i in range(layers):
        if f"{prefix}transformer.resblocks.{i}.attn.in_proj_weight" not in out:
            raise KeyError(f"CLIP text state dict has no block {i}")
    return out


def int8_tower_from_jax(units: Mapping, scales: Mapping, consts: Mapping,
                        dtype: torch.dtype = torch.float32, device="cpu"):
    """A prepared JAX ``Int8ViT`` or ``Int8Text`` (its ``units``, ``scales``
    and ``consts`` as numpy arrays) -> the port's ``Int8Tower`` on
    ``device``, so that the two ``int8_*_apply`` run on identical quantized
    weights.  The patchify conv's ``[kh, kw, ci, co]`` weight becomes the
    product's ``[kh kw ci, co]``; every ``w_q`` is held as the transpose of
    a contiguous ``[co, ci]``; the projection stays bf16 and the token table
    takes the tower ``dtype``, as in the JAX package."""
    from ..models.int8_vit import Int8Tower

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    out_units = {}
    for site, u in units.items():
        w_q = np.asarray(u["w_q"], np.int8)
        w_q = torch.from_numpy(w_q.reshape(-1, w_q.shape[-1]).copy())
        out_units[site] = {"w_q": w_q.T.contiguous().to(device).T,
                           "s_w": f32(u["s_w"]), "b": f32(u["b"])}
    casts = {"proj": torch.bfloat16, "token": dtype}
    return Int8Tower(
        units=out_units, scales={s: f32(a) for s, a in scales.items()},
        consts={k: f32(a).to(casts.get(k, torch.float32))
                for k, a in consts.items()},
        dtype=dtype)


def int8_conv_tower_from_jax(units: Mapping, scales: Mapping, device="cpu"):
    """A prepared JAX ``Int8Tower`` of ``models/int8_tower.py`` (its
    ``units`` and ``scales`` as numpy arrays) -> the port's
    ``Int8ConvTower`` on ``device``, so that the two ``int8_trunk_apply``
    run on identical quantized weights.  An HWIO ``w_q`` becomes the
    product's ``[kh kw ci (+ zero rows to a multiple of 8), co]``; a unit of
    the bf16 front keeps its kernel as OIHW bf16; ``inv`` is ``1 / scale``
    in f32."""
    from ..models.int8_tower import Int8ConvTower
    from ..ops.int8_conv import flatten_weight

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    out_units = {}
    for name, u in units.items():
        if "w_q" in u:
            w = np.asarray(u["w_q"], np.int8)
            oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
            out_units[name] = {"w_q": flatten_weight(oihw.to(device)),
                               "s_w": f32(u["s_w"]), "b": f32(u["b"]),
                               "kernel": w.shape[0]}
        else:
            w = np.asarray(u["w"], np.float32)
            out_units[name] = {
                "w": f32(w.transpose(3, 2, 0, 1)).to(torch.bfloat16),
                "b": f32(u["b"]), "kernel": w.shape[0]}
    scales = {s: f32(a) for s, a in scales.items()}
    return Int8ConvTower(units=out_units, scales=scales,
                         inv={s: torch.reciprocal(v)
                              for s, v in scales.items()})


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping) -> None:
    """Load a reference-layout state dict (numpy or torch values, with or
    without a DataParallel ``module.`` prefix) into the port's model.

    MoCo key encoders, projectors, queues and the loss projection are
    loaded where the model has them and ignored by name where it does
    not.  The frozen token
    table may be absent, as it is from every reference checkpoint: the
    model keeps the table it was built with.  Any other missing or
    unexpected key raises ``KeyError``."""
    expected = set(model.state_dict())
    clean = {}
    for key, value in sd.items():
        key = re.sub(r"^module\.", "", key)
        for old, new in _SIMPLE_HEAD_NAMES.items():
            if key.startswith(old):
                key = new + key[len(old):]
        if key in expected or not _IGNORED.match(key):
            clean[key] = (value if isinstance(value, torch.Tensor)
                          else torch.from_numpy(np.array(value)))
    # training-only pieces the model has may be absent from a serving
    # checkpoint: the model keeps what it was built with
    optional = {k for k in expected if _IGNORED.match(k)} | {FROZEN_TABLE_KEY}
    missing = expected - set(clean) - optional
    unexpected = set(clean) - expected
    if missing or unexpected:
        raise KeyError(
            f"checkpoint does not match the model: missing "
            f"{sorted(missing)[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unexpected {sorted(unexpected)[:8]}"
            f"{'...' if len(unexpected) > 8 else ''}")
    model.load_state_dict(clean, strict=False)


def save_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Write the model's state dict as a reference ``.pth``
    (``{"model": state_dict}``), with CPU tensors."""
    save_reference_state_dict(model.state_dict(), path)


def save_reference_state_dict(sd: Mapping, path: str) -> None:
    """Write a state dict (torch or numpy values) as a reference ``.pth``
    (``{"model": state_dict}``), with CPU tensors."""
    torch.save({"model": {k: _cpu_tensor(v) for k, v in sd.items()}}, path)


def _cpu_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


# the key model's names -> the reference's key encoders (the inverse of
# utils/bootstrap.py:_KEY_ENCODER_NAMES); its other entries are dropped
_KEY_EXPORT_NAMES = (("visual_model.", "embed_model.v_encoder_k."),
                     ("textual_model.", "embed_model.t_encoder_k."),
                     ("embed_model.v_fc_q.", "embed_model.v_fc_k."),
                     ("embed_model.t_fc_q.", "embed_model.t_fc_k."))


def _export_tower(out: dict, sd: Mapping, renames) -> None:
    """``sd``'s entries under ``renames`` (``(ours, reference)`` prefixes),
    as the JAX exporter writes them: the frozen token table left out (no
    reference weight), BatchNorm's ``num_batches_tracked`` an int64 zero,
    and a learned token table (``embed.weight`` with no bias: an
    ``nn.Embedding(padding_idx=0)``) with its pad row 0 zeroed."""
    for key, value in sd.items():
        if key == FROZEN_TABLE_KEY:
            continue
        name = next((ref + key[len(ours):] for ours, ref in renames
                     if key.startswith(ours)), None)
        if name is None:
            continue
        value = _cpu_tensor(value)
        if key.endswith("num_batches_tracked"):
            value = torch.zeros((), dtype=torch.int64)
        elif (key == "textual_model.embed.weight"
              and "textual_model.embed.bias" not in sd):
            value = value.clone()
            value[0] = 0.0
        out[name] = value


def export_reference_state_dict(cfg, payload: Mapping) -> dict:
    """A train state of the port -> a reference-layout state dict (CPU
    tensors): the JAX package's ``export_textreid_checkpoint``, key for key
    and value for value.

    ``payload`` has ``TrainState.state_dict``'s schema (a checkpoint's
    payload, or ``train_state_from_jax``'s output): ``model`` and, for the
    MoCo head, ``key_model``, ``v_queue``, ``t_queue`` ``[K, D]``,
    ``id_queue [K]`` and ``queue_ptr``; anything else (the optimizer,
    ``step``, ``meta``) is dropped.  The query model keeps its names (the
    reference's), but for the simple head's embed layers
    (``visual_embed_layer``, ``textual_embed_layer`` there); the key model
    goes under the reference's key encoders (``v_encoder_k``,
    ``t_encoder_k``, ``{v,t}_fc_k``), its copies of the embed layers and
    the loss projection left out; the queues become ``[D, K]``,
    ``id_queue [1, K]`` and ``queue_ptr [1]``, both int64.  Only a bi-GRU
    text tower has a reference counterpart: another raises
    ``ValueError``."""
    if cfg.MODEL.TEXTUAL_MODEL != "bigru":
        raise ValueError(
            f"the reference has no {cfg.MODEL.TEXTUAL_MODEL!r} textual "
            "tower — only bigru states can be exported to its layout")
    moco = cfg.MODEL.EMBEDDING.EMBED_HEAD == "moco"
    query = [("visual_model.", "visual_model."),
             ("textual_model.", "textual_model.")]
    if moco:
        query.append(("embed_model.", "embed_model."))
    else:
        query += [(ours, ref) for ref, ours in _SIMPLE_HEAD_NAMES.items()]
        query.append(("embed_model.loss_evaluator.",
                      "embed_model.loss_evaluator."))
    out: dict = {}
    _export_tower(out, payload["model"], query)
    if not moco:
        return out
    _export_tower(out, payload["key_model"], _KEY_EXPORT_NAMES)
    em = "embed_model."
    out[em + "v_queue"] = _cpu_tensor(payload["v_queue"]).T.contiguous()
    out[em + "t_queue"] = _cpu_tensor(payload["t_queue"]).T.contiguous()
    out[em + "id_queue"] = _cpu_tensor(payload["id_queue"]).reshape(
        1, -1).to(torch.int64)
    out[em + "queue_ptr"] = torch.as_tensor(
        np.asarray(payload["queue_ptr"])).reshape(1).to(torch.int64)
    return out
