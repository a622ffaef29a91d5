"""Weights between the JAX package, the reference torch layout and the port.

* :func:`state_dict_from_jax` — the JAX ``TrainState`` pieces (as numpy
  arrays) -> a reference-layout state dict for the port's serving model.
  It is the inverse of ``textreid_tpu/utils/weight_convert.py``'s importers
  for the query towers and embed layers, written again in numpy alone (the
  port never imports JAX), and it also carries the frozen token table,
  which the reference layout has no slot for.
* :func:`load_reference_state_dict` — a reference ``.pth`` state dict ->
  the port's model, refusing any key it does not know.

Layout rules: flax conv ``[kh, kw, in, out]`` -> torch ``[out, in, kh, kw]``;
flax dense ``[in, out]`` -> torch ``[out, in]``; our GRU ``fwd_w_ih_l0
[E, 3H]`` -> ``gru.weight_ih_l0 [3H, E]`` (gate order r, z, n); BN
scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var.
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
    """CLIP ModifiedResNet: the inverse of ``convert_m_resnet``."""
    for i in (1, 2, 3):
        out[f"{prefix}conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
        _bn(out, f"{prefix}bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    for name in (k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        src = f"{prefix}layer{stage}.{block}"
        bp, bs = params[name], stats[name]
        for i in (1, 2, 3):
            out[f"{src}.conv{i}.weight"] = _conv(bp[f"conv{i}"]["kernel"])
            _bn(out, f"{src}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
        if "downsample_conv" in bp:
            out[f"{src}.downsample.0.weight"] = _conv(
                bp["downsample_conv"]["kernel"])
            _bn(out, f"{src}.downsample.1", bp["downsample_bn"],
                bs["downsample_bn"])
    attn = params["attnpool"]
    out[f"{prefix}attnpool.positional_embedding"] = attn["positional_embedding"]
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(out, f"{prefix}attnpool.{name}", attn[name])


def _textual(out: dict, prefix: str, params: dict) -> None:
    """bi-GRU: the inverse of ``convert_gru``."""
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
    state dict (numpy values): query towers, embed layers, and the frozen
    token table when the text tower has one."""
    params = _numpy_tree(pieces["params"])
    stats = _numpy_tree(pieces.get("batch_stats", {}))
    constants = _numpy_tree(pieces.get("constants", {}))
    out: dict = {}
    _visual(out, "visual_model.", params["visual"], stats["visual"])
    _textual(out, "textual_model.", params["textual"])
    table = constants.get("textual", {}).get("frozen_token_table")
    if table is not None:
        out[FROZEN_TABLE_KEY] = table
    _dense(out, "embed_model.v_embed_layer", params["v_embed_layer"])
    _dense(out, "embed_model.t_embed_layer", params["t_embed_layer"])
    return out


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping) -> None:
    """Load a reference-layout state dict (numpy or torch values, with or
    without a DataParallel ``module.`` prefix) into the port's model.

    Keys the serving model has no use for (MoCo key encoders, projectors,
    queues, the loss projection) are ignored by name.  The frozen token
    table may be absent, as it is from every reference checkpoint: the
    model keeps the table it was built with.  Any other missing or
    unexpected key raises ``KeyError``."""
    clean = {}
    for key, value in sd.items():
        key = re.sub(r"^module\.", "", key)
        for old, new in _SIMPLE_HEAD_NAMES.items():
            if key.startswith(old):
                key = new + key[len(old):]
        if not _IGNORED.match(key):
            clean[key] = (value if isinstance(value, torch.Tensor)
                          else torch.from_numpy(np.array(value)))
    expected = set(model.state_dict())
    missing = expected - set(clean) - {FROZEN_TABLE_KEY}
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
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}, path)
