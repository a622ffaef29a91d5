"""Plain PyTorch reference of the benchmark's models and of their MoCo
train step: an image tower and a text tower, the embedding layers, the
MoCo losses and Adam.

Each tower is a module of its own, found by the name that the
configuration file gives it (``towers``: ``image/<name>.py``,
``text/<name>.py``; ``tower``), so that a configuration with another
architecture brings a file and edits none.  The towers are written from
the published descriptions (CLIP, arXiv:2103.00020; TextReID,
arXiv:2110.10807), and nothing here imports the program under test: it
is given the same weights, queues and batches as the program and
computes from them alone.  Parameters are a flat ``{name: tensor}`` dict
under the names of CLIP's layout (``param_spec`` lists them), so the
benchmark can hand one set of seeded tensors to both sides.

Every convolution and matrix product of the towers and embedding layers
rounds its two operands through ``Precision``: ``"float32"`` leaves them
(the reference; run with TF32 off), ``"fp8"`` rounds them to float8 e4m3
with a per-tensor scale in the forward pass (the control: the precision
below the bfloat16 that the configurations state).  The loss tail is
float32 either way, as the configurations state it."""

from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Params, Precision, Spec, dense, linear

# the InfoNCE temperature of the MoCo head (TextReID's moco_head/loss.py)
MOCO_TEMPERATURE = 0.07
# an element whose step-1 gradient is under this share of the median
# leaf's root mean square moves under Adam by round-off alone (the key
# projection's bias under softmax): train_steps marks it "still"
STILL = 1e-3


def tower(part: str, cfg: dict) -> ModuleType:
    """The module of the ``part`` (``image`` or ``text``) tower that the
    configuration names in ``TOWERS``: ``spec(cfg)``, ``forward``,
    ``out_dim(cfg)`` and ``forward_ops(cfg, n)``."""
    name = cfg["TOWERS"][part]
    if not name.isidentifier():
        raise ValueError(f"no {part} tower {name!r}")
    return importlib.import_module(f".{part}.{name}", __package__)


def visual_out(cfg: dict) -> int:
    return tower("image", cfg).out_dim(cfg)


def param_spec(cfg: dict) -> Spec:
    """``(name, shape, kind)`` of every tensor the model is given, in a
    fixed order; ``kind`` is one of ``conv``, ``matrix`` (``[out, in]``),
    ``matrix_t`` (``[in, out]``), ``norm``, ``norm_residual`` (the scale of
    a bottleneck's last BatchNorm, which ends its residual branch),
    ``bias``, ``embedding``, ``table`` (the frozen token table, a buffer),
    ``running_mean`` and ``running_var`` (buffers)."""
    m = cfg["MODEL"]
    d = m["EMBEDDING"]["FEATURE_SIZE"]
    text = tower("text", cfg)
    return [*tower("image", cfg).spec(cfg), *text.spec(cfg),
            *linear("embed_model.v_embed_layer", visual_out(cfg), d),
            *linear("embed_model.t_embed_layer", text.out_dim(cfg), d),
            ("embed_model.loss_evaluator.projection",
             (d, m["NUM_CLASSES"]), "matrix_t")]


BUFFER_KINDS = ("table", "running_mean", "running_var")


def trainable(cfg: dict):
    """Names of the parameters the optimizer trains, in spec order."""
    return [n for n, _, kind in param_spec(cfg) if kind not in BUFFER_KINDS]


# -- the towers ---------------------------------------------------------------

def preprocess(pixels: torch.Tensor, erase: Optional[torch.Tensor],
               cfg: dict) -> torch.Tensor:
    """uint8 NHWC -> normalised float32 NCHW; the RandomErasing rectangle
    (``[apply, top, left, h, w]`` a row) holds the raw pixel mean, written
    into the normalised image (torchvision's behaviour)."""
    mean = torch.tensor(cfg["INPUT"]["PIXEL_MEAN"], device=pixels.device)
    std = torch.tensor(cfg["INPUT"]["PIXEL_STD"], device=pixels.device)
    x = (pixels.float() / 255.0 - mean) / std
    if erase is not None:
        e = erase.long()
        rows = torch.arange(x.shape[1], device=x.device)
        cols = torch.arange(x.shape[2], device=x.device)
        for i in torch.nonzero(e[:, 0]).flatten().tolist():
            _, top, left, eh, ew = e[i].tolist()
            inside = (((rows >= top) & (rows < top + eh))[:, None]
                      & ((cols >= left) & (cols < left + ew))[None, :])
            x[i] = torch.where(inside[..., None], mean, x[i])
    return x.permute(0, 3, 1, 2)


def encode_image(P: Params, cfg: dict, pixels: torch.Tensor,
                 erase: Optional[torch.Tensor], train: bool,
                 q: Precision) -> torch.Tensor:
    return tower("image", cfg).forward(P, preprocess(pixels, erase, cfg),
                                       cfg, train, q)


@torch.no_grad()
def batch_statistics(P: Params, cfg: dict, pixels: torch.Tensor) -> dict:
    """Each BatchNorm's batch ``(mean, var)`` in a training forward of the
    image tower over ``pixels``; ``{}`` for a tower without BatchNorm."""
    image = tower("image", cfg)
    if not hasattr(image, "batch_statistics"):
        return {}
    return image.batch_statistics(P, cfg, preprocess(pixels, None, cfg))


def encode_text(P: Params, cfg: dict, token_ids: torch.Tensor,
                lengths: torch.Tensor, batch_max: torch.Tensor,
                q: Precision) -> torch.Tensor:
    return tower("text", cfg).forward(P, cfg, token_ids, lengths, batch_max,
                                      q)


def embed_image(P: Params, feat: torch.Tensor, q: Precision) -> torch.Tensor:
    return dense(feat, P["embed_model.v_embed_layer.weight"],
                  P["embed_model.v_embed_layer.bias"], q)


def embed_text(P: Params, feat: torch.Tensor, q: Precision) -> torch.Tensor:
    return dense(feat, P["embed_model.t_embed_layer.weight"],
                  P["embed_model.t_embed_layer.bias"], q)


def encode(P: Params, cfg: dict, pixels, token_ids, lengths, batch_max,
           q: Precision, erase=None, train: bool = False):
    """``(v_embed, t_embed)`` of the towers and embedding layers."""
    v = embed_image(P, encode_image(P, cfg, pixels, erase, train, q), q)
    t = embed_text(P, encode_text(P, cfg, token_ids, lengths, batch_max, q),
                   q)
    return v, t


# -- the losses ---------------------------------------------------------------

def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def instance_loss(projection, v_embed, t_embed, labels, epsilon: float):
    """Label-smoothed identity loss of both modalities through one
    projection whose columns are L2-normalised."""
    proj = projection / projection.norm(dim=0, keepdim=True).clamp_min(1e-12)
    classes = proj.shape[1]
    target = torch.full((labels.shape[0], classes), epsilon / classes,
                        device=labels.device)
    target[torch.arange(labels.shape[0]), labels] += 1.0 - epsilon
    total = 0.0
    for embed in (v_embed, t_embed):
        log_p = torch.log_softmax(embed @ proj, dim=-1)
        total = total + (-target * log_p).mean(dim=0).sum()
    return total


def global_align_loss(v_embed, t_embed, labels, alpha=0.6, beta=0.4,
                      scale_pos=10.0, scale_neg=40.0):
    sim = l2n(v_embed) @ l2n(t_embed).T
    pos = (labels[:, None] == labels[None, :]).float()
    loss = (pos * F.softplus(-scale_pos * (sim - alpha))).sum() + (
        (1.0 - pos) * F.softplus(scale_neg * (sim - beta))).sum()
    return loss * 2.0 / labels.shape[0]


def infonce_loss(v_q, t_q, v_k, t_k, labels, v_queue, t_queue, id_queue,
                 temperature=MOCO_TEMPERATURE):
    """Both directions: each query's positive is the other modality's key
    of its row; the negatives are the other modality's queue, less every
    slot whose identity is one of the batch's."""
    taken = (id_queue[None, :] == labels[:, None]).any(dim=0)
    total = 0.0
    for query, key, queue in ((v_q, t_k, t_queue), (t_q, v_k, v_queue)):
        pos = (query * key).sum(dim=1, keepdim=True)
        neg = (query @ queue.T).masked_fill(taken[None, :], float("-inf"))
        logits = torch.cat([pos, neg], dim=1) / temperature
        total = total + (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()
    return total


# -- the MoCo train step ----------------------------------------------------

def train_steps(cfg: dict, weights: Params, queues: dict, batches: list,
                q: Precision, lr: float) -> dict:
    """The first ``len(batches)`` MoCo steps from ``weights`` (f32) and
    ``queues`` (``v``, ``t``, ``ids``):

    1. the key towers move towards the query towers' pre-step weights
       (``key = m key + (1 - m) query``; the key towers start as a copy);
    2. the keys: the key towers' features through the query's embedding
       layers, L2-normalised, without a gradient;
    3. the query towers' embeddings and the three losses (identity with
       label smoothing, InfoNCE against the queues, global alignment),
       their sum differentiated;
    4. Adam with L2 decay added to the gradient (``lr`` times the group's
       factor: "bias" in a name takes ``BIAS_LR_FACTOR`` and
       ``WEIGHT_DECAY_BIAS``);
    5. the keys and identities written into the queues.

    Returns ``{"loss": [the summed loss a step], "grad": {name: step 1's
    gradient with its decay}, "still": {name: where that gradient is
    under ``STILL`` times the median leaf's root mean square}, "delta":
    {name: the change after the last step}, "queue": the two queues
    after it, stacked}``."""
    s = cfg["SOLVER"]
    m = cfg["MODEL"]
    b1, b2 = s["ADAM_ALPHA"], s["ADAM_BETA"]
    names = trainable(cfg)
    params = {n: weights[n].detach().clone().requires_grad_(True)
              for n in names}
    frozen = {n: t for n, t in weights.items() if n not in params}
    keys = {n: weights[n].detach().clone() for n in names}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p))
               for n, p in params.items()}
    v_queue, t_queue = queues["v"].clone(), queues["t"].clone()
    id_queue = queues["ids"].clone()
    ptr, momentum = 0, m["MOCO"]["M"]
    epsilon = m["EMBEDDING"]["EPSILON"]
    out = {"loss": [], "grad": {}, "still": {}, "delta": {}}
    for step, batch in enumerate(batches, start=1):
        with torch.no_grad():
            for n in names:
                keys[n].mul_(momentum).add_(params[n], alpha=1.0 - momentum)
            k_all = {**frozen, **keys}
            p_now = {**frozen, **{n: p.detach() for n, p in params.items()}}
            v_feat = encode_image(k_all, cfg, batch["pixels"], batch["erase"],
                                  True, q)
            t_feat = encode_text(k_all, cfg, batch["token_ids"],
                                 batch["lengths"], batch["lengths"].max(), q)
            v_k = l2n(embed_image(p_now, v_feat, q))
            t_k = l2n(embed_text(p_now, t_feat, q))
        P = {**frozen, **params}
        labels = batch["pids"].long()
        v_embed, t_embed = encode(P, cfg, batch["pixels"], batch["token_ids"],
                                  batch["lengths"], batch["lengths"].max(), q,
                                  erase=batch["erase"], train=True)
        loss = (instance_loss(P["embed_model.loss_evaluator.projection"],
                              v_embed, t_embed, labels, epsilon)
                + infonce_loss(l2n(v_embed), l2n(t_embed), v_k, t_k, labels,
                               v_queue, t_queue, id_queue)
                + global_align_loss(v_embed, t_embed, labels))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                bias = "bias" in n
                decay = s["WEIGHT_DECAY_BIAS"] if bias else s["WEIGHT_DECAY"]
                factor = s["BIAS_LR_FACTOR"] if bias else 1.0
                if n.startswith("visual_model."):
                    factor *= s["VISUAL_LR_FACTOR"]
                g = g + decay * params[n]
                if step == 1:
                    out["grad"][n] = g.clone()
                m1, m2 = moments[n]
                m1.mul_(b1).add_(g, alpha=1.0 - b1)
                m2.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (m2.sqrt() / math.sqrt(1.0 - b2 ** step)).add_(1e-8)
                params[n].addcdiv_(m1, denom,
                                   value=-lr * factor / (1.0 - b1 ** step))
            n_rows = labels.shape[0]
            v_queue[ptr:ptr + n_rows] = v_k
            t_queue[ptr:ptr + n_rows] = t_k
            id_queue[ptr:ptr + n_rows] = labels
            ptr = (ptr + n_rows) % id_queue.shape[0]
            if step == 1:
                rms = sorted(float(g.norm()) / math.sqrt(g.numel())
                             for g in out["grad"].values())
                floor = STILL * rms[len(rms) // 2]
                out["still"] = {n: g.abs() < floor
                                for n, g in out["grad"].items()}
        del grads, loss, v_embed, t_embed
    with torch.no_grad():
        for n in names:
            out["delta"][n] = params[n].detach() - weights[n]
    out["queue"] = torch.cat([v_queue, t_queue])
    return out
