"""Loss library (counterpart of ``textreid_tpu/models/losses.py``).

The identity-classification loss with optional label smoothing, the
soft-margin global alignment loss, the MoCo InfoNCE loss and the
cross-modal projection losses (``cmpc_loss``, ``cmpm_loss``, which no head
uses: kept for capability parity, as in the JAX package), as pure
functions of f32 tensors.  The same-identity exclusion of queue negatives
is an additive ``-inf`` mask on the negative logits (built by the train
step), exactly as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch.nn.functional.normalize clamps the norm at 1e-12; so does the JAX
# package.
_NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = _NORM_EPS) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - true_logit).mean()


def cross_entropy_label_smooth(logits: torch.Tensor, labels: torch.Tensor,
                               epsilon: float = 0.1) -> torch.Tensor:
    """Targets ``(1 - eps) onehot + eps / C``; the loss is
    ``(-targets * log_probs).mean(0).sum()``."""
    num_classes = logits.shape[-1]
    log_probs = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(log_probs.dtype)
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-targets * log_probs).mean(dim=0).sum()


def instance_loss(projection: torch.Tensor, visual_embed: torch.Tensor,
                  textual_embed: torch.Tensor, labels: torch.Tensor,
                  scale: float = 1.0, norm: bool = False,
                  epsilon: float = 0.0) -> torch.Tensor:
    """Shared-projection identity loss; ``projection [feature, classes]``
    has its columns L2-normalised before the logits matmul."""
    if norm:
        visual_embed = l2_normalize(visual_embed, dim=-1)
        textual_embed = l2_normalize(textual_embed, dim=-1)
    projection = l2_normalize(projection, dim=0)
    v_logits = scale * (visual_embed @ projection)
    t_logits = scale * (textual_embed @ projection)
    if epsilon > 0:
        return (cross_entropy_label_smooth(v_logits, labels, epsilon)
                + cross_entropy_label_smooth(t_logits, labels, epsilon))
    return cross_entropy(v_logits, labels) + cross_entropy(t_logits, labels)


def global_align_loss(visual_embed: torch.Tensor, textual_embed: torch.Tensor,
                      labels: torch.Tensor, alpha: float = 0.6,
                      beta: float = 0.4, scale_pos: float = 10.0,
                      scale_neg: float = 40.0) -> torch.Tensor:
    """Soft-margin pairwise cosine alignment loss."""
    similarity = (l2_normalize(visual_embed, dim=-1)
                  @ l2_normalize(textual_embed, dim=-1).T)
    return global_align_loss_from_sim(similarity, labels, alpha, beta,
                                      scale_pos, scale_neg)


def global_align_loss_from_sim(similarity: torch.Tensor, labels: torch.Tensor,
                               alpha: float = 0.6, beta: float = 0.4,
                               scale_pos: float = 10.0,
                               scale_neg: float = 40.0) -> torch.Tensor:
    """The same loss on a precomputed similarity matrix."""
    batch_size = labels.shape[0]
    pos = (labels[:, None] == labels[None, :]).to(similarity.dtype)
    loss_pos = F.softplus(-scale_pos * (similarity - alpha))
    loss_neg = F.softplus(scale_neg * (similarity - beta))
    total = (pos * loss_pos).sum() + ((1.0 - pos) * loss_neg).sum()
    return total * 2.0 / batch_size


def infonce_loss(v_pos: torch.Tensor, v_neg: torch.Tensor,
                 t_pos: torch.Tensor, t_neg: torch.Tensor,
                 temperature: float = 0.07) -> torch.Tensor:
    """Bidirectional InfoNCE over ``[positive | queue negatives]``:
    ``*_pos [N, 1]``, ``*_neg [N, K]`` (``-inf`` marks a masked negative)."""

    def one_side(pos, neg):
        logits = torch.cat([pos, neg], dim=1) / temperature
        return (torch.logsumexp(logits, dim=-1) - logits[:, 0]).mean()

    return one_side(v_pos, v_neg) + one_side(t_pos, t_neg)


def cmpc_loss(projection: torch.Tensor, visual_embed: torch.Tensor,
              textual_embed: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Cross-Modal Projection Classification loss: each embedding projected
    onto the other modality's unit vector, classified by ``projection
    [feature, classes]`` with its columns (axis 0) L2-normalised."""
    visual_norm = l2_normalize(visual_embed, dim=-1)
    textual_norm = l2_normalize(textual_embed, dim=-1)
    projection = l2_normalize(projection, dim=0)
    image_proj_text = (visual_embed * textual_norm).sum(
        dim=1, keepdim=True) * textual_norm
    text_proj_image = (textual_embed * visual_norm).sum(
        dim=1, keepdim=True) * visual_norm
    return (cross_entropy(image_proj_text @ projection, labels)
            + cross_entropy(text_proj_image @ projection, labels))


def cmpm_loss(visual_embed: torch.Tensor, textual_embed: torch.Tensor,
              labels: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Cross-Modal Projection Matching loss: the KL divergence of each
    modality's softmax over projections from the normalised identity mask.

    The mask is divided by its row norms broadcast along the last axis
    (``[B, B] / [B]``), as the JAX package writes it; within one identity
    every row has the same norm, so this equals a row-wise divide.  Its
    zero entries enter the log as ``log(epsilon)``, so each row's sum adds
    large terms of opposite sign: the order of operations is the JAX
    package's."""
    labels_mask = (labels[:, None] == labels[None, :]).to(visual_embed.dtype)
    visual_norm = l2_normalize(visual_embed, dim=-1)
    textual_norm = l2_normalize(textual_embed, dim=-1)
    image_proj_text = visual_embed @ textual_norm.T
    text_proj_image = textual_embed @ visual_norm.T
    mask_norm = labels_mask / torch.linalg.vector_norm(labels_mask, dim=1)

    def kl_side(logits):
        pred = F.softmax(logits, dim=1)
        return (pred * (F.log_softmax(logits, dim=1)
                        - torch.log(mask_norm + epsilon))).sum(dim=1).mean()

    return kl_side(image_proj_text) + kl_side(text_proj_image)
