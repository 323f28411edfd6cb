"""Mask-aware training losses (port of ``mrp_gnn_tpu/losses.py``).

Depth regression (L1, berHu or scale-invariant log) plus segmentation
cross-entropy with multi-task weights. Padded robot-view nodes and depth
pixels without ground truth (target 0) contribute neither loss nor
gradient. Shapes are the model's NHWC outputs: depth [V, H, W], seg logits
[V, H, W, K], labels int [V, H, W], node_mask bool [V].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _valid(target: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    return (target > 0) & node_mask[:, None, None]


def _count(valid: torch.Tensor) -> torch.Tensor:
    return torch.clamp(valid.sum(), min=1)


def masked_depth_l1(pred: torch.Tensor, target: torch.Tensor,
                    node_mask: torch.Tensor) -> torch.Tensor:
    """Mean L1 over valid pixels."""
    valid = _valid(target, node_mask)
    err = (pred - target).abs() * valid
    return err.sum() / _count(valid)


def masked_depth_silog(pred: torch.Tensor, target: torch.Tensor,
                       node_mask: torch.Tensor, lam: float = 0.5) -> torch.Tensor:
    """Scale-invariant log loss (Eigen et al.) over valid pixels."""
    valid = _valid(target, node_mask)
    d = (torch.log(torch.clamp(pred, min=1e-6))
         - torch.log(torch.clamp(target, min=1e-6)))
    d = d * valid
    n = _count(valid)
    return (d ** 2).sum() / n - lam * (d.sum() / n) ** 2


def masked_depth_berhu(pred: torch.Tensor, target: torch.Tensor,
                       node_mask: torch.Tensor) -> torch.Tensor:
    """Reverse-Huber (berHu) loss: L1 near zero, quadratic in the tail, with
    the switch point c = 0.2 * max residual per batch (Laina et al.).

    The gradient flows through c's max; ``torch.amax`` splits it evenly
    among tied maxima, as ``jnp.max`` does.
    """
    valid = _valid(target, node_mask)
    d = (pred - target).abs() * valid
    c = torch.clamp(0.2 * torch.amax(d), min=1e-6)
    loss = torch.where(d <= c, d, (d ** 2 + c ** 2) / (2 * c))
    return (loss * valid).sum() / _count(valid)


DEPTH_LOSSES = {
    "l1": masked_depth_l1,
    "berhu": masked_depth_berhu,
    "silog": masked_depth_silog,
}


def masked_seg_ce(logits: torch.Tensor, labels: torch.Tensor,
                  node_mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the pixels of valid nodes:
    -log_softmax(logits)[label], averaged over ``node_mask``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    valid = node_mask[:, None, None].to(ce.dtype).expand_as(ce)
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1)


def total_loss(outputs: dict, batch: dict, node_mask: torch.Tensor,
               depth_weight: float = 1.0, seg_weight: float = 1.0,
               depth_loss: str = "l1") -> tuple:
    """Weighted multi-task loss; returns (loss, per-term dict) with the JAX
    package's term names (``depth_<kind>``, ``seg_ce``, ``total``)."""
    terms = {}
    loss = torch.zeros((), device=node_mask.device)
    if "depth" in outputs:
        fn = DEPTH_LOSSES[depth_loss]
        terms[f"depth_{depth_loss}"] = fn(outputs["depth"], batch["depth"],
                                          node_mask)
        loss = loss + depth_weight * terms[f"depth_{depth_loss}"]
    if "seg_logits" in outputs:
        terms["seg_ce"] = masked_seg_ce(outputs["seg_logits"], batch["seg"],
                                        node_mask)
        loss = loss + seg_weight * terms["seg_ce"]
    terms["total"] = loss
    return loss, terms
