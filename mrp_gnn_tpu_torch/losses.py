"""Mask-aware training losses (port of ``mrp_gnn_tpu/losses.py``).

Depth regression (L1, berHu or scale-invariant log) plus segmentation
cross-entropy with multi-task weights. Padded robot-view nodes and depth
pixels without ground truth (target 0) contribute neither loss nor
gradient. Shapes are the model's NHWC outputs: depth [V, H, W], seg logits
[V, H, W, K], labels int [V, H, W], node_mask bool [V].

Every term is a ratio of sums over the valid pixels of the whole batch
(berHu's switch point a max over it). Each term is computed in two parts:
its local sums, then a function of those sums. Under a mesh (``mesh``, a
``parallel.mesh.Mesh``) each rank holds its own node rows (under spatial
sharding its image rows of them), so the sums are taken over the mesh's
batch group in between (the world; under tensor parallelism the ranks of
this rank's model index, since the ranks of a model group compute the same
loss): every term's sums of a call go into one all-reduce whose backward
is the identity (``Mesh.world_sum``), so each rank's gradient is its own
share of the global loss's; the berHu max's gradient reaches only the rank
that holds it (``Mesh.world_max``). Without a mesh the terms are computed
as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _valid(target: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    return (target > 0) & node_mask[:, None, None]


def _ratio(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return total / torch.clamp(count, min=1)


def _l1_parts(pred, target, node_mask, mesh=None) -> tuple:
    valid = _valid(target, node_mask)
    err = (pred - target).abs() * valid
    return [err.sum(), valid.sum()], _ratio


def _silog_parts(pred, target, node_mask, mesh=None, lam: float = 0.5):
    valid = _valid(target, node_mask)
    d = (torch.log(torch.clamp(pred, min=1e-6))
         - torch.log(torch.clamp(target, min=1e-6)))
    d = d * valid

    def finish(sq, s, count):
        n = torch.clamp(count, min=1)
        return sq / n - lam * (s / n) ** 2
    return [(d ** 2).sum(), d.sum(), valid.sum()], finish


def _berhu_parts(pred, target, node_mask, mesh=None) -> tuple:
    valid = _valid(target, node_mask)
    d = (pred - target).abs() * valid
    top = torch.amax(d)
    c = torch.clamp(0.2 * (top if mesh is None else mesh.world_max(top)),
                    min=1e-6)
    loss = torch.where(d <= c, d, (d ** 2 + c ** 2) / (2 * c))
    return [(loss * valid).sum(), valid.sum()], _ratio


def _seg_ce_parts(logits, labels, node_mask, mesh=None) -> tuple:
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    valid = node_mask[:, None, None].to(ce.dtype).expand_as(ce)
    return [(ce * valid).sum(), valid.sum()], _ratio


def _terms(mesh, parts: dict) -> dict:
    """Each term of ``parts`` (name: (local sums, finish)) from its sums,
    taken over the batch group under a mesh in one collective for them
    all."""
    sums = [s for local, _ in parts.values() for s in local]
    if mesh is not None:
        sums = mesh.world_sum(sums)
    out, i = {}, 0
    for name, (local, finish) in parts.items():
        out[name] = finish(*sums[i:i + len(local)])
        i += len(local)
    return out


def _one(mesh, parts: tuple) -> torch.Tensor:
    return _terms(mesh, {0: parts})[0]


def masked_depth_l1(pred: torch.Tensor, target: torch.Tensor,
                    node_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean L1 over valid pixels."""
    return _one(mesh, _l1_parts(pred, target, node_mask))


def masked_depth_silog(pred: torch.Tensor, target: torch.Tensor,
                       node_mask: torch.Tensor, lam: float = 0.5,
                       mesh=None) -> torch.Tensor:
    """Scale-invariant log loss (Eigen et al.) over valid pixels."""
    return _one(mesh, _silog_parts(pred, target, node_mask, lam=lam))


def masked_depth_berhu(pred: torch.Tensor, target: torch.Tensor,
                       node_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Reverse-Huber (berHu) loss: L1 near zero, quadratic in the tail, with
    the switch point c = 0.2 * max residual per batch (Laina et al.).

    The gradient flows through c's max; ``torch.amax`` splits it evenly
    among tied maxima, as ``jnp.max`` does.
    """
    return _one(mesh, _berhu_parts(pred, target, node_mask, mesh))


DEPTH_LOSSES = {
    "l1": masked_depth_l1,
    "berhu": masked_depth_berhu,
    "silog": masked_depth_silog,
}
_DEPTH_PARTS = {"l1": _l1_parts, "berhu": _berhu_parts,
                "silog": _silog_parts}


def masked_seg_ce(logits: torch.Tensor, labels: torch.Tensor,
                  node_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean cross-entropy over the pixels of valid nodes:
    -log_softmax(logits)[label], averaged over ``node_mask``."""
    return _one(mesh, _seg_ce_parts(logits, labels, node_mask))


def total_loss(outputs: dict, batch: dict, node_mask: torch.Tensor,
               depth_weight: float = 1.0, seg_weight: float = 1.0,
               depth_loss: str = "l1", mesh=None) -> tuple:
    """Weighted multi-task loss; returns (loss, per-term dict) with the JAX
    package's term names (``depth_<kind>``, ``seg_ce``, ``total``).
    ``mesh``: sums over its batch group, one all-reduce for every term
    (berHu's max takes one more); every rank gets the global terms."""
    parts, weights = {}, {}
    if "depth" in outputs:
        name = f"depth_{depth_loss}"
        parts[name] = _DEPTH_PARTS[depth_loss](outputs["depth"],
                                               batch["depth"], node_mask,
                                               mesh)
        weights[name] = depth_weight
    if "seg_logits" in outputs:
        parts["seg_ce"] = _seg_ce_parts(outputs["seg_logits"], batch["seg"],
                                        node_mask)
        weights["seg_ce"] = seg_weight
    terms = _terms(mesh, parts)
    loss = torch.zeros((), device=node_mask.device)
    for name, term in terms.items():
        loss = loss + weights[name] * term
    terms["total"] = loss
    return loss, terms
