"""The training step in plain PyTorch: the masked losses, global-norm
clipping and AdamW under a linear-warmup cosine schedule.

- depth: mean L1 over the pixels of real robots whose target depth is > 0;
- segmentation: mean cross-entropy over the pixels of real robots;
- total: ``depth_loss_weight`` x depth + ``seg_loss_weight`` x seg;
- the gradients are clipped to ``grad_clip_norm`` when their global norm
  reaches it (no epsilon), then AdamW (b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, decoupled weight decay on every parameter) takes update
  k at the schedule's value for k (0-based): linear from 0 over
  ``warmup_steps``, then cosine decay to 0 at ``steps``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_terms(out: dict, depth, seg, node_mask, train: dict) -> dict:
    valid = (depth > 0) & node_mask[:, None, None]
    l1 = ((out["depth"] - depth).abs() * valid).sum() / valid.sum().clamp(min=1)
    logp = F.log_softmax(out["seg_logits"], dim=-1)
    ce = -torch.gather(logp, -1, seg.long()[..., None])[..., 0]
    nodes = node_mask[:, None, None].to(ce.dtype).expand_as(ce)
    seg_ce = (ce * nodes).sum() / nodes.sum().clamp(min=1)
    total = train["depth_loss_weight"] * l1 + train["seg_loss_weight"] * seg_ce
    return {"depth_l1": l1, "seg_ce": seg_ce, "total": total}


def learning_rate(train: dict, count: int) -> float:
    peak, warmup = train["learning_rate"], train["warmup_steps"]
    decay = max(train["steps"], warmup + 1) - warmup
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class AdamW:
    """Clipping and AdamW over a dict of parameters (updated in place)."""

    def __init__(self, params: dict, train: dict):
        self.params = params
        self.train = train
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update; returns the clipped gradients."""
        tr = self.train
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = (1.0 if float(norm) < tr["grad_clip_norm"]
                 else tr["grad_clip_norm"] / norm)
        lr = learning_rate(tr, self.count)
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            self.nu[k].mul_(B2).add_((1.0 - B2) * g * g)
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS)
            p.add_(-lr * (update + tr["weight_decay"] * p))
        return clipped


def follow(params: dict, batches, model: dict, train: dict,
           forward) -> dict:
    """Runs ``len(batches)`` training steps of the network ``forward`` (a
    reference module's, or a planted fault's) from ``params`` (copied).
    Each batch: (images, depth, seg, RefGraph) on the params' device.
    Returns the loss terms of each step, the clipped gradients of the first
    step and the parameters after the last."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(p, train)
    losses, first = [], None
    for images, depth, seg, graph in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        out = forward(leaves, images, graph, model)
        terms = loss_terms(out, depth, seg, graph.node_mask, train)
        grads = torch.autograd.grad(terms["total"], list(leaves.values()))
        clipped = opt.step(dict(zip(leaves, grads)))
        if first is None:
            first = clipped
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        del out, terms, grads, leaves
    return {"losses": losses, "grads": first, "params": p}
