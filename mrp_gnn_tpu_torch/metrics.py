"""Evaluation metrics: depth RMSE / AbsRel / delta accuracy and seg mIoU
(port of ``mrp_gnn_tpu/metrics.py``).

Accumulate / finalize pairs on tensors: ``evaluate`` folds each batch's
sufficient statistics into a running dict on the device and reads it back
once. Counts are exact integers; the confusion matrix holds float32 counts,
as the JAX package's ``bincount`` with float weights does.
"""

from __future__ import annotations

import torch


def depth_metrics_accumulate(pred: torch.Tensor, target: torch.Tensor,
                             node_mask: torch.Tensor) -> dict:
    """Sufficient statistics for the depth metrics over one batch.

    pred/target: [V, H, W]; node_mask: [V]. A pixel counts when its target
    depth is positive and its view is real.
    """
    valid = (target > 0) & node_mask[:, None, None]
    diff = (pred - target) * valid
    tclamp = target.clamp(min=1e-6)
    ratio = torch.where(valid, torch.maximum(pred / tclamp,
                                             target / pred.clamp(min=1e-6)),
                        torch.inf)
    return {
        "n": valid.sum(),
        "sq_err": (diff ** 2).sum(),
        "abs_rel": torch.where(valid, diff.abs() / tclamp, 0.0).sum(),
        "d1": (ratio < 1.25).sum(),
        "d2": (ratio < 1.25 ** 2).sum(),
        "d3": (ratio < 1.25 ** 3).sum(),
    }


def depth_metrics_finalize(acc: dict) -> dict:
    n = acc["n"].clamp(min=1)
    return {
        "rmse": torch.sqrt(acc["sq_err"] / n),
        "abs_rel": acc["abs_rel"] / n,
        "delta1": acc["d1"] / n,
        "delta2": acc["d2"] / n,
        "delta3": acc["d3"] / n,
    }


def seg_confusion_accumulate(logits: torch.Tensor, labels: torch.Tensor,
                             node_mask: torch.Tensor,
                             num_classes: int) -> torch.Tensor:
    """[K, K] confusion-matrix counts (rows = truth, cols = prediction).

    float32 counts, as JAX's: exact up to 2**24 per cell (8M pixels per
    eval at ``dynamic_swarm``). A scatter-add of the view mask, where
    ``torch.bincount`` would read the largest index back to the host."""
    pred = torch.argmax(logits, dim=-1)
    valid = node_mask[:, None, None].expand(labels.shape)
    idx = (labels.long() * num_classes + pred).reshape(-1)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                         device=logits.device)
    counts.index_add_(0, idx, valid.reshape(-1).to(torch.float32))
    return counts.reshape(num_classes, num_classes)


def _class_iou(confusion: torch.Tensor) -> tuple:
    tp = torch.diagonal(confusion)
    union = confusion.sum(0) + confusion.sum(1) - tp
    present = confusion.sum(1) > 0
    iou = torch.where(union > 0, tp / union.clamp(min=1), 0.0)
    return iou, present


def seg_miou(confusion: torch.Tensor) -> torch.Tensor:
    """Mean IoU over the classes present in the ground truth."""
    iou, present = _class_iou(confusion)
    return torch.where(present, iou, 0.0).sum() / present.sum().clamp(min=1)


def seg_per_class_iou(confusion: torch.Tensor) -> torch.Tensor:
    """Per-class IoU; classes absent from the ground truth report -1."""
    iou, present = _class_iou(confusion)
    return torch.where(present, iou, -1.0)


def tree_add(a, b):
    """Leaf-wise sum of two nested dicts of tensors."""
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    return a + b
