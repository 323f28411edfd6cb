"""Robot-graph message-passing fusion layer (port of
``mrp_gnn_tpu/models/fusion.py``).

SDDMM -> segment softmax -> SpMM over the batch graph, then a 1x1-conv fuse
of ego features with the aggregated message. The edge ops come from
``ops.dispatch`` by ``ops_impl``. Feature maps are NCHW here; the values are
flattened in NHWC order before the edge block, as the JAX layer flattens
them, so ``values`` [V, D] means the same thing in both packages.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from mrp_gnn_tpu_torch.graph import GraphBatch
from mrp_gnn_tpu_torch.models.encoder import Conv, Dense, GroupNorm
from mrp_gnn_tpu_torch.ops import dispatch


def default_edge_fusion(ops, aggregation: str, q, k, flat_values,
                        graph: GraphBatch) -> torch.Tensor:
    """Single-device edge block, fastest applicable path first: dense
    block-diagonal > ELL > edge list."""
    V = flat_values.shape[0]
    block = graph.scene_stride > 0
    ell = graph.ell_src is not None
    if aggregation == "attention":
        if block and ops.block_fused_attention is not None:
            return ops.block_fused_attention(q, k, flat_values, graph)
        if ell and ops.ell_attention is not None:
            return ops.ell_attention(q, k, flat_values, graph)
        logits = ops.sddmm(q, k, graph.edge_src, graph.edge_dst, graph.edge_mask)
        logits = logits / math.sqrt(q.shape[-1])
        alpha = ops.segment_softmax(logits, graph.edge_dst, V, graph.edge_mask)
        return ops.spmm(alpha, flat_values, graph.edge_src, graph.edge_dst, V,
                        graph.edge_mask)
    if aggregation == "mean":
        if block and ops.block_mean_agg is not None:
            return ops.block_mean_agg(flat_values, graph)
        if ell and ops.ell_mean is not None:
            return ops.ell_mean(flat_values, graph)
        return ops.segment_mean_agg(flat_values, graph.edge_src, graph.edge_dst,
                                    V, graph.edge_mask)
    if aggregation == "max":
        if block and ops.block_max_agg is not None:
            return ops.block_max_agg(flat_values, graph)
        if ell and ops.ell_max is not None:
            return ops.ell_max(flat_values, graph)
        return ops.segment_max_agg(flat_values, graph.edge_src, graph.edge_dst,
                                   V, graph.edge_mask)
    raise ValueError(f"unknown aggregation {aggregation!r}")


class GraphFusionLayer(nn.Module):
    """One round of cross-robot message passing on bottleneck feature maps.

    aggregation: "mean", "attention" or "max". With attention_heads > 1,
    each head scores and aggregates its own channel group.
    """

    def __init__(self, channels: int, aggregation: str = "attention",
                 attention_dim: int = 64, attention_heads: int = 1,
                 norm_groups: int = 8, dtype: torch.dtype = torch.float32,
                 ops_impl: str = "xla"):
        super().__init__()
        C = channels
        self.aggregation = aggregation
        self.attention_dim = attention_dim
        self.heads = attention_heads if aggregation == "attention" else 1
        if self.heads > 1 and C % self.heads:
            raise ValueError(f"channels {C} not divisible by "
                             f"attention_heads={self.heads}")
        self.ops_impl = ops_impl
        self.value = Conv(C, C, 1, dtype=dtype)
        if aggregation == "attention":
            self.query = Dense(C, self.heads * attention_dim, dtype)
            self.key = Dense(C, self.heads * attention_dim, dtype)
        self.update = Conv(2 * C, C, 1, bias=False, dtype=dtype)
        self.update_norm = GroupNorm(min(norm_groups, C), C, dtype)

    def forward(self, feats: torch.Tensor, graph: GraphBatch,
                ops_impl: str | None = None) -> torch.Tensor:
        """feats: [V, C, h, w] bottleneck maps -> fused [V, C, h, w]."""
        V, C, h, w = feats.shape
        ops = dispatch.get_ops(ops_impl or self.ops_impl, feats.device)
        heads = self.heads

        # Values in NHWC order, the layout the JAX layer flattens.
        values = self.value(feats).permute(0, 2, 3, 1)        # [V, h, w, C]
        if self.aggregation == "attention":
            pooled = feats.mean(dim=(2, 3))                    # [V, C]
            q = self.query(pooled)
            k = self.key(pooled)
        else:
            q = k = None

        if heads > 1:
            # [V, h*w, heads, C/heads] -> per-head flat feature vectors.
            vh = values.reshape(V, h * w, heads, C // heads)
            vh = vh.transpose(1, 2).reshape(V, heads, h * w * (C // heads))
            qh = q.reshape(V, heads, self.attention_dim)
            kh = k.reshape(V, heads, self.attention_dim)
            msg = torch.stack(
                [default_edge_fusion(ops, "attention", qh[:, i].contiguous(),
                                     kh[:, i].contiguous(),
                                     vh[:, i].contiguous(), graph)
                 for i in range(heads)], dim=1)
            msg = msg.reshape(V, heads, h * w, C // heads)
            msg = msg.transpose(1, 2).reshape(V, h, w, C)
        else:
            flat_values = values.reshape(V, h * w * C)
            msg = default_edge_fusion(ops, self.aggregation, q, k,
                                      flat_values, graph)
            msg = msg.reshape(V, h, w, C)
        msg = msg.permute(0, 3, 1, 2).to(feats.dtype)
        # Fuse ego features with the aggregated neighbourhood message.
        fused = self.update(torch.cat([feats, msg], dim=1))
        fused = self.update_norm(fused)
        out = feats + F.relu(fused)
        # Zero padded node slots so downstream stats never see them.
        return out * graph.node_mask[:, None, None, None].to(out.dtype)
