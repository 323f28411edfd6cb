"""Robot-graph message-passing fusion layer (port of
``mrp_gnn_tpu/models/fusion.py``), and :class:`AttFuse`, the per-pixel
cross-robot attention of ``fusion="attfuse"``, which the JAX package does
not have.

SDDMM -> segment softmax -> SpMM over the batch graph, then a 1x1-conv fuse
of ego features with the aggregated message. The edge ops come from
``ops.dispatch`` by ``ops_impl``; an ``edge_fusion_fn`` replaces the whole
edge block, as in the JAX layer. Feature maps are NCHW here; the values are
flattened in NHWC order before the edge block, as the JAX layer flattens
them, so ``values`` [V, D] means the same thing in both packages.
"""

from __future__ import annotations

import math
from typing import Callable

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
    edge_fusion_fn: optional replacement of :func:`default_edge_fusion`
    with its signature ``(ops, aggregation, q, k, flat_values, graph) ->
    msg [V, D]``, called once per head.
    """

    def __init__(self, channels: int, aggregation: str = "attention",
                 attention_dim: int = 64, attention_heads: int = 1,
                 norm_groups: int = 8, dtype: torch.dtype = torch.float32,
                 ops_impl: str = "xla",
                 edge_fusion_fn: Callable | None = None):
        super().__init__()
        C = channels
        self.aggregation = aggregation
        self.attention_dim = attention_dim
        self.heads = attention_heads if aggregation == "attention" else 1
        if self.heads > 1 and C % self.heads:
            raise ValueError(f"channels {C} not divisible by "
                             f"attention_heads={self.heads}")
        self.ops_impl = ops_impl
        self.edge_fusion_fn = edge_fusion_fn
        self.value = Conv(C, C, 1, dtype=dtype)
        if aggregation == "attention":
            self.query = Dense(C, self.heads * attention_dim, dtype)
            self.key = Dense(C, self.heads * attention_dim, dtype)
        self.update = Conv(2 * C, C, 1, bias=False, dtype=dtype)
        self.update_norm = GroupNorm(min(norm_groups, C), C, dtype)

    def forward(self, feats: torch.Tensor, graph: GraphBatch,
                ops_impl: str | None = None, shard=None) -> torch.Tensor:
        """feats: [V, C, h, w] bottleneck maps -> fused [V, C, h, w].

        ``shard`` (see ``models/encoder.py``): under tensor parallelism the
        edge block runs on this rank's channels of the values, with q and k
        whole, and the message is gathered; under spatial sharding, on this
        rank's rows, with the pooled features summed over its group."""
        V, C, h, w = feats.shape
        ops = dispatch.get_ops(ops_impl or self.ops_impl, feats.device)
        edge_fn = self.edge_fusion_fn or default_edge_fusion
        heads = self.heads

        # Values in NHWC order, the layout the JAX layer flattens.
        values = self.value(feats, shard).permute(0, 2, 3, 1)  # [V, h, w, Cl]
        if self.aggregation == "attention":
            pooled = (feats.mean(dim=(2, 3)) if shard is None
                      else shard.mean_hw(feats))              # [V, C]
            q = self.query(pooled, shard)
            k = self.key(pooled, shard)
            if shard is not None:
                q, k = shard.attention_keys(self, q, k)
            if heads > 1:
                q = q.reshape(V, heads, self.attention_dim)
                k = k.reshape(V, heads, self.attention_dim)
        else:
            q = k = None

        # Each head scores and aggregates its own channel group; the values
        # hold global channels [c0, c0 + Cl) (a tensor-parallel shard).
        c0 = 0 if shard is None else shard.channel_offset(self.value)
        Cl, Ch = values.shape[-1], C // heads
        msgs = []
        for i in range(heads):
            lo, hi = max(c0, i * Ch), min(c0 + Cl, (i + 1) * Ch)
            if lo >= hi:
                continue
            flat = values[..., lo - c0:hi - c0].reshape(V, -1)
            qi, ki = ((q, k) if heads == 1
                      else (q[:, i].contiguous(), k[:, i].contiguous()))
            msgs.append(edge_fn(ops, self.aggregation, qi, ki, flat, graph)
                        .reshape(V, h, w, hi - lo))
        msg = msgs[0] if len(msgs) == 1 else torch.cat(msgs, dim=-1)
        msg = msg.permute(0, 3, 1, 2).to(feats.dtype)
        if shard is not None:
            msg = shard.whole(msg, self.value)
        # Fuse ego features with the aggregated neighbourhood message.
        fused = self.update(torch.cat([feats, msg], dim=1), shard)
        fused = self.update_norm(fused, shard)
        out = feats + F.relu(fused)
        # Zero padded node slots so downstream stats never see them.
        return out * graph.node_mask[:, None, None, None].to(out.dtype)


class AttFuse(nn.Module):
    """OPV2V's attentive intermediate fusion (``AttFusion`` of OpenCOOD,
    Xu et al., ICRA 2022): per pixel, each robot's C-wide feature attends
    over itself and its graph neighbours with q = k = v = its features and
    a 1/sqrt(C) scale; no parameters. Padded slots give 0; a robot with no
    neighbour gets its own map back. The edge block is the ops' ``attfuse``
    (``ops/attfuse.py``: kernels on CUDA ELL batches). Single-device only:
    a shard context or a batch that carries a partition plan is refused."""

    def __init__(self, ops_impl: str = "xla"):
        super().__init__()
        self.ops_impl = ops_impl

    def forward(self, feats: torch.Tensor, graph: GraphBatch,
                ops_impl: str | None = None, shard=None) -> torch.Tensor:
        """feats: [V, C, h, w] one encoder stage's maps -> fused, same
        shape."""
        if shard is not None or graph.partition_plan is not None:
            raise ValueError("AttFuse runs on one device: no model-axis "
                             "shard and no partition plan")
        ops = dispatch.get_ops(ops_impl or self.ops_impl, feats.device)
        return ops.attfuse(feats, graph)
