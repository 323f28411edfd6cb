"""Plain torch implementations of the graph message-passing ops.

Port of ``mrp_gnn_tpu/ops/reference.py``, op for op. These are the CPU path,
the ``ops_impl="xla"`` path on any device, and the oracles the CUDA kernels
are held against.

All ops are mask-aware: a padded edge or padded node never influences a
valid output. Masked logits use the large-but-finite ``_NEG`` (``-inf``
would give NaN for a destination whose in-edges are all padding), the row
max is detached (a constant shift), and a row with no valid edge gives 0.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def _segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment max; an empty segment gives -inf (as jax.ops.segment_max)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), -math.inf)
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, reduce="amax",
                              include_self=True)


def sddmm(q: torch.Tensor, k: torch.Tensor, edge_src: torch.Tensor,
          edge_dst: torch.Tensor,
          edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-edge scores e = <q[dst_e], k[src_e]>; masked edges score 0."""
    scores = (q[edge_dst.long()] * k[edge_src.long()]).sum(-1)
    if edge_mask is not None:
        scores = torch.where(edge_mask, scores, 0.0)
    return scores


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax of edge logits over each destination's in-edges; masked edges
    get weight 0 and an all-masked segment gives all-zero weights."""
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    seg_max = _segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = segment_ids.long()
    exp = torch.exp(logits - seg_max.detach()[ids])
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = _segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom > 0, denom, 1.0)
    return exp / denom[ids]


def spmm(edge_weights: torch.Tensor, values: torch.Tensor,
         edge_src: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int,
         edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """out[v] = sum_e w_e * values[src_e] over edges with dst_e = v."""
    w = edge_weights
    if edge_mask is not None:
        w = torch.where(edge_mask, w, 0.0)
    msgs = values[edge_src.long()] * w[:, None]
    return _segment_sum(msgs, edge_dst, num_nodes)


def block_fused_attention(q: torch.Tensor, k: torch.Tensor,
                          values: torch.Tensor, graph) -> torch.Tensor:
    """Fused attention for block-diagonal scene batches as batched dense
    masked attention over [S, n, .] blocks. q/k: [V, dk]; values: [V, D]."""
    n = graph.scene_stride
    S = graph.max_nodes // n
    dk = q.shape[-1]
    qb = q.reshape(S, n, dk)
    kb = k.reshape(S, n, dk)
    vb = values.reshape(S, n, -1)
    valid = graph.node_mask.reshape(S, n)

    logits = torch.einsum("sid,sjd->sij", qb, kb) / math.sqrt(dk)
    # adj[dst, src] == 1 AND source node valid; invalid/absent -> _NEG.
    bias = torch.where((graph.scene_adj[None] > 0) & valid[:, None, :],
                       0.0, _NEG)
    logits = logits + bias
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - torch.clamp(m, min=_NEG / 2).detach())
    denom = e.sum(-1, keepdim=True)
    alpha = e / torch.clamp(denom, min=1e-30)
    # zero out rows whose in-edges are all masked (denom underflow guard)
    alpha = torch.where(denom > 1e-20, alpha, 0.0)
    out = torch.einsum("sij,sjd->sid", *_promote(alpha, vb))
    return out.reshape(graph.max_nodes, -1)


def block_mean_agg(values: torch.Tensor, graph) -> torch.Tensor:
    """Mean aggregation for block-diagonal scene batches (dense path)."""
    n = graph.scene_stride
    S = graph.max_nodes // n
    vb = values.reshape(S, n, -1)
    valid = graph.node_mask.reshape(S, n)
    w = graph.scene_adj[None] * valid[:, None, :]          # [S, dst, src]
    deg = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    out = torch.einsum("sij,sjd->sid", *_promote(w / deg, vb))
    return out.reshape(graph.max_nodes, -1)


def block_max_agg(values: torch.Tensor, graph) -> torch.Tensor:
    """Masked max aggregation for block-diagonal scene batches (dense)."""
    n = graph.scene_stride
    S = graph.max_nodes // n
    vb = values.reshape(S, n, -1)
    valid = graph.node_mask.reshape(S, n)
    sel = (graph.scene_adj[None] > 0) & valid[:, None, :]   # [S, dst, src]
    cand = torch.where(sel[..., None], vb[:, None, :, :], _NEG)
    mx = cand.amax(dim=2)                                   # [S, dst, D]
    any_e = sel.any(dim=2)[..., None]
    return torch.where(any_e, mx, 0.0).reshape(graph.max_nodes, -1)


def segment_max_agg(values: torch.Tensor, edge_src: torch.Tensor,
                    edge_dst: torch.Tensor, num_nodes: int,
                    edge_mask: torch.Tensor) -> torch.Tensor:
    """out[v] = max over valid in-edges of values[src]; no in-edge -> 0."""
    msgs = torch.where(edge_mask[:, None], values[edge_src.long()], _NEG)
    mx = _segment_max(msgs, edge_dst, num_nodes)
    has = _segment_sum(edge_mask.to(torch.int32), edge_dst, num_nodes) > 0
    return torch.where(has[:, None],
                       torch.where(torch.isfinite(mx), mx, _NEG), 0.0)


def segment_mean_agg(values: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, num_nodes: int,
                     edge_mask: torch.Tensor) -> torch.Tensor:
    """out[v] = mean over valid in-edges of values[src]; no in-edge -> 0."""
    w = edge_mask.to(values.dtype)
    summed = spmm(torch.ones_like(w), values, edge_src, edge_dst, num_nodes,
                  edge_mask)
    deg = _segment_sum(w, edge_dst, num_nodes)
    return summed / torch.clamp(deg, min=1.0)[:, None]


# --- ELL (padded neighbour-list) ops ----------------------------------------


def ell_sddmm(q: torch.Tensor, k: torch.Tensor, ell_src: torch.Tensor,
              ell_mask: torch.Tensor) -> torch.Tensor:
    """logits[v, j] = <q[v], k[ell_src[v, j]]>; masked slots -> 0."""
    gathered = k[ell_src.long()]                  # [V, max_deg, dk]
    logits = torch.einsum("vd,vjd->vj", q, gathered)
    return torch.where(ell_mask, logits, 0.0)


def ell_softmax(logits: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax along the neighbour axis; all-masked rows -> zeros."""
    x = torch.where(ell_mask, logits, _NEG)
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x - torch.clamp(m, min=_NEG / 2).detach())
    e = torch.where(ell_mask, e, 0.0)
    denom = e.sum(-1, keepdim=True)
    return torch.where(denom > 0, e / torch.clamp(denom, min=1e-30), 0.0)


def ell_aggregate(weights: torch.Tensor | None, values: torch.Tensor,
                  ell_src: torch.Tensor, ell_mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """out[v] = reduce_j weights[v, j] * values[ell_src[v, j]].

    mode: "sum" (weighted, e.g. attention), "mean", or "max" (weights
    ignored for mean and max).
    """
    gathered = values[ell_src.long()]             # [V, max_deg, D]
    maskf = ell_mask.to(values.dtype)[..., None]
    if mode == "sum":
        return torch.einsum("vj,vjd->vd", *_promote(weights * ell_mask,
                                                    gathered))
    if mode == "mean":
        deg = torch.clamp(maskf.sum(1), min=1.0)
        return (gathered * maskf).sum(1) / deg
    if mode == "max":
        mx = torch.where(maskf > 0, gathered, _NEG).amax(1)
        return torch.where(maskf.sum(1) > 0, mx, 0.0)
    raise ValueError(f"unknown mode {mode!r}")
