"""Partitioned graph fusion: the edge block over an edge-partitioned graph,
with its halo exchange (port of ``mrp_gnn_tpu/parallel/fused.py``).

:func:`make_partitioned_edge_fusion` returns a drop-in replacement for
``models.fusion.default_edge_fusion`` (same signature) that one rank runs on
its own node block, the body of the JAX package's ``shard_fn`` on its
``[p]`` block of the plan:

- q, k and values hold this rank's ``nodes_per_shard`` rows; the rank owns
  the edges whose destination it holds, so the softmax over a node's
  in-edges and the sum of its messages stay local;
- boundary edges read their source rows from the **halo exchange**: for
  each active delta d, send ``x[send_idx[off_d : off_d + B_d]]`` to rank
  (s + d) % P of the graph group and receive from (s - d) % P, one
  ``torch.distributed.batch_isend_irecv``. The receive buffer is the
  concatenation over ``plan.deltas`` (a 1-row zero buffer with no delta).
  Its gradient goes back along the inverse ring and is summed into x's
  gradient at ``send_idx``: the transpose of JAX's ppermute and send
  gather (:class:`_Received`);
- with ``overlap=True`` the value exchange is posted before the local
  aggregate and waited for after it (the host transport runs while the
  card aggregates); with ``overlap=False`` it is posted after it: the A/B
  of ``ParallelConfig.overlap_boundary_exchange``;
- attention is one softmax split over the local and the remote slots (one
  detached row max, one denominator; ``_NEG`` guards, so an empty row gives
  0), mean one degree over both, max the larger of the local and the
  remote max (the local max the plain op, as JAX runs it);
- the local aggregate runs the kernels when ``ops`` is the kernel backend
  (``ops.impl == "pallas"``; on CPU tensors the kernels' plain versions):
  up to ELL width 128 ``bsp.WeightedAggregate`` (forward ``bsp.spmm``,
  backward ``bsp.sddmm`` and ``bsp.spmm_t``); past it, on a plan with
  row-expanded arrays, the local logits are ``bsp.sddmm`` over
  ``bsp.expand_ell_view`` (``bsp.EdgeDot``, the JAX ``xp_sddmm``) and the
  aggregate ``bsp.xp_weighted_aggregate``; otherwise the plain ops. The
  remote aggregate is a plain einsum over the received rows, as in JAX;
- ``exchange="all_gather"``: every rank gathers the whole replica's rows
  (:class:`_AllGather`), the A/B control;
- the post and the wait of each exchange are profiler ranges,
  ``halo.post:<what>`` and ``halo.wait:<what>`` ("keys" or "values"), from
  which ``benchmark.bench_overlap`` reads the window in which the value
  exchange is in flight.

Under the gloo backend a CUDA tensor's rows are copied to pinned host
memory, the copy is waited for, and then gloo sends them; received rows go
back to the card on the rank's stream. NCCL keeps them on the card.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from mrp_gnn_tpu_torch.ops import bsp
from mrp_gnn_tpu_torch.ops import reference as R
from mrp_gnn_tpu_torch.ops.reference import _NEG
from mrp_gnn_tpu_torch.parallel.mesh import Mesh
from mrp_gnn_tpu_torch.parallel.partition import EdgePartitionPlan, ShardPlan

EXCHANGES = ("boundary", "all_gather")


class _Halo:
    """The per-delta rings of one rank over its graph group."""

    def __init__(self, mesh: Mesh, deltas: tuple, delta_rows: tuple):
        P, s = mesh.graph, mesh.graph_index
        self.group = mesh.graph_group
        self.gloo = mesh.backend == "gloo"
        offs = [0]
        for bd in delta_rows:
            offs.append(offs[-1] + bd)
        # (offset, rows, forward peer (s + d), backward peer (s - d))
        self.rings = [(offs[i], bd, mesh.graph_ranks[(s + d) % P],
                       mesh.graph_ranks[(s - d) % P])
                      for i, (d, bd) in enumerate(zip(deltas, delta_rows))]

    def _swap(self, rows: torch.Tensor, forward: bool) -> "_Pending":
        """Post the exchange of ``rows`` [sum B_d, D]: block d goes to the
        forward peer and the block of the backward peer comes in (the
        reverse with ``forward`` False)."""
        dev = rows.device
        staged = self.gloo and rows.is_cuda
        if staged:
            send = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            send.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # gloo reads host memory the card has written
            recv = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        else:
            send, recv = rows.contiguous(), torch.empty_like(rows)
        ops = []
        for tag, (off, bd, fwd, bwd) in enumerate(self.rings):
            to, frm = (fwd, bwd) if forward else (bwd, fwd)
            ops.append(dist.P2POp(dist.isend, send[off:off + bd], to,
                                  self.group, tag))
            ops.append(dist.P2POp(dist.irecv, recv[off:off + bd], frm,
                                  self.group, tag))
        return _Pending(dist.batch_isend_irecv(ops), recv, send, dev)

    def post(self, x: torch.Tensor, send_idx: torch.Tensor) -> "_Pending":
        """Post the exchange of x's requested rows; nothing is differentiated
        here (:meth:`receive` is)."""
        if not self.rings:
            return _Pending([], torch.zeros(1, x.shape[1], dtype=x.dtype,
                                            device=x.device), None, x.device)
        return self._swap(x.detach()[send_idx], forward=True)

    def receive(self, x: torch.Tensor, send_idx: torch.Tensor,
                pending: "_Pending") -> torch.Tensor:
        """The receive buffer of ``pending``, with x's gradient through it."""
        return _Received.apply(x, send_idx, pending, self)

    def transpose(self, g: torch.Tensor, send_idx: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
        """x's gradient from the receive buffer's gradient ``g``: g's blocks
        go back to their senders, and what comes back is summed at
        ``send_idx`` (``index_put_`` with accumulation: its CUDA form sorts
        the indices, so the sum is in a fixed order)."""
        dx = torch.zeros_like(x)
        if self.rings:
            back = self._swap(g.contiguous(), forward=False).wait()
            dx.index_put_((send_idx,), back, accumulate=True)
        return dx


class _Pending:
    """Requests in flight; :meth:`wait` gives the receive buffer on the
    device (a host buffer goes back on the current stream). The send
    buffer is held until the requests complete."""

    def __init__(self, reqs, recv, send, device):
        self.reqs, self.recv, self.send, self.device = reqs, recv, send, device

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        self.send = None
        return self.recv.to(self.device, non_blocking=True)


class _Received(torch.autograd.Function):
    """Forward: wait for a posted exchange. Backward: its transpose."""

    @staticmethod
    def forward(ctx, x, send_idx, pending, halo):
        ctx.halo = halo
        ctx.save_for_backward(x, send_idx)
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        x, send_idx = ctx.saved_tensors
        return ctx.halo.transpose(g, send_idx, x), None, None, None


class _AllGather(torch.autograd.Function):
    """The whole replica's rows [P * nps, D] on every rank of the graph
    group; the backward sums the ranks' gradients of this rank's rows, in
    rank order (one all-to-all). ``torch.distributed.nn.functional
    .all_gather`` is not used: under gloo its backward scatters from a
    group rank taken as a global one, and fails on a graph group that does
    not hold rank 0."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(mesh.all_gather(x, group=mesh.graph_group))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        src = mesh._staged(g)
        parts = torch.empty_like(src)
        dist.all_to_all_single(parts, src, group=mesh.graph_group)
        P = mesh.graph
        return parts.to(g.device).reshape(P, -1, *g.shape[1:]).sum(0), None


def _expanded_sddmm(a, b, ell_src, ell_mask, rows: int,
                    width: int) -> torch.Tensor:
    """out[v, j] = <a[v], b[ell_src[v, j]]> over the row-expanded view of a
    wide ELL layout, folded back to [V, deg] (the JAX ``xp_sddmm``): the
    SDDMM kernel on CUDA tensors, differentiable (``bsp.EdgeDot``)."""
    V, deg = ell_src.shape
    src_x, mask_x = bsp.expand_ell_view(ell_src, ell_mask, rows, width)
    out = bsp.EdgeDot.apply(a.repeat_interleave(rows, dim=0), b.contiguous(),
                            src_x, mask_x)
    return out.reshape(V, rows * width)[:, :deg]


def make_partitioned_edge_fusion(mesh: Mesh, plan: EdgePartitionPlan,
                                 exchange: str = "boundary",
                                 overlap: bool = True,
                                 dynamic: bool = False) -> Callable:
    """An ``edge_fusion_fn`` for this rank of ``mesh`` over ``plan``.

    exchange: "boundary" (the per-delta halo rings) or "all_gather".
    overlap: post the value exchange before the local aggregate (True) or
      after it (False).
    dynamic: per-batch topology. ``plan`` is then the capacity plan that
      fixes shapes and rings; each call reads the batch's plan from
      ``graph.partition_plan``: an :class:`EdgePartitionPlan` stacked over
      replicas (this rank takes row ``data_index * P + graph_index``) or
      this rank's :class:`ShardPlan` (``ParallelContext.attach_plan``).
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if plan.num_shards != mesh.graph:
        raise ValueError(f"plan of {plan.num_shards} shards on a graph axis "
                         f"of {mesh.graph}")
    nps = plan.nodes_per_shard
    deltas, delta_rows = plan.deltas, plan.delta_rows
    width = int(plan.ell_mask.shape[-1])
    halo = _Halo(mesh, deltas, delta_rows)
    row = mesh.data_index * mesh.graph + mesh.graph_index
    static_blocks = {}  # device -> this rank's ShardPlan of a static plan

    def live_block(graph, device) -> ShardPlan:
        if not dynamic:
            if device not in static_blocks:
                static_blocks[device] = plan.shard(mesh.graph_index, device)
            return static_blocks[device]
        live = graph.partition_plan
        if live is None:
            raise ValueError("dynamic partitioned fusion needs the per-batch "
                             "plan on graph.partition_plan "
                             "(ParallelContext.attach_plan)")
        if isinstance(live, EdgePartitionPlan):
            live = live.shard(row)
        if (live.deltas != deltas or live.delta_rows != delta_rows
                or live.nodes_per_shard != nps):
            raise ValueError("per-batch plan structure differs from the "
                             "capacity plan: build it with the same "
                             "PlanCapacities")
        # A live plan without expanded arrays is legal (no xp_pairs opt-in:
        # the local aggregate takes the plain path); a present but
        # mismatched expanded structure is a build error.
        if (live.expanded
                and (live.xp_rows, live.xp_width) != (plan.xp_rows,
                                                      plan.xp_width)):
            raise ValueError("per-batch expanded-plan structure differs from "
                             "the capacity plan: build it with the same "
                             "PlanCapacities (xp_pairs)")
        return live.to(device)

    def edge_fn(ops, aggregation: str, q, k, flat_values, graph):
        v_loc = flat_values
        if v_loc.shape[0] != nps:
            raise ValueError(f"partitioned fusion takes this rank's {nps} "
                             f"node rows, got {v_loc.shape[0]}")
        sp = live_block(graph, v_loc.device)
        sidx = sp.send_idx.long()
        re_slot, re_srcg = sp.remote_ell_slot.long(), sp.remote_ell_srcg.long()
        re_m = sp.remote_ell_mask
        ell_s, ell_m = sp.ell_src, sp.ell_mask

        kernels = getattr(ops, "impl", "xla") == "pallas" and plan.bsp_tile > 0
        if kernels and sp.square and width <= bsp.MAX_DEGREE:
            mode = "square"
        elif kernels and sp.expanded:
            mode = "xp"
        else:
            mode = "ell"

        def r_gather(x_remote, x_all):
            """Boundary-edge source rows in ELL form [nps, Lr, D]."""
            return x_remote[re_slot] if x_all is None else x_all[re_srcg]

        def exchanged(x, what, before=None):
            """(result of ``before()``, x's remote rows): the exchange is
            posted before ``before`` runs with overlap, after it without."""
            if exchange == "all_gather":
                x_all = _AllGather.apply(x, mesh)
                return (before() if before else None), r_gather(None, x_all)

            def post():
                with record_function(f"halo.post:{what}"):
                    return halo.post(x, sidx)

            if overlap or before is None:
                pending = post()
                done = before() if before else None
            else:
                done = before()
                pending = post()
            with record_function(f"halo.wait:{what}"):
                received = halo.receive(x, sidx, pending)
            return done, r_gather(received, None)

        if aggregation == "max":
            def local_max():
                m_l = R.ell_aggregate(None, v_loc, ell_s, ell_m, "max")
                return torch.where(ell_m.any(-1)[:, None], m_l, _NEG)

            cand_l, v_edge = exchanged(v_loc, "values", local_max)
            cand = torch.where(re_m[..., None], v_edge, _NEG)
            m_r = cand.amax(dim=1)                               # [nps, D]
            out = torch.maximum(cand_l.float(), m_r.float())
            has = ell_m.any(-1) | re_m.any(-1)
            return torch.where(has[:, None], out, 0.0).to(v_loc.dtype)

        if aggregation == "attention":
            inv_sqrt = 1.0 / math.sqrt(q.shape[-1])
            if mode == "xp":
                lg_l = _expanded_sddmm(q, k, ell_s, ell_m, sp.xp_rows,
                                       sp.xp_width) * inv_sqrt
            else:
                lg_l = R.ell_sddmm(q, k, ell_s, ell_m) * inv_sqrt
            lg_l = torch.where(ell_m, lg_l, _NEG)                # [nps, L]
            _, k_edge = exchanged(k, "keys")                    # [nps, Lr, dk]
            lg_r = torch.einsum("vd,vjd->vj", q, k_edge) * inv_sqrt
            lg_r = torch.where(re_m, lg_r, _NEG)                 # [nps, Lr]
            mx = torch.clamp(torch.maximum(lg_l.amax(-1), lg_r.amax(-1)),
                             min=_NEG / 2).detach()[:, None]
            e_l = torch.where(ell_m, torch.exp(lg_l - mx), 0.0)
            e_r = torch.where(re_m, torch.exp(lg_r - mx), 0.0)
            denom = e_l.sum(-1) + e_r.sum(-1)
            denom = torch.where(denom > 0, denom, 1.0)
            alpha_l = e_l / denom[:, None]
            alpha_r = e_r / denom[:, None]
        elif aggregation == "mean":
            deg = (ell_m.sum(-1) + re_m.sum(-1)).to(v_loc.dtype)
            inv = 1.0 / torch.clamp(deg, min=1.0)
            alpha_l = inv[:, None] * ell_m
            alpha_r = inv[:, None] * re_m
        else:
            raise ValueError(f"unknown aggregation {aggregation!r}")

        def agg_local():
            w = (alpha_l.float() * ell_m).contiguous()
            if mode == "square":
                return bsp.WeightedAggregate.apply(w, v_loc.contiguous(),
                                                   ell_s, ell_m)
            if mode == "xp":
                return bsp.xp_weighted_aggregate(w, v_loc, ell_s, ell_m,
                                                 sp.xp_rows, sp.xp_width)
            return R.ell_aggregate(w, v_loc, ell_s, ell_m, "sum")

        local, v_edge = exchanged(v_loc, "values", agg_local)    # [nps, Lr, D]
        remote = torch.einsum("vj,vjd->vd", (alpha_r * re_m).float(),
                              v_edge.float()).to(v_loc.dtype)
        return local + remote

    return edge_fn
