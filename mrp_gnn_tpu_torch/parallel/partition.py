"""Edge partitioning of batched robot graphs over the mesh's "graph" axis
(port of ``mrp_gnn_tpu/parallel/partition.py``).

Destination-owner partitioning, as in the JAX package:

- nodes are block-sharded: shard p owns node slots [p * nps, (p + 1) * nps);
- every edge lives on the shard that owns its destination, so a node's
  softmax over its in-edges and the sum of its messages stay on its shard;
- an edge whose source is on another shard is a *boundary* edge: its
  source row arrives through the halo exchange (``parallel/fused.py``),
  while local-source edges aggregate straight from the resident rows.

The exchange is one ring per active shard offset d: shard s sends to
(s + d) % P exactly the rows that shard's boundary edges reference
(``send_idx``), so a shard receives sum_d B_d rows a step, in proportion
to the real boundary set.

Plans are numpy on the host, every array bit-identical to the JAX
package's (``tests/test_torch_partition.py``): the same dtypes, padding,
delta order and ``send_idx``, the tile-pair and row-expanded pair arrays
included. The CUDA kernels gather from ``ell_src`` and never read the pair
arrays; they are kept so that whole plans compare and so that a plan marks
the shards the kernels serve, as in the JAX package. Each rank moves its
own ``[p]`` block to its device with :meth:`EdgePartitionPlan.shard`.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

_PAIR_KEYS = ("bsp_pair_dst", "bsp_pair_src", "bsp_pair_first",
              "bsp_pair_last", "bsp_pair_dst_t", "bsp_pair_src_t",
              "bsp_pair_first_t", "bsp_pair_last_t")
_XP_KEYS = ("xp_pair_dst", "xp_pair_src", "xp_pair_first", "xp_pair_last",
            "xp_pair_dst_t", "xp_pair_src_t", "xp_pair_first_t",
            "xp_pair_last_t")
_META_KEYS = ("deltas", "delta_rows", "bsp_tile", "xp_rows", "xp_width")
# The arrays one rank's partitioned fusion reads (ShardPlan).
_SHARD_KEYS = ("send_idx", "remote_ell_slot", "remote_ell_srcg",
               "remote_ell_mask", "ell_src", "ell_mask")


@dataclasses.dataclass(frozen=True)
class EdgePartitionPlan:
    """Per-shard padded edge lists, stacked on a leading shard axis: [P,
    ...] for one replica's graph, [R * P, ...] for a dynamic batch stacked
    over R data replicas (:func:`partition_batch`). Field for field the
    JAX package's plan, as numpy arrays:

    - ``src_global`` / ``dst_local`` / ``mask`` / ``local_mask`` [P, E_s]:
      each shard's edges (global source, shard-local destination), valid,
      and valid with a resident source;
    - ``ell_src`` / ``ell_mask`` [P, nps, L]: the local edges as a
      shard-local ELL layout;
    - ``bsp_*``: each shard's tile-pair plan and its source-major re-sort,
      stacked with inert tail pairs; None when no tile divides nps;
    - ``xp_*``: each shard's row-expanded plan when L passes 128 (static
      plans always; capacity-pinned plans with ``PlanCapacities.xp_pairs``);
    - ``deltas`` / ``delta_rows``: the active shard offsets d (shard s sends
      to (s + d) % P) and B_d, the padded rows each ships along d; the
      receive buffer is the concatenation over ``deltas``, sum(B_d) rows;
    - ``send_idx`` [P, max(sum B_d, 1)]: sender-local rows shipped along
      each delta, 0-padded;
    - ``remote_*`` [P, E_r]: the boundary edges (local destination, global
      source, slot in the receive buffer, valid);
    - ``remote_ell_slot`` / ``remote_ell_srcg`` / ``remote_ell_mask`` [P,
      nps, Lr]: the boundary edges as an ELL layout over the receive buffer
      (and over the global node axis, for the all_gather mode).
    """

    src_global: np.ndarray
    dst_local: np.ndarray
    mask: np.ndarray
    local_mask: np.ndarray
    send_idx: np.ndarray
    remote_dst: np.ndarray
    remote_src_global: np.ndarray
    remote_slot: np.ndarray
    remote_mask: np.ndarray
    remote_ell_slot: np.ndarray
    remote_ell_srcg: np.ndarray
    remote_ell_mask: np.ndarray
    ell_src: np.ndarray
    ell_mask: np.ndarray
    bsp_pair_dst: np.ndarray | None
    bsp_pair_src: np.ndarray | None
    bsp_pair_first: np.ndarray | None
    bsp_pair_last: np.ndarray | None
    bsp_pair_dst_t: np.ndarray | None
    bsp_pair_src_t: np.ndarray | None
    bsp_pair_first_t: np.ndarray | None
    bsp_pair_last_t: np.ndarray | None
    xp_pair_dst: np.ndarray | None
    xp_pair_src: np.ndarray | None
    xp_pair_first: np.ndarray | None
    xp_pair_last: np.ndarray | None
    xp_pair_dst_t: np.ndarray | None
    xp_pair_src_t: np.ndarray | None
    xp_pair_first_t: np.ndarray | None
    xp_pair_last_t: np.ndarray | None
    num_shards: int
    nodes_per_shard: int
    deltas: tuple
    delta_rows: tuple
    bsp_tile: int
    xp_rows: int
    xp_width: int

    @property
    def edges_per_shard(self) -> int:
        return self.mask.shape[1]

    @property
    def recv_rows(self) -> int:
        """Rows each shard receives a step (the boundary volume)."""
        return int(sum(self.delta_rows))

    def shard(self, index: int, device=None) -> "ShardPlan":
        """Row ``index`` of the stacked arrays (shard p of a [P, ...] plan,
        or (replica r, shard p) at r * P + p of a stacked dynamic plan) as
        the tensors one rank's fusion reads, on ``device``."""
        arrs = {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)[index]))
                for k in _SHARD_KEYS}
        sp = ShardPlan(**arrs, nodes_per_shard=self.nodes_per_shard,
                       deltas=self.deltas, delta_rows=self.delta_rows,
                       bsp_tile=self.bsp_tile,
                       square=self.bsp_pair_dst is not None,
                       expanded=self.xp_pair_dst is not None,
                       xp_rows=self.xp_rows, xp_width=self.xp_width)
        return sp if device is None else sp.to(device)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One rank's block of an :class:`EdgePartitionPlan`: the arrays its
    partitioned fusion reads, as tensors, and the plan's structure.
    ``square`` / ``expanded``: the plan carries a tile-pair plan / a
    row-expanded plan (the shards the kernels serve, as the JAX package
    marks them)."""

    send_idx: torch.Tensor
    remote_ell_slot: torch.Tensor
    remote_ell_srcg: torch.Tensor
    remote_ell_mask: torch.Tensor
    ell_src: torch.Tensor
    ell_mask: torch.Tensor
    nodes_per_shard: int
    deltas: tuple
    delta_rows: tuple
    bsp_tile: int
    square: bool
    expanded: bool
    xp_rows: int
    xp_width: int

    def to(self, device) -> "ShardPlan":
        return self.apply(lambda t: t.to(device))

    def apply(self, fn) -> "ShardPlan":
        """Copy of the plan with ``fn`` applied to every tensor field."""
        return dataclasses.replace(
            self, **{k: fn(getattr(self, k)) for k in _SHARD_KEYS})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PlanCapacities:
    """Static sizes pinning a plan's array shapes, so that the per-batch
    plans of a dynamic stream share shapes and ring structure. Derived from
    a superset topology (the full-connectivity graph of the same layout).
    ``xp_pairs``: the explicit opt-in length of the per-shard row-expanded
    plans past width 128 (0: no expanded plans; the local aggregate then
    takes the plain ELL path, with a warning). The expanded length is not
    subset-monotone, so only the caller can bound it."""
    edges_per_shard: int
    ell_width: int
    deltas: tuple
    delta_rows: tuple
    remote_edges: int
    bsp_pairs: int
    remote_ell_width: int = 0
    xp_pairs: int = 0


def capacities_of(plan: EdgePartitionPlan) -> PlanCapacities:
    """Capacities pinned by a superset plan (``xp_pairs`` left 0: see
    :class:`PlanCapacities`)."""
    return PlanCapacities(
        edges_per_shard=plan.edges_per_shard,
        ell_width=int(plan.ell_mask.shape[-1]),
        deltas=plan.deltas,
        delta_rows=plan.delta_rows,
        remote_edges=int(plan.remote_mask.shape[-1]),
        bsp_pairs=(int(plan.bsp_pair_dst.shape[-1])
                   if plan.bsp_pair_dst is not None else 0),
        remote_ell_width=int(plan.remote_ell_mask.shape[-1]),
    )


def _remote_ell_arrays(arrs: dict, nps: int,
                       capacities: PlanCapacities | None,
                       pad_multiple: int = 8) -> None:
    """The boundary edges' ELL view, from the compact remote arrays (for the
    numpy and the native builder alike). Boundary edges arrive dst-sorted
    per shard, so an edge's slot is its rank within its destination's run."""
    r_dst = arrs["remote_dst"]
    r_mask = np.asarray(arrs["remote_mask"])
    P = r_dst.shape[0]
    max_deg = 1
    rows_per = []
    for p in range(P):
        rows = np.asarray(r_dst[p])[r_mask[p]]
        rows_per.append(rows)
        if rows.size:
            max_deg = max(max_deg, int(np.bincount(rows).max()))
    Lr = max(_round_up(max_deg, pad_multiple), pad_multiple)
    if capacities is not None and capacities.remote_ell_width:
        if Lr > capacities.remote_ell_width:
            raise ValueError(f"remote in-degree {max_deg} exceeds remote "
                             f"ELL capacity {capacities.remote_ell_width}")
        Lr = capacities.remote_ell_width
    slot_ell = np.zeros((P, nps, Lr), np.int32)
    srcg_ell = np.zeros((P, nps, Lr), np.int32)
    mask_ell = np.zeros((P, nps, Lr), bool)
    for p in range(P):
        rows = rows_per[p]
        if rows.size == 0:
            continue
        starts = np.searchsorted(rows, np.arange(nps))
        rank = np.arange(rows.size) - starts[rows]
        slot_ell[p, rows, rank] = np.asarray(arrs["remote_slot"][p])[r_mask[p]]
        srcg_ell[p, rows, rank] = np.asarray(
            arrs["remote_src_global"][p])[r_mask[p]]
        mask_ell[p, rows, rank] = True
    arrs["remote_ell_slot"] = slot_ell
    arrs["remote_ell_srcg"] = srcg_ell
    arrs["remote_ell_mask"] = mask_ell


def _warn_partitioned_hideg_fallback(width: int) -> None:
    """Warn (once per process, by the default warnings filter) that a
    capacity-pinned plan crossed the 128-column cap without the
    ``xp_pairs`` opt-in, so the local aggregate takes the plain ELL path."""
    warnings.warn(
        f"per-shard local in-degree width {width} exceeds the 128-column "
        "kernel cap but carries no row-expanded plan: capacity-pinned "
        "(dynamic) streams build one only with an explicit opt-in, so the "
        "local aggregate takes the plain ELL gather path. Set "
        "PlanCapacities.xp_pairs=<bound for your topology family> "
        "(ParallelConfig.expanded_plan_pairs from the config path) to keep "
        "it on the kernels", UserWarning, stacklevel=3)


def _expanded_plan_arrays(arrs: dict,
                          capacities: PlanCapacities | None) -> None:
    """Per-shard row-expanded plans when the local ELL width passes 128 (for
    the numpy and the native builder alike). Static plans always build
    them; capacity-pinned ones need ``capacities.xp_pairs`` and warn
    without it."""
    from mrp_gnn_tpu_torch.graph import build_expanded_bsp
    arrs.update({k: None for k in _XP_KEYS})
    arrs["xp_rows"] = 0
    arrs["xp_width"] = 0
    tile = arrs["bsp_tile"]
    L = int(arrs["ell_mask"].shape[-1])
    if not tile or L <= 128:
        return
    if capacities is not None and not capacities.xp_pairs:
        _warn_partitioned_hideg_fallback(L)
        return
    ell_src = np.asarray(arrs["ell_src"])
    ell_mask = np.asarray(arrs["ell_mask"])
    P = ell_src.shape[0]

    def build(max_pairs):
        return [build_expanded_bsp(ell_src[p], ell_mask[p], tile,
                                   max_pairs=max_pairs) for p in range(P)]

    fields = ("pair_dst", "pair_src", "pair_first", "pair_last",
              "pair_dst_t", "pair_src_t", "pair_first_t", "pair_last_t")
    if capacities is not None:
        per = build(int(capacities.xp_pairs))  # violations raise inside
        stacked = {f: np.stack([getattr(x, f).numpy() for x in per])
                   for f in fields}
    else:
        # One build pass; shards are equalised to the longest by inert tail
        # pairs, bit-identical to a pinned rebuild (dst-major tails repeat
        # the last dst and src tiles, source-major tails the last src tile).
        per = build(None)
        pmax = max(int(x.pair_dst.shape[0]) for x in per)
        nps = int(ell_src.shape[1])
        nt_src = nps // tile
        nt_dst = (nps * per[0].rows) // tile
        fills = {"pair_dst": nt_dst - 1, "pair_src": nt_src - 1,
                 "pair_first": 0, "pair_last": 0,
                 "pair_dst_t": nt_src - 1, "pair_src_t": nt_src - 1,
                 "pair_first_t": 0, "pair_last_t": 0}
        lens = {f: (pmax + nt_src if f.endswith("_t") else pmax)
                for f in fields}

        def pad(a, f):
            a = a.numpy()
            tail = np.full(lens[f] - a.shape[0], fills[f], np.int32)
            return np.concatenate([a, tail])

        stacked = {f: np.stack([pad(getattr(x, f), f) for x in per])
                   for f in fields}
    for k, f in zip(_XP_KEYS, fields):
        arrs[k] = stacked[f]
    arrs["xp_rows"] = per[0].rows
    arrs["xp_width"] = per[0].width


def partition_graph(graph, num_shards: int, pad_multiple: int = 8,
                    capacities: PlanCapacities | None = None
                    ) -> EdgePartitionPlan:
    """The partition plan of a GraphBatch over ``num_shards`` shards.

    ``graph.max_nodes`` must divide by ``num_shards``. ``capacities`` pins
    every padded size (raises when the graph exceeds one).
    """
    V = graph.max_nodes
    if V % num_shards:
        raise ValueError(f"max_nodes={V} not divisible by num_shards={num_shards}")
    nps = V // num_shards
    src = np.asarray(graph.edge_src)
    dst = np.asarray(graph.edge_dst)
    mask = np.asarray(graph.edge_mask)
    arrs = _plan_arrays(src[mask], dst[mask], nps, num_shards, pad_multiple,
                        capacities)
    return _wrap_plan(arrs, num_shards, nps)


def _wrap_plan(arrs: dict, num_shards: int, nps: int) -> EdgePartitionPlan:
    meta = {k: arrs.pop(k) for k in _META_KEYS}
    return EdgePartitionPlan(**arrs, num_shards=num_shards,
                             nodes_per_shard=nps, **meta)


def _plan_arrays(src: np.ndarray, dst: np.ndarray, nps: int, num_shards: int,
                 pad_multiple: int = 8,
                 capacities: PlanCapacities | None = None) -> dict:
    """numpy plan arrays for one replica's (masked, dst-sorted) edge list."""
    owner = dst // nps
    counts = np.bincount(owner, minlength=num_shards)
    E_s = max(_round_up(int(counts.max()) if counts.size else 1, pad_multiple),
              pad_multiple)
    if capacities is not None:
        if E_s > capacities.edges_per_shard:
            raise ValueError(f"shard edge count {int(counts.max())} exceeds "
                             f"capacity {capacities.edges_per_shard}")
        E_s = capacities.edges_per_shard

    P = num_shards
    src_g = np.zeros((P, E_s), np.int32)
    dst_l = np.zeros((P, E_s), np.int32)
    m = np.zeros((P, E_s), bool)
    lm = np.zeros((P, E_s), bool)
    for p in range(P):
        sel = owner == p
        s, d = src[sel], dst[sel]
        k = s.shape[0]  # dst-sorted order kept from the global list
        src_g[p, :k] = s
        dst_l[p, :k] = d - p * nps
        m[p, :k] = True
        lm[p, :k] = (s // nps) == p

    # Local edges as a shard-local ELL layout; width the largest local
    # in-degree, padded to a multiple of 8.
    max_deg = 1
    for p in range(P):
        row = dst_l[p][m[p] & lm[p]]
        if row.size:
            max_deg = max(max_deg, int(np.bincount(row).max()))
    L = _round_up(max_deg, pad_multiple)
    if capacities is not None:
        if L > capacities.ell_width:
            raise ValueError(f"local in-degree {max_deg} exceeds ELL "
                             f"capacity {capacities.ell_width}")
        L = capacities.ell_width
    ell_src = np.zeros((P, nps, L), np.int32)
    ell_mask = np.zeros((P, nps, L), bool)
    for p in range(P):
        sel = m[p] & lm[p]
        rows, srcs = dst_l[p][sel], src_g[p][sel] - p * nps
        if rows.size == 0:
            continue
        starts = np.searchsorted(rows, np.arange(nps))
        slot = np.arange(rows.size) - starts[rows]  # rank within the row
        ell_src[p, rows, slot] = srcs
        ell_mask[p, rows, slot] = True

    # Boundary exchange: requests[p][r] = sorted unique global rows shard p
    # needs from shard r.
    requests = [[np.zeros(0, np.int64) for _ in range(P)] for _ in range(P)]
    for p in range(P):
        s = src[owner == p]
        s_owner = s // nps
        for r in range(P):
            if r != p:
                requests[p][r] = np.unique(s[s_owner == r])

    # Active deltas: d with some pair (r -> (r + d) % P) that exchanges.
    deltas, delta_rows = [], []
    for d in range(1, P):
        width = max(requests[p][(p - d) % P].size for p in range(P))
        if width:
            deltas.append(d)
            delta_rows.append(_round_up(int(width), pad_multiple))
    if capacities is not None:
        # the ring structure is fixed: the capacity's deltas and widths
        # verbatim (a batch may under-fill or skip some of them)
        need = dict(zip(deltas, delta_rows))
        extra = set(need) - set(capacities.deltas)
        if extra:
            raise ValueError(f"active deltas {sorted(extra)} outside "
                             f"capacity deltas {capacities.deltas}")
        for d, bd in zip(capacities.deltas, capacities.delta_rows):
            if need.get(d, 0) > bd:
                raise ValueError(f"delta {d} needs {need[d]} rows > "
                                 f"capacity {bd}")
        deltas = list(capacities.deltas)
        delta_rows = list(capacities.delta_rows)
    total_b = max(sum(delta_rows), 1)  # >= 1: shapes stay non-empty

    send_idx = np.zeros((P, total_b), np.int32)
    rslot = np.zeros((P, E_s), np.int32)
    off = 0
    for d, bd in zip(deltas, delta_rows):
        for s_dev in range(P):
            need = requests[(s_dev + d) % P][s_dev]
            send_idx[s_dev, off:off + need.size] = (
                need - s_dev * nps).astype(np.int32)
        off += bd
    # each boundary edge's row in the receive buffer (concat over deltas)
    delta_off = {d: sum(delta_rows[:i]) for i, d in enumerate(deltas)}
    for p in range(P):
        s = src[owner == p]
        s_owner = s // nps
        view = rslot[p, :s.size]
        for r in range(P):
            need = requests[p][r]
            if r == p or need.size == 0:
                continue
            em = s_owner == r
            view[em] = (delta_off[(p - r) % P]
                        + np.searchsorted(need, s[em])).astype(np.int32)

    # Compact boundary edge arrays.
    r_counts = (m & ~lm).sum(axis=1)
    Er = max(_round_up(int(r_counts.max()), pad_multiple), pad_multiple)
    if capacities is not None:
        if Er > capacities.remote_edges:
            raise ValueError(f"boundary edge count {int(r_counts.max())} "
                             f"exceeds capacity {capacities.remote_edges}")
        Er = capacities.remote_edges
    remote_dst = np.zeros((P, Er), np.int32)
    remote_src_g = np.zeros((P, Er), np.int32)
    remote_slot_c = np.zeros((P, Er), np.int32)
    remote_mask_c = np.zeros((P, Er), bool)
    for p in range(P):
        sel = m[p] & ~lm[p]
        kk = int(sel.sum())
        remote_dst[p, :kk] = dst_l[p][sel]
        remote_src_g[p, :kk] = src_g[p][sel]
        remote_slot_c[p, :kk] = rslot[p][sel]
        remote_mask_c[p, :kk] = True

    # Per-shard tile-pair plans, stacked with inert tail pairs on the last
    # tile (the JAX package's protocol: an inert step may only revisit the
    # last, already emitted output tile).
    from mrp_gnn_tpu_torch.graph import build_bsp_pairs, derive_bsp_pairs_t
    bsp_tile = next((t for t in (128, 64, 32, 16, 8) if nps % t == 0), 0)
    bsp = dict.fromkeys(_PAIR_KEYS)
    if bsp_tile:
        per = [build_bsp_pairs(ell_src[p], ell_mask[p], bsp_tile)
               for p in range(P)]
        pmax = max(x[0].size for x in per)
        if capacities is not None and capacities.bsp_pairs:
            if pmax > capacities.bsp_pairs:
                raise ValueError(f"{pmax} tile pairs exceed capacity "
                                 f"{capacities.bsp_pairs}")
            pmax = capacities.bsp_pairs
        nt = nps // bsp_tile
        # the source-major re-sort is always pmax + nt long (real pairs and
        # at most one diagonal per source-less tile)
        per_t = [derive_bsp_pairs_t(per[p][0], per[p][1], per[p][3], nt,
                                    max_pairs=pmax + nt) for p in range(P)]
        fills = (nt - 1, nt - 1, 0, 0)  # pair_dst, pair_src, first, last
        stacked, stacked_t = [], []
        for i, fill in enumerate(fills):
            arr = np.full((P, pmax), fill, np.int32)
            for p in range(P):
                arr[p, :per[p][i].size] = per[p][i]
            stacked.append(arr)
            stacked_t.append(np.stack([per_t[p][i] for p in range(P)]))
        bsp = dict(zip(_PAIR_KEYS, stacked + stacked_t))

    out = dict(
        src_global=src_g, dst_local=dst_l, mask=m, local_mask=lm,
        send_idx=send_idx, remote_dst=remote_dst,
        remote_src_global=remote_src_g, remote_slot=remote_slot_c,
        remote_mask=remote_mask_c, ell_src=ell_src, ell_mask=ell_mask,
        deltas=tuple(deltas), delta_rows=tuple(delta_rows),
        bsp_tile=bsp_tile, **bsp,
    )
    _remote_ell_arrays(out, nps, capacities, pad_multiple)
    _expanded_plan_arrays(out, capacities)
    return out


def partition_batch(graph, num_replicas: int, num_shards: int,
                    capacities: PlanCapacities,
                    pad_multiple: int = 8) -> EdgePartitionPlan:
    """Per-batch plan of a dynamic-topology batch, stacked over data
    replicas: arrays [num_replicas * num_shards, ...], so rank (r, p) takes
    row r * num_shards + p.

    The batch's scenes must divide contiguously over replicas, so every
    edge stays inside its replica's node block. The native builder
    (``data/graph_native.py``) makes each replica's arrays where it loads;
    the numpy builder where it does not or declines the shapes, as in the
    JAX package. Both give the same bits.
    """
    V = graph.max_nodes
    if V % num_replicas:
        raise ValueError(f"max_nodes={V} not divisible by "
                         f"num_replicas={num_replicas}")
    v_rep = V // num_replicas
    if v_rep % num_shards:
        raise ValueError(f"replica nodes {v_rep} not divisible by "
                         f"num_shards={num_shards}")
    nps = v_rep // num_shards

    src = np.asarray(graph.edge_src)
    dst = np.asarray(graph.edge_dst)
    mask = np.asarray(graph.edge_mask)
    src, dst = src[mask], dst[mask]
    rep = dst // v_rep
    if src.size and not np.array_equal(rep, src // v_rep):
        raise ValueError("an edge crosses data-replica node blocks: scenes "
                         "must divide contiguously over replicas")

    from mrp_gnn_tpu_torch.data import graph_native
    per = []
    for r in range(num_replicas):
        sel = rep == r
        rs, rd = src[sel] - r * v_rep, dst[sel] - r * v_rep
        arrs = graph_native.partition_plan_arrays_native(
            rs, rd, nps, num_shards, capacities)
        if arrs is None:
            arrs = _plan_arrays(rs, rd, nps, num_shards, pad_multiple,
                                capacities)
        else:
            _remote_ell_arrays(arrs, nps, capacities, pad_multiple)
            _expanded_plan_arrays(arrs, capacities)
        per.append(arrs)
    stacked = {}
    for k, v0 in per[0].items():
        if k in _META_KEYS:
            stacked[k] = v0  # uniform under shared capacities
        elif v0 is None:
            stacked[k] = None
        else:
            stacked[k] = np.concatenate([p[k] for p in per], axis=0)
    return _wrap_plan(stacked, num_shards, nps)


def boundary_fraction(plan: EdgePartitionPlan) -> float:
    """Share of the valid edges whose source is on another shard."""
    valid = np.asarray(plan.mask)
    local = np.asarray(plan.local_mask)
    return float((valid & ~local).sum() / max(valid.sum(), 1))


def exchange_rows(plan: EdgePartitionPlan) -> dict:
    """Rows received per step for the exchange modes: "boundary" (per shard,
    sum_d B_d), "all_gather" (per shard, (P - 1) * nps), "useful_total"
    (the rows really requested, over all shards) and "padded_total" (P *
    sum_d B_d)."""
    P, nps = plan.num_shards, plan.nodes_per_shard
    src = np.asarray(plan.src_global)
    m = np.asarray(plan.mask)
    lm = np.asarray(plan.local_mask)
    # global ids are already distinct across owner shards
    useful = sum(int(np.unique(src[p][m[p] & ~lm[p]]).size) for p in range(P))
    return {
        "boundary": plan.recv_rows,
        "all_gather": (P - 1) * nps,
        "useful_total": useful,
        "padded_total": P * plan.recv_rows,
    }
