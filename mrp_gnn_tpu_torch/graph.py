"""Static-shape robot-graph batching (PyTorch port of ``mrp_gnn_tpu/graph.py``).

A batch of scene graphs is flattened into one padded graph:

- nodes = robot views of all scenes, contiguous per scene, padded to
  ``max_nodes``;
- edges = directed (src -> dst) robot-pair edges within each scene, sorted
  by destination, padded to ``max_edges``;
- masks = validity of each node / edge slot;
- an ELL view (``ell_src``/``ell_mask``: per-destination padded neighbour
  lists) and, where the node count allows, a tile-pair plan (``bsp_*``),
  or, for ELL widths past 128, a row-expanded plan (``bsp_expanded``).

The builders here are numpy and give arrays bit-identical to the JAX
package's numpy builders (``tests/test_torch_graph.py``);
:func:`batch_from_positions` runs the native C++ builder
(``data/graph_native.py``) by default, as the JAX package does, which gives
the same bits. The tile-pair plans, square and row-expanded, are kept
field for field although the CUDA kernels gather straight from
``ell_src``: they mark a batch as one the kernels serve, exactly as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

_TENSOR_FIELDS = (
    "edge_src", "edge_dst", "node_mask", "edge_mask", "node_scene",
    "n_nodes", "n_edges", "scene_adj", "ell_src", "ell_mask",
    "bsp_pair_dst", "bsp_pair_src", "bsp_pair_first", "bsp_pair_last",
    "bsp_pair_dst_t", "bsp_pair_src_t", "bsp_pair_first_t",
    "bsp_pair_last_t")
_PLAN_FIELDS = ("pair_dst", "pair_src", "pair_first", "pair_last",
                "pair_dst_t", "pair_src_t", "pair_first_t", "pair_last_t")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A batch of scene graphs flattened into one padded graph of tensors.

    Same fields as the JAX ``GraphBatch``: int32 index arrays, bool masks,
    float32 ``scene_adj``; ``scene_stride`` and ``bsp_tile`` are plain ints.
    ``scene_stride > 0`` tags a block-diagonal batch (every scene shares one
    topology at a fixed node stride), which takes the dense block path.
    ``bsp_expanded`` holds a :class:`BspExpandedPlan` when the ELL width
    passes 128 and the builder made one; ``partition_plan`` holds one
    rank's block of a dynamic batch's partition plan
    (``parallel.partition.ShardPlan``, set by
    ``ParallelContext.attach_plan``), else None.
    """

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    node_scene: torch.Tensor
    n_nodes: torch.Tensor
    n_edges: torch.Tensor
    scene_adj: torch.Tensor | None = None
    scene_stride: int = 0
    ell_src: torch.Tensor | None = None
    ell_mask: torch.Tensor | None = None
    bsp_pair_dst: torch.Tensor | None = None
    bsp_pair_src: torch.Tensor | None = None
    bsp_pair_first: torch.Tensor | None = None
    bsp_pair_last: torch.Tensor | None = None
    bsp_pair_dst_t: torch.Tensor | None = None
    bsp_pair_src_t: torch.Tensor | None = None
    bsp_pair_first_t: torch.Tensor | None = None
    bsp_pair_last_t: torch.Tensor | None = None
    bsp_tile: int = 0
    partition_plan: object | None = None
    bsp_expanded: object | None = None

    def to(self, device) -> "GraphBatch":
        """Copy of the batch with every tensor field on ``device``, those of
        the row-expanded and the partition plan included."""
        return self.apply(lambda t: t.to(device))

    def apply(self, fn) -> "GraphBatch":
        """Copy of the batch with ``fn`` applied to every tensor field, those
        of the row-expanded plan and of the partition plan included."""
        moved = {f: fn(getattr(self, f)) for f in _TENSOR_FIELDS
                 if getattr(self, f) is not None}
        for f in ("bsp_expanded", "partition_plan"):
            if getattr(self, f) is not None:
                moved[f] = getattr(self, f).apply(fn)
        return dataclasses.replace(self, **moved)

    @property
    def max_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def max_edges(self) -> int:
        return self.edge_mask.shape[0]


def _t(a) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _round_up_int(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BspExpandedPlan:
    """Row-expanded tile-pair plan for ELL widths past 128 (the JAX
    package's ``BspExpandedPlan``, field for field, as int32 tensors).

    The [V, deg] neighbour list is viewed as [V * rows, width] (row-major:
    node v's list splits across expanded rows v * rows .. v * rows + rows -
    1; pad columns are mask-False). ``pair_*`` walk the rectangular (V *
    rows destination, V source) tile space, ``pair_*_t`` its source-major
    re-sort. The CUDA kernels gather from the expanded view of ``ell_src``
    and never read the pairs: the plan marks a batch as one they serve.
    """

    pair_dst: torch.Tensor
    pair_src: torch.Tensor
    pair_first: torch.Tensor
    pair_last: torch.Tensor
    pair_dst_t: torch.Tensor
    pair_src_t: torch.Tensor
    pair_first_t: torch.Tensor
    pair_last_t: torch.Tensor
    rows: int
    width: int

    def to(self, device) -> "BspExpandedPlan":
        return self.apply(lambda t: t.to(device))

    def apply(self, fn) -> "BspExpandedPlan":
        """Copy of the plan with ``fn`` applied to every tensor field."""
        return dataclasses.replace(
            self, **{f: fn(getattr(self, f)) for f in _PLAN_FIELDS})


def expanded_ell_shape(deg: int, cap: int = 128) -> tuple[int, int]:
    """(rows, width) of the row-expanded view of an ELL width ``deg``: the
    fewest rows keeping width <= cap, width rounded up to a multiple of 8."""
    rows = -(-deg // cap)
    width = _round_up_int(-(-deg // rows), 8)
    return rows, width


def build_expanded_bsp(ell_src: np.ndarray, ell_mask: np.ndarray,
                       tile: int, cap: int = 128,
                       max_pairs: int | None = None) -> BspExpandedPlan:
    """Host-side expanded tile-pair plan for a high-degree ELL layout.

    ``max_pairs`` pins the plan length (inert padding, as
    :func:`build_bsp_pairs`); a batch that needs more pairs raises
    ValueError. The expanded plan length is not subset-monotone, so callers
    bound their own topology family.
    """
    V, deg = ell_src.shape
    rows, width = expanded_ell_shape(deg, cap)
    pad = rows * width - deg
    src_x = np.pad(np.asarray(ell_src), ((0, 0), (0, pad))).reshape(
        V * rows, width)
    mask_x = np.pad(np.asarray(ell_mask), ((0, 0), (0, pad))).reshape(
        V * rows, width)
    nt_src = V // tile
    pairs = build_bsp_pairs(src_x, mask_x, tile, max_pairs=max_pairs,
                            num_src_tiles=nt_src)
    pairs_t = derive_bsp_pairs_t(
        pairs[0], pairs[1], pairs[3], nt_src,
        max_pairs=bsp_pairs_t_capacity(max_pairs, nt_src))
    return BspExpandedPlan(*(_t(a) for a in (*pairs, *pairs_t)),
                           rows=rows, width=width)


def _warn_hideg_fallback(width: int) -> None:
    """Warn (once per process, by the default warnings filter) that a
    capacity-pinned batch crossed the 128-column degree cap without the
    ``max_expanded_pairs`` opt-in, so it carries no row-expanded plan and
    attention and mean take the plain ELL gather path."""
    warnings.warn(
        f"graph batch in-degree width {width} exceeds the 128-column kernel "
        "cap but carries no row-expanded plan: capacity-pinned (dynamic) "
        "streams build one only with an explicit opt-in, so edge "
        "aggregation takes the plain ELL gather path. Pass "
        "max_expanded_pairs=<bound for your topology family> to "
        "batch_from_positions/build_graph_batch to opt in",
        UserWarning, stacklevel=3)


def fully_connected_edges(num_robots: int, self_loops: bool = False) -> np.ndarray:
    """Directed edge list of the fully-connected team graph: int32 [2, E]
    (src, dst), destination-major."""
    src, dst = [], []
    for i in range(num_robots):
        for j in range(num_robots):
            if i == j and not self_loops:
                continue
            src.append(j)
            dst.append(i)
    if not src:
        return np.zeros((2, 0), np.int32)
    return np.stack([np.array(src, np.int32), np.array(dst, np.int32)])


def radius_edges(num_robots: int, radius: int,
                 self_loops: bool = False) -> np.ndarray:
    """Communication-range graph over robot indices: i, j connected iff
    |i - j| <= radius. Returns int32 [2, E]."""
    src, dst = [], []
    for i in range(num_robots):
        for j in range(num_robots):
            if i == j and not self_loops:
                continue
            if abs(i - j) <= radius:
                src.append(j)
                dst.append(i)
    if not src:
        return np.zeros((2, 0), np.int32)
    return np.stack([np.array(src, np.int32), np.array(dst, np.int32)])


def positions_radius_edges(positions: np.ndarray, radius: float,
                           self_loops: bool = False) -> np.ndarray:
    """Metric communication-range graph: edge j -> i iff
    ||p_i - p_j|| <= radius. positions: [N] or [N, d]. Returns int32 [2, E]."""
    p = np.asarray(positions, np.float64)
    if p.ndim == 1:
        p = p[:, None]
    d = np.linalg.norm(p[None, :, :] - p[:, None, :], axis=-1)  # d[i, j]
    adj = d <= radius
    if not self_loops:
        np.fill_diagonal(adj, False)
    dst, src = np.nonzero(adj)  # adj[i, j]: edge j -> i
    return np.stack([src.astype(np.int32), dst.astype(np.int32)])


def batch_from_positions(
    scene_positions: Sequence[np.ndarray],
    radius: float,
    max_nodes: int,
    max_edges: int,
    max_degree: int,
    max_bsp_pairs: int | None = None,
    max_expanded_pairs: int | None = None,
    backend: str = "auto",
) -> GraphBatch:
    """Per-batch GraphBatch from per-scene robot positions (dynamic swarms),
    under pinned capacities so every batch has the same shapes.

    backend: "auto" runs the native C++ builder (``data/graph_native.py``)
    where it builds and takes the shapes, else the numpy builder; "native"
    raises rather than fall back; "numpy" forces the numpy builder. Both
    give bit-identical batches.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown graph builder backend {backend!r}")
    if backend != "numpy":
        from mrp_gnn_tpu_torch.data import graph_native
        gb = graph_native.batch_from_positions_native(
            scene_positions, radius, max_nodes, max_edges, max_degree,
            max_bsp_pairs, max_expanded_pairs=max_expanded_pairs)
        if gb is not None:
            if (gb.bsp_tile > 0 and gb.ell_src.shape[1] > 128
                    and gb.bsp_expanded is None):
                _warn_hideg_fallback(int(gb.ell_src.shape[1]))
            return gb
        if backend == "native":
            raise RuntimeError("native graph builder requested but the "
                               "shared library could not be built/loaded")
    edges = [positions_radius_edges(p, radius) for p in scene_positions]
    return build_graph_batch(edges, [len(p) for p in scene_positions],
                             max_nodes=max_nodes, max_edges=max_edges,
                             max_degree=max_degree,
                             max_bsp_pairs=max_bsp_pairs,
                             max_expanded_pairs=max_expanded_pairs)


def scene_edges_for(num_robots: int, connectivity: str = "full",
                    comm_radius: int = 0, self_loops: bool = False) -> np.ndarray:
    """Edge list for one scene by connectivity kind: "full" | "radius"."""
    if connectivity == "full":
        return fully_connected_edges(num_robots, self_loops)
    if connectivity == "radius":
        if comm_radius <= 0:
            raise ValueError("radius connectivity needs comm_radius > 0")
        return radius_edges(num_robots, comm_radius, self_loops)
    raise ValueError(f"unknown connectivity {connectivity!r}")


def build_graph_batch(
    scene_edges: Sequence[np.ndarray],
    scene_num_nodes: Sequence[int],
    max_nodes: int,
    max_edges: int,
    max_degree: int | None = None,
    max_bsp_pairs: int | None = None,
    max_expanded_pairs: int | None = None,
) -> GraphBatch:
    """Flatten per-scene edge lists into one padded, dst-sorted GraphBatch.

    Args:
      scene_edges: per scene, int [2, E_s] (src, dst) in scene-local ids.
      scene_num_nodes: per scene, number of robot nodes.
      max_nodes / max_edges: static padded capacities.
      max_degree: pin the ELL width (rounded up to 8) for dynamic streams.
      max_bsp_pairs: pin the tile-pair plan length (inert-padded).
      max_expanded_pairs: pin the row-expanded plan length (ELL width >
        128) for dynamic streams; without it a pinned batch past the cap
        gets no plan (and a warning), an unpinned one an unpinned plan.
    """
    srcs, dsts, scenes = [], [], []
    offset = 0
    for sid, (edges, n) in enumerate(zip(scene_edges, scene_num_nodes)):
        if edges.size:
            if edges.max() >= n:
                raise ValueError(f"scene {sid}: edge index {edges.max()} >= {n} nodes")
            srcs.append(edges[0].astype(np.int64) + offset)
            dsts.append(edges[1].astype(np.int64) + offset)
        scenes.append(np.full(n, sid, np.int32))
        offset += n
    n_nodes = offset
    if n_nodes > max_nodes:
        raise ValueError(f"{n_nodes} nodes > max_nodes={max_nodes}")
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    n_edges = src.shape[0]
    if n_edges > max_edges:
        raise ValueError(f"{n_edges} edges > max_edges={max_edges}")

    # Stable sort by destination: contiguous dst segments, src order kept.
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]

    pad_e = max_edges - n_edges
    edge_src = np.concatenate([src, np.zeros(pad_e, np.int64)]).astype(np.int32)
    edge_dst = np.concatenate([dst, np.zeros(pad_e, np.int64)]).astype(np.int32)
    edge_mask = np.arange(max_edges) < n_edges
    node_mask = np.arange(max_nodes) < n_nodes
    node_scene = np.concatenate(
        [np.concatenate(scenes) if scenes else np.zeros(0, np.int32),
         np.zeros(max_nodes - n_nodes, np.int32)]
    )
    # ELL view; width rounded up to a multiple of 8, minimum 8.
    deg = np.bincount(dst, minlength=max_nodes) if n_edges else np.zeros(max_nodes, np.int64)
    max_deg = max(_round_up_int(int(deg.max()) if deg.size else 1, 8), 8)
    if max_degree is not None:
        cap = max(_round_up_int(max_degree, 8), 8)
        if max_deg > cap:
            raise ValueError(f"max in-degree {int(deg.max())} exceeds "
                             f"max_degree capacity {max_degree}")
        max_deg = cap
    ell_src = np.zeros((max_nodes, max_deg), np.int32)
    ell_mask = np.zeros((max_nodes, max_deg), bool)
    if n_edges:
        # slot = edge rank within its destination segment
        starts = np.searchsorted(dst, np.arange(max_nodes))
        slot = np.arange(dst.size) - starts[dst]
        ell_src[dst, slot] = src
        ell_mask[dst, slot] = True

    # Tile-pair plan, with the same tile choice as the JAX package.
    bsp_tile = 0
    pairs = (None,) * 4
    pairs_t = (None,) * 4
    expanded = None
    for t in (128, 256, 64, 32, 16, 8):
        if max_nodes % t == 0:
            bsp_tile = t
            if max_deg > 128:
                if max_expanded_pairs is not None:
                    expanded = build_expanded_bsp(
                        ell_src, ell_mask, t, max_pairs=max_expanded_pairs)
                elif max_bsp_pairs is None and max_degree is None:
                    expanded = build_expanded_bsp(ell_src, ell_mask, t)
                else:
                    _warn_hideg_fallback(max_deg)
                break
            pairs = build_bsp_pairs(ell_src, ell_mask, t,
                                    max_pairs=max_bsp_pairs)
            nt = max_nodes // t
            pairs_t = derive_bsp_pairs_t(
                pairs[0], pairs[1], pairs[3], nt,
                max_pairs=bsp_pairs_t_capacity(max_bsp_pairs, nt))
            break

    return GraphBatch(
        edge_src=_t(edge_src),
        edge_dst=_t(edge_dst),
        node_mask=_t(node_mask),
        edge_mask=_t(edge_mask),
        node_scene=_t(node_scene),
        n_nodes=torch.tensor(n_nodes, dtype=torch.int32),
        n_edges=torch.tensor(n_edges, dtype=torch.int32),
        ell_src=_t(ell_src),
        ell_mask=_t(ell_mask),
        bsp_pair_dst=_t(pairs[0]),
        bsp_pair_src=_t(pairs[1]),
        bsp_pair_first=_t(pairs[2]),
        bsp_pair_last=_t(pairs[3]),
        bsp_pair_dst_t=_t(pairs_t[0]),
        bsp_pair_src_t=_t(pairs_t[1]),
        bsp_pair_first_t=_t(pairs_t[2]),
        bsp_pair_last_t=_t(pairs_t[3]),
        bsp_tile=bsp_tile,
        bsp_expanded=expanded,
    )


def build_bsp_pairs(ell_src: np.ndarray, ell_mask: np.ndarray, tile: int,
                    max_pairs: int | None = None,
                    num_src_tiles: int | None = None):
    """Host-side (dst tile, src tile) pair plan, grouped by destination tile
    ascending; every dst tile gets at least one pair (its diagonal).

    Returns (pair_dst, pair_src, pair_first, pair_last) int32 numpy arrays.
    ``max_pairs`` pads the plan with inert pairs (first = last = 0).
    ``num_src_tiles`` bounds the rectangular (row-expanded) case.
    """
    src = np.asarray(ell_src)
    mask = np.asarray(ell_mask)
    V, W = src.shape
    nt = V // tile
    nts = num_src_tiles if num_src_tiles is not None else nt
    # (dst tile, src tile) incidence via one bincount over the nt x nts keys.
    flat = np.flatnonzero(mask.ravel())
    key = (flat // (W * tile)) * nts + src.ravel()[flat] // tile
    cnt = np.bincount(key, minlength=nt * nts)
    pd_a, ps_a = np.nonzero(cnt.reshape(nt, nts))  # row-major => dst-major
    present = np.zeros(nt, bool)
    present[pd_a] = True
    missing = np.nonzero(~present)[0]
    if missing.size:  # edge-less dst tile: diagonal fallback
        pd_a = np.concatenate([pd_a, missing])
        ps_a = np.concatenate([ps_a, np.minimum(missing, nts - 1)])
        order = np.lexsort((ps_a, pd_a))
        pd_a, ps_a = pd_a[order], ps_a[order]
    fi_a = np.empty(pd_a.shape[0], np.int32)
    fi_a[0] = 1
    fi_a[1:] = (np.diff(pd_a) != 0).astype(np.int32)
    la_a = np.empty_like(fi_a)
    la_a[:-1] = fi_a[1:]
    la_a[-1] = 1
    if max_pairs is not None:
        n = pd_a.shape[0]
        if n > max_pairs:
            raise ValueError(f"{n} tile pairs exceed max_bsp_pairs="
                             f"{max_pairs}")
        pad = max_pairs - n
        pd_a = np.concatenate([pd_a, np.full(pad, nt - 1)])
        ps_a = np.concatenate([ps_a, np.full(pad, nts - 1)])
        fi_a = np.concatenate([fi_a, np.zeros(pad, np.int32)])
        la_a = np.concatenate([la_a, np.zeros(pad, np.int32)])
    return (pd_a.astype(np.int32), ps_a.astype(np.int32),
            fi_a.astype(np.int32), la_a.astype(np.int32))


def bsp_pairs_t_capacity(max_bsp_pairs: int | None, nt: int) -> int | None:
    """Static length of the transposed plan under a pinned dst-major cap:
    the same pair set plus at most one diagonal fallback per tile."""
    return None if max_bsp_pairs is None else max_bsp_pairs + nt


def derive_bsp_pairs_t(pair_dst, pair_src, pair_last, nt: int,
                       max_pairs: int | None = None):
    """Src-major re-sort of a (possibly inert-padded) tile-pair plan, with
    first/last marking source-group bounds and a diagonal fallback for
    every source-less tile. Returns four int32 numpy arrays."""
    pd = np.asarray(pair_dst)
    ps = np.asarray(pair_src)
    la = np.asarray(pair_last)
    nz = np.nonzero(la)[0]
    real = int(nz[-1]) + 1 if nz.size else 0  # inert tail has last == 0
    order = np.lexsort((pd[:real], ps[:real]))
    spd, sps = pd[:real][order], ps[:real][order]
    starts = np.searchsorted(sps, np.arange(nt))
    ends = np.searchsorted(sps, np.arange(nt), side="right")
    pd2, ps2, fi2, la2 = [], [], [], []
    for s in range(nt):
        i, j = int(starts[s]), int(ends[s])
        if i == j:  # source-less tile: diagonal fallback
            pd2.append(s)
            ps2.append(s)
            fi2.append(1)
            la2.append(1)
            continue
        pd2.extend(spd[i:j].tolist())
        ps2.extend([s] * (j - i))
        fi2.extend([1] + [0] * (j - i - 1))
        la2.extend([0] * (j - i - 1) + [1])
    if max_pairs is not None:
        if len(pd2) > max_pairs:
            raise ValueError(f"{len(pd2)} transposed tile pairs exceed "
                             f"max_pairs={max_pairs}")
        pad = max_pairs - len(pd2)
        pd2 += [nt - 1] * pad
        ps2 += [nt - 1] * pad
        fi2 += [0] * pad
        la2 += [0] * pad
    return (np.array(pd2, np.int32), np.array(ps2, np.int32),
            np.array(fi2, np.int32), np.array(la2, np.int32))


def batch_homogeneous(
    num_scenes: int,
    robots_per_scene: int,
    edges: np.ndarray,
    max_nodes: int | None = None,
    max_edges: int | None = None,
) -> GraphBatch:
    """GraphBatch for ``num_scenes`` scenes sharing one topology ``edges``;
    tagged block-diagonal (scene_stride / scene_adj) when max_nodes is a
    multiple of the scene size."""
    n_nodes = num_scenes * robots_per_scene
    n_edges = num_scenes * edges.shape[1]
    gb = build_graph_batch(
        [edges] * num_scenes,
        [robots_per_scene] * num_scenes,
        max_nodes=max_nodes or n_nodes,
        max_edges=max_edges or max(n_edges, 1),
    )
    n = robots_per_scene
    if gb.max_nodes % n == 0:
        adj = np.zeros((n, n), np.float32)
        adj[edges[1], edges[0]] = 1.0  # adj[dst, src]
        gb = dataclasses.replace(gb, scene_adj=_t(adj), scene_stride=n)
    return gb


def batch_fully_connected(
    num_scenes: int,
    robots_per_scene: int,
    max_nodes: int | None = None,
    max_edges: int | None = None,
    self_loops: bool = False,
) -> GraphBatch:
    """GraphBatch for ``num_scenes`` identical fully-connected teams."""
    return batch_homogeneous(
        num_scenes, robots_per_scene,
        fully_connected_edges(robots_per_scene, self_loops),
        max_nodes=max_nodes, max_edges=max_edges)
