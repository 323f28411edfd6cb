"""ctypes bridge to the native C++ graph-plan builder
(``native/graphbuild.cc``).

Port of ``mrp_gnn_tpu/data/graph_native.py``: ``batch_from_positions_native``
and ``partition_plan_arrays_native``. Dynamic topologies rebuild the
GraphBatch (and, when partitioned, its partition plan) every batch from
the robots' positions; the library does that on the input pipeline's
thread. It is built from the
unchanged source at first use (``_native_loader``, into ``data/_build/``).
Its batches are bit-identical to the numpy builder's
(``graph.build_graph_batch`` over ``graph.positions_radius_edges``); the
transposed and row-expanded plans are derived from its arrays in numpy, as
the JAX package does; so are its partition plans to the numpy
``parallel/partition.py::_plan_arrays``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mrp_gnn_tpu_torch.data._native_loader import NativeLibrary
from mrp_gnn_tpu_torch.graph import (GraphBatch, _round_up_int, _t,
                                     bsp_pairs_t_capacity, build_expanded_bsp,
                                     derive_bsp_pairs_t)

_ERRORS = {
    -1: "edge capacity exceeded (raise max_edges)",
    -2: "in-degree capacity exceeded (raise max_degree)",
    -3: "tile-pair capacity exceeded (raise max_bsp_pairs)",
    -4: "bad shapes (S*N > max_nodes or max_nodes % tile != 0)",
}

# Subprocess smoke call (see _native_loader): 1 scene x 2 robots within
# radius over 8 node slots runs the real entry point end to end.
_SMOKE = """
import sys, ctypes
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
lib.mrp_build_plan.restype = ctypes.c_int
vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
pos = np.array([0.0, 1.0], np.float64)
es = np.zeros(64, np.int32); ed = np.zeros(64, np.int32)
em = np.zeros(64, np.uint8)
ell_s = np.zeros(8 * 8, np.int32); ell_m = np.zeros(8 * 8, np.uint8)
pd = np.zeros(4, np.int32); ps = np.zeros(4, np.int32)
fi = np.zeros(4, np.int32); la = np.zeros(4, np.int32)
ne = np.zeros(1, np.int32)
rc = lib.mrp_build_plan(vp(pos), 1, 2, 1, ctypes.c_double(10.0),
                        8, 64, 8, 4, 8,
                        vp(es), vp(ed), vp(em), vp(ell_s), vp(ell_m),
                        vp(pd), vp(ps), vp(fi), vp(la), vp(ne))
assert rc == 0 and ne[0] == 2, (rc, int(ne[0]))
"""


def _configure(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.mrp_build_plan.restype = ctypes.c_int
    lib.mrp_build_plan.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        i32p, i32p, u8p, i32p, u8p, i32p, i32p, i32p, i32p,
        np.ctypeslib.ndpointer(np.int32, shape=(1,)),
    ]
    lib.mrp_build_partition_plan.restype = ctypes.c_int
    lib.mrp_build_partition_plan.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, u8p, u8p,
        i32p, i32p, i32p, i32p, u8p,
        i32p, u8p,
        i32p, i32p, i32p, i32p,
    ]


LIBRARY = NativeLibrary("graphbuild", _SMOKE, _configure)


def is_available() -> bool:
    """True when the builder library builds and passes its smoke call."""
    return LIBRARY.get() is not None


def batch_from_positions_native(scene_positions, radius, max_nodes,
                                max_edges, max_degree, max_bsp_pairs,
                                max_expanded_pairs=None):
    """Native counterpart of ``graph.batch_from_positions``' numpy path.

    Returns a GraphBatch of CPU tensors, or None when the library is not
    available or the inputs are outside its shapes (scenes of different
    sizes, or no tile that divides max_nodes). Raises ValueError on a
    capacity violation. Positions may be [N] baseline offsets or [N, d]
    coordinates, as ``graph.positions_radius_edges`` takes them.
    """
    lib = LIBRARY.get()
    if lib is None:
        return None
    pos = [np.asarray(p, np.float64) for p in scene_positions]
    if (not pos or any(p.ndim not in (1, 2) for p in pos)
            or len({p.shape for p in pos}) != 1):
        return None
    dim = 1 if pos[0].ndim == 1 else int(pos[0].shape[1])
    S, N = len(pos), pos[0].shape[0]
    tile = next((t for t in (128, 256, 64, 32, 16, 8) if max_nodes % t == 0),
                0)
    if tile == 0:
        return None
    max_deg = max(_round_up_int(max_degree, 8), 8)
    nt = max_nodes // tile
    # Unpinned: room for every pair, trimmed below to the numpy length.
    cap_pairs = nt * nt if max_bsp_pairs is None else max_bsp_pairs

    p_all = np.ascontiguousarray(np.stack(pos))
    edge_src = np.zeros(max_edges, np.int32)
    edge_dst = np.zeros(max_edges, np.int32)
    edge_mask = np.zeros(max_edges, np.uint8)
    ell_src = np.zeros((max_nodes, max_deg), np.int32)
    ell_mask = np.zeros((max_nodes, max_deg), np.uint8)
    pd = np.zeros(cap_pairs, np.int32)
    ps = np.zeros(cap_pairs, np.int32)
    fi = np.zeros(cap_pairs, np.int32)
    la = np.zeros(cap_pairs, np.int32)
    n_out = np.zeros(1, np.int32)
    rc = lib.mrp_build_plan(p_all.reshape(-1), S, N, dim, float(radius),
                            max_nodes, max_edges, max_deg, cap_pairs, tile,
                            edge_src, edge_dst, edge_mask, ell_src.reshape(-1),
                            ell_mask.reshape(-1), pd, ps, fi, la, n_out)
    if rc == -4:
        return None  # outside the library's shapes: the numpy builder's
    if rc != 0:
        raise ValueError(f"native graph builder: {_ERRORS.get(rc, rc)}")
    ell_mask = ell_mask.astype(bool)
    if max_bsp_pairs is None:
        # every dst tile ends with one last = 1 (its diagonal at worst), so
        # the last real pair is the last nonzero of `la`
        real = int(np.nonzero(la)[0][-1]) + 1
        pd, ps, fi, la = pd[:real], ps[:real], fi[:real], la[:real]
    pairs_t = (None,) * 4
    expanded = None
    if max_deg > 128:
        # Past the 128-column cap there is no square plan (as in
        # graph.build_graph_batch); the row-expanded one only on opt-in.
        pd = ps = fi = la = None
        if max_expanded_pairs is not None:
            expanded = build_expanded_bsp(ell_src, ell_mask, tile,
                                          max_pairs=max_expanded_pairs)
    else:
        pairs_t = derive_bsp_pairs_t(
            pd, ps, la, nt, max_pairs=bsp_pairs_t_capacity(max_bsp_pairs, nt))

    n_nodes = S * N
    node_scene = np.zeros(max_nodes, np.int32)
    node_scene[:n_nodes] = np.repeat(np.arange(S, dtype=np.int32), N)
    return GraphBatch(
        edge_src=_t(edge_src),
        edge_dst=_t(edge_dst),
        node_mask=_t(np.arange(max_nodes) < n_nodes),
        edge_mask=_t(edge_mask.astype(bool)),
        node_scene=_t(node_scene),
        n_nodes=torch.tensor(n_nodes, dtype=torch.int32),
        n_edges=torch.tensor(int(n_out[0]), dtype=torch.int32),
        ell_src=_t(ell_src),
        ell_mask=_t(ell_mask),
        bsp_pair_dst=_t(pd),
        bsp_pair_src=_t(ps),
        bsp_pair_first=_t(fi),
        bsp_pair_last=_t(la),
        bsp_pair_dst_t=_t(pairs_t[0]),
        bsp_pair_src_t=_t(pairs_t[1]),
        bsp_pair_first_t=_t(pairs_t[2]),
        bsp_pair_last_t=_t(pairs_t[3]),
        bsp_tile=tile,
        bsp_expanded=expanded,
    )


_PART_ERRORS = {
    -10: "shard edge count exceeds edges_per_shard capacity",
    -11: "local in-degree exceeds ELL width capacity",
    -12: "active delta outside capacity delta set",
    -13: "per-delta request rows exceed capacity width",
    -14: "boundary edge count exceeds remote_edges capacity",
    -15: "tile pairs exceed bsp_pairs capacity",
}


def partition_plan_arrays_native(src, dst, nps, num_shards, capacities):
    """Native counterpart of ``parallel.partition._plan_arrays`` on its
    capacity-pinned path (the per-batch plans of a dynamic stream).

    src/dst: one replica's masked, replica-local, dst-sorted edges. Returns
    the ``_plan_arrays`` dict (numpy, the source-major tile-pair plans
    derived here) without the remote ELL and row-expanded arrays, which the
    caller derives as for the numpy builder; None when the library is not
    available, no capacities are given, or a tile divides nps but
    ``capacities.bsp_pairs`` is 0 (the numpy builder sizes its own pair
    count there). Raises ValueError on a capacity violation.
    """
    lib = LIBRARY.get()
    if lib is None or capacities is None:
        return None
    P = num_shards
    bsp_tile = next((t for t in (128, 64, 32, 16, 8) if nps % t == 0), 0)
    if bsp_tile and not capacities.bsp_pairs:
        return None
    E_s = int(capacities.edges_per_shard)
    L = int(capacities.ell_width)
    Er = int(capacities.remote_edges)
    n_deltas = len(capacities.deltas)
    # ndpointer needs a real buffer even when there is no delta
    deltas = np.ascontiguousarray(capacities.deltas or (0,), np.int32)
    drows = np.ascontiguousarray(capacities.delta_rows or (0,), np.int32)
    total_b = max(int(np.sum(capacities.delta_rows)), 1)
    bsp_pairs = int(capacities.bsp_pairs) if bsp_tile else 0

    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    src_g = np.zeros((P, E_s), np.int32)
    dst_l = np.zeros((P, E_s), np.int32)
    m = np.zeros((P, E_s), np.uint8)
    lm = np.zeros((P, E_s), np.uint8)
    send_idx = np.zeros((P, total_b), np.int32)
    remote_dst = np.zeros((P, Er), np.int32)
    remote_src_g = np.zeros((P, Er), np.int32)
    remote_slot = np.zeros((P, Er), np.int32)
    remote_mask = np.zeros((P, Er), np.uint8)
    ell_src = np.zeros((P, nps, L), np.int32)
    ell_mask = np.zeros((P, nps, L), np.uint8)
    n_pd = max(bsp_pairs, 1)
    pd = np.zeros((P, n_pd), np.int32)
    ps = np.zeros((P, n_pd), np.int32)
    fi = np.zeros((P, n_pd), np.int32)
    la = np.zeros((P, n_pd), np.int32)

    rc = lib.mrp_build_partition_plan(
        src, dst, int(src.size), nps, P, E_s, L, Er, n_deltas, deltas, drows,
        bsp_tile, bsp_pairs,
        src_g.reshape(-1), dst_l.reshape(-1), m.reshape(-1), lm.reshape(-1),
        send_idx.reshape(-1), remote_dst.reshape(-1),
        remote_src_g.reshape(-1), remote_slot.reshape(-1),
        remote_mask.reshape(-1), ell_src.reshape(-1), ell_mask.reshape(-1),
        pd.reshape(-1), ps.reshape(-1), fi.reshape(-1), la.reshape(-1))
    if rc != 0:
        raise ValueError(f"native partition plan builder: "
                         f"{_PART_ERRORS.get(rc, rc)}")

    out = dict(
        src_global=src_g, dst_local=dst_l, mask=m.astype(bool),
        local_mask=lm.astype(bool), send_idx=send_idx,
        remote_dst=remote_dst, remote_src_global=remote_src_g,
        remote_slot=remote_slot, remote_mask=remote_mask.astype(bool),
        ell_src=ell_src, ell_mask=ell_mask.astype(bool),
        deltas=tuple(capacities.deltas),
        delta_rows=tuple(capacities.delta_rows),
        bsp_tile=bsp_tile,
        bsp_pair_dst=None, bsp_pair_src=None,
        bsp_pair_first=None, bsp_pair_last=None,
        bsp_pair_dst_t=None, bsp_pair_src_t=None,
        bsp_pair_first_t=None, bsp_pair_last_t=None,
    )
    if bsp_tile:
        nt = nps // bsp_tile
        per_t = [derive_bsp_pairs_t(pd[p], ps[p], la[p], nt,
                                    max_pairs=bsp_pairs + nt)
                 for p in range(P)]
        out.update(
            bsp_pair_dst=pd, bsp_pair_src=ps,
            bsp_pair_first=fi, bsp_pair_last=la,
            bsp_pair_dst_t=np.stack([t[0] for t in per_t]),
            bsp_pair_src_t=np.stack([t[1] for t in per_t]),
            bsp_pair_first_t=np.stack([t[2] for t in per_t]),
            bsp_pair_last_t=np.stack([t[3] for t in per_t]),
        )
    return out
