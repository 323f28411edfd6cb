"""Debug-mode utilities: NaN trapping and graph validation (port of
``mrp_gnn_tpu/utils/debug.py``).

- enable_debug() / disable_debug(): autograd's anomaly mode on and off
  (``torch.autograd.set_detect_anomaly``), which raises at the backward op
  that produced a NaN and names the forward op behind it: the port's
  counterpart of ``jax_debug_nans``;
- validate_graph(graph): host-side structural checks of a GraphBatch.

The JAX package's ``checked`` (checkify's NaN and out-of-bounds index
checks inside jit) has no torch counterpart and is not ported: outside jit
there is nothing to functionalize, and the kernel wrappers check their
index inputs themselves.
"""

from __future__ import annotations

import numpy as np
import torch


def enable_debug() -> None:
    torch.autograd.set_detect_anomaly(True)


def disable_debug() -> None:
    torch.autograd.set_detect_anomaly(False)


def validate_graph(graph) -> None:
    """Host-side GraphBatch invariants; raises AssertionError with context."""
    src = np.asarray(graph.edge_src.cpu())
    dst = np.asarray(graph.edge_dst.cpu())
    em = np.asarray(graph.edge_mask.cpu())
    nm = np.asarray(graph.node_mask.cpu())
    V = graph.max_nodes
    assert src.shape == dst.shape == em.shape
    assert (src >= 0).all() and (src < V).all(), "edge_src out of range"
    assert (dst >= 0).all() and (dst < V).all(), "edge_dst out of range"
    assert nm[src[em]].all(), "valid edge from padded source node"
    assert nm[dst[em]].all(), "valid edge into padded destination node"
    d = dst[em]
    assert (np.diff(d) >= 0).all(), "valid edges not dst-sorted"
    if graph.ell_src is not None:
        ell_m = np.asarray(graph.ell_mask.cpu())
        assert int(ell_m.sum()) == int(em.sum()), "ELL/edge-list edge count mismatch"
    if graph.scene_stride:
        assert V % graph.scene_stride == 0, "block stride does not tile nodes"
