"""The port's debug and profiling utilities, on CPU: ``validate_graph``
passes on built batches and raises on each broken invariant (with the JAX
package's messages), the anomaly-mode switch, ``trace`` writes a trace."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mrp_gnn_tpu.graph import batch_homogeneous as jax_batch_homogeneous
from mrp_gnn_tpu.utils.debug import validate_graph as jax_validate_graph
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for
from mrp_gnn_tpu_torch.utils import debug, profiling
from torch_small import small


def _graph():
    """2 scenes of 4 robots in a ring (radius 1) padded to 10 node slots."""
    return batch_homogeneous(2, 4, scene_edges_for(4, "radius", 1),
                             max_nodes=10, max_edges=20)


def test_validate_graph_passes_on_built_batches():
    debug.validate_graph(_graph())
    cfg = small(get_config("dynamic_swarm"))
    debug.validate_graph(next(iter(make_dataset(cfg.data, "train")))["graph"])
    debug.validate_graph(batch_homogeneous(2, 4, scene_edges_for(4, "full")))


def _set(g, field, fn):
    t = getattr(g, field).clone()
    fn(t)
    return dataclasses.replace(g, **{field: t})


BROKEN = {
    "edge_src out of range": lambda g: _set(g, "edge_src",
                                            lambda t: t.__setitem__(0, 10)),
    "edge_dst out of range": lambda g: _set(g, "edge_dst",
                                            lambda t: t.__setitem__(0, -1)),
    "valid edge from padded source node": lambda g: _set(
        g, "edge_src", lambda t: t.__setitem__(0, 9)),
    "valid edge into padded destination node": lambda g: _set(
        g, "edge_dst", lambda t: t.__setitem__(int(g.n_edges) - 1, 9)),
    "valid edges not dst-sorted": lambda g: _set(
        g, "edge_dst", lambda t: t.__setitem__(0, 7)),
    "ELL/edge-list edge count mismatch": lambda g: _set(
        g, "ell_mask", lambda t: t.__setitem__((0, 0), not bool(t[0, 0]))),
    "block stride does not tile nodes": lambda g: dataclasses.replace(
        g, scene_stride=4),
}


@pytest.mark.parametrize("message", list(BROKEN))
def test_validate_graph_raises_on_each_broken_invariant(message):
    g = BROKEN[message](_graph())
    with pytest.raises(AssertionError, match=message):
        debug.validate_graph(g)
    # the JAX package's check says the same of the same arrays
    jg = jax_batch_homogeneous(2, 4, scene_edges_for(4, "radius", 1),
                               max_nodes=10, max_edges=20)
    jg = dataclasses.replace(jg, scene_stride=g.scene_stride, **{
        f: np.asarray(getattr(g, f).numpy(), getattr(jg, f).dtype)
        for f in ("edge_src", "edge_dst", "edge_mask", "node_mask",
                  "ell_mask")})
    with pytest.raises(AssertionError, match=message):
        jax_validate_graph(jg)


def test_debug_switches_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    debug.enable_debug()
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        debug.disable_debug()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64).cumsum(0)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(os.path.join(logdir, files[0])) > 0
