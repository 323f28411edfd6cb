"""The port's numpy graph builders give arrays bit-identical to the JAX
package's (mrp_gnn_tpu_torch/graph.py vs mrp_gnn_tpu/graph.py)."""

import dataclasses
import warnings

import numpy as np
import pytest

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data.pipeline import DynamicGraphBuilder as JDynamicBuilder
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data.pipeline import DynamicGraphBuilder as TDynamicBuilder

ARRAY_FIELDS = ["edge_src", "edge_dst", "node_mask", "edge_mask",
                "node_scene", "n_nodes", "n_edges", "scene_adj", "ell_src",
                "ell_mask", "bsp_pair_dst", "bsp_pair_src", "bsp_pair_first",
                "bsp_pair_last", "bsp_pair_dst_t", "bsp_pair_src_t",
                "bsp_pair_first_t", "bsp_pair_last_t"]


def assert_graph_equal(got, want):
    """Every shared field identical: values, dtypes, None-ness, meta."""
    assert got.scene_stride == want.scene_stride
    assert got.bsp_tile == want.bsp_tile
    assert got.bsp_expanded is None and want.bsp_expanded is None
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


def _scenes(seed):
    """Heterogeneous scenes with duplicate edges and edge-less nodes."""
    rng = np.random.default_rng(seed)
    sizes = [5, 9, 3]
    edges = []
    for n in sizes:
        e = rng.integers(0, n, size=(2, 3 * n))
        edges.append(np.concatenate([e, e[:, :2]], axis=1))  # duplicates
    return edges, sizes


@pytest.mark.parametrize("caps", [
    dict(max_nodes=32, max_edges=80),
    dict(max_nodes=32, max_edges=80, max_degree=24, max_bsp_pairs=6),
    dict(max_nodes=20, max_edges=60, max_degree=16),
])
def test_build_graph_batch_matches_jax(caps):
    edges, sizes = _scenes(0)
    assert_graph_equal(tg.build_graph_batch(edges, sizes, **caps),
                       jg.build_graph_batch(edges, sizes, **caps))


def test_build_graph_batch_capacity_errors_match():
    edges, sizes = [jg.fully_connected_edges(12)], [12]  # in-degree 11
    for caps in (dict(max_nodes=10, max_edges=200),
                 dict(max_nodes=32, max_edges=5),
                 dict(max_nodes=32, max_edges=200, max_degree=8)):
        with pytest.raises(ValueError):
            jg.build_graph_batch(edges, sizes, **caps)
        with pytest.raises(ValueError):
            tg.build_graph_batch(edges, sizes, **caps)


@pytest.mark.parametrize("n,radius", [(8, 2), (32, 4)])
def test_batch_from_positions_matches_jax(n, radius):
    rng = np.random.default_rng(n)
    pos = [np.arange(n) + rng.uniform(-1.5, 1.5, n) for _ in range(3)]
    caps = dict(max_nodes=3 * n + 16, max_edges=3 * n * (n - 1),
                max_degree=n - 1)
    got = tg.batch_from_positions(pos, radius, **caps)
    want = jg.batch_from_positions(pos, radius, backend="numpy", **caps)
    assert_graph_equal(got, want)


@pytest.mark.parametrize("S,n,max_nodes", [(4, 8, None), (3, 5, 16),
                                           (2, 32, 128)])
def test_batch_homogeneous_matches_jax(S, n, max_nodes):
    edges = jg.radius_edges(n, 2)
    got = tg.batch_homogeneous(S, n, edges, max_nodes=max_nodes)
    want = jg.batch_homogeneous(S, n, edges, max_nodes=max_nodes)
    assert_graph_equal(got, want)
    assert np.array_equal(tg.fully_connected_edges(n), jg.fully_connected_edges(n))
    assert np.array_equal(tg.scene_edges_for(n, "radius", 3),
                          jg.scene_edges_for(n, "radius", 3))


def test_dynamic_graph_builder_caps_match_jax():
    jc = jget_config("dynamic_swarm").data
    tc = tget_config("dynamic_swarm").data
    jc = dataclasses.replace(jc, graph_builder="numpy")
    tc = dataclasses.replace(tc, graph_builder="numpy")
    spacing = 0.25
    jb = JDynamicBuilder(jc, 256, spacing)
    tb = TDynamicBuilder(tc, 256, spacing)
    assert tb.caps == jb.caps
    assert_graph_equal(tb.nominal_graph(), jb.nominal_graph())
    rng = np.random.default_rng(3)
    pos = [(np.arange(32) + rng.uniform(-1.5, 1.5, 32)) * spacing
           for _ in range(8)]
    assert_graph_equal(tb(pos), jb(pos))


def test_pinned_high_degree_batch_matches_jax_without_plan():
    n = 140  # in-degree 139 > the 128-column cap
    pos = [np.arange(n, dtype=np.float64)]
    caps = dict(max_nodes=256, max_edges=n * (n - 1), max_degree=n - 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tg.batch_from_positions(pos, 200.0, **caps)
        want = jg.batch_from_positions(pos, 200.0, backend="numpy", **caps)
    assert got.bsp_pair_dst is None
    assert_graph_equal(got, want)


def test_unported_paths_raise():
    n = 140
    edges = tg.fully_connected_edges(n)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tg.build_graph_batch([edges], [n], max_nodes=256,
                             max_edges=edges.shape[1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tg.batch_from_positions([np.arange(4.0)], 1.0, max_nodes=8,
                                max_edges=12, max_degree=3, backend="native")


def test_graph_to_device_keeps_every_field():
    g = tg.batch_homogeneous(2, 4, tg.radius_edges(4, 1))
    moved = g.to("cpu")
    assert moved.scene_stride == g.scene_stride and moved.bsp_tile == g.bsp_tile
    for f in ARRAY_FIELDS:
        a, b = getattr(g, f), getattr(moved, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.numpy(), b.numpy())
