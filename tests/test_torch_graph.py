"""The port's numpy graph builders give arrays bit-identical to the JAX
package's (mrp_gnn_tpu_torch/graph.py vs mrp_gnn_tpu/graph.py), the
row-expanded plans for ELL widths past 128 included."""

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
from torch_native_jax import jax_native  # noqa: F401

ARRAY_FIELDS = ["edge_src", "edge_dst", "node_mask", "edge_mask",
                "node_scene", "n_nodes", "n_edges", "scene_adj", "ell_src",
                "ell_mask", "bsp_pair_dst", "bsp_pair_src", "bsp_pair_first",
                "bsp_pair_last", "bsp_pair_dst_t", "bsp_pair_src_t",
                "bsp_pair_first_t", "bsp_pair_last_t"]


def assert_plan_equal(got, want):
    """Row-expanded plans identical: rows, width and every pair array."""
    assert (got is None) == (want is None)
    if got is None:
        return
    assert (got.rows, got.width) == (want.rows, want.width)
    for f in tg._PLAN_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


def assert_graph_equal(got, want):
    """Every shared field identical: values, dtypes, None-ness, meta."""
    assert got.scene_stride == want.scene_stride
    assert got.bsp_tile == want.bsp_tile
    assert_plan_equal(got.bsp_expanded, want.bsp_expanded)
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


@pytest.mark.usefixtures("jax_native")
def test_unported_paths_raise():
    """No builder path is left unported: a wide ELL layout builds its plan,
    and backend "native" gives the JAX package's native bits (an unknown
    backend raises)."""
    n = 140
    edges = tg.fully_connected_edges(n)
    g = tg.build_graph_batch([edges], [n], max_nodes=256,
                             max_edges=edges.shape[1])
    assert g.bsp_expanded is not None
    rng = np.random.default_rng(4)
    pos = [np.arange(16.0) + rng.uniform(-1, 1, 16) for _ in range(2)]
    caps = dict(max_nodes=32, max_edges=2 * 16 * 15, max_degree=15,
                max_bsp_pairs=4)
    assert_graph_equal(
        tg.batch_from_positions(pos, 2.5, backend="native", **caps),
        jg.batch_from_positions(pos, 2.5, backend="native", **caps))
    with pytest.raises(ValueError, match="backend"):
        tg.batch_from_positions(pos, 2.5, backend="cuda", **caps)


@pytest.mark.parametrize("n,V", [(130, 256), (193, 256), (257, 384),
                                 (193, 512)])
def test_expanded_plan_matches_jax(n, V):
    """Unpinned plans of fully connected teams past the 128-column cap."""
    edges = jg.fully_connected_edges(n)
    got = tg.batch_homogeneous(1, n, edges, max_nodes=V)
    want = jg.batch_homogeneous(1, n, edges, max_nodes=V)
    assert got.bsp_expanded is not None and got.bsp_pair_dst is None
    assert_graph_equal(got, want)
    assert tg.expanded_ell_shape(got.ell_src.shape[1]) == (
        got.bsp_expanded.rows, got.bsp_expanded.width)


def test_pinned_expanded_plan_matches_jax_and_raises_past_its_cap():
    """batch_from_positions(max_expanded_pairs=64): the same inert-padded
    plan length for two topologies, bit-identical to JAX; a batch that
    needs more pairs raises on both sides."""
    rng = np.random.default_rng(0)
    N, V = 140, 256
    caps = dict(max_nodes=V, max_edges=N * (N - 1), max_degree=N - 1,
                max_expanded_pairs=64)
    for _ in range(2):
        pos = [np.sort(rng.uniform(0, 30.0, size=N))]
        got = tg.batch_from_positions(pos, 12.0, **caps)
        assert_graph_equal(got, jg.batch_from_positions(pos, 12.0,
                                                        backend="numpy",
                                                        **caps))
        assert got.bsp_expanded.pair_dst.shape == (64,)
    pos = [np.sort(rng.uniform(0, 30.0, size=N))]
    for builder in (tg.batch_from_positions,
                    lambda *a, **k: jg.batch_from_positions(
                        *a, backend="numpy", **k)):
        with pytest.raises(ValueError, match="pairs exceed"):
            builder(pos, 12.0, **{**caps, "max_expanded_pairs": 2})


def test_hideg_warning_matches_jax():
    """A pinned batch past the cap without max_expanded_pairs warns and gets
    no plan; the opt-in and an unpinned static batch stay silent."""
    rng = np.random.default_rng(0)
    N, V = 140, 256
    caps = dict(max_nodes=V, max_edges=N * (N - 1), max_degree=N - 1)
    pos = [np.sort(rng.uniform(0, 30.0, size=N))]
    for builder in (tg.batch_from_positions,
                    lambda *a, **k: jg.batch_from_positions(
                        *a, backend="numpy", **k)):
        with pytest.warns(UserWarning, match="max_expanded_pairs"):
            assert builder(pos, 12.0, **caps).bsp_expanded is None
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            assert builder(pos, 12.0, max_expanded_pairs=64,
                           **caps).bsp_expanded is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        g = tg.batch_homogeneous(1, 193, tg.fully_connected_edges(193),
                                 max_nodes=256)
    assert g.bsp_expanded is not None


def test_expanded_plan_heterogeneous_scenes_match_jax():
    """Only some scenes pass the cap: one plan over the shared ELL width."""
    sizes = [193, 50, 100]
    edges = [jg.fully_connected_edges(n) for n in sizes]
    caps = dict(max_nodes=384, max_edges=sum(n * (n - 1) for n in sizes))
    got = tg.build_graph_batch(edges, sizes, **caps)
    assert got.ell_src.shape[1] > 128 and got.bsp_expanded is not None
    assert_graph_equal(got, jg.build_graph_batch(edges, sizes, **caps))


def test_graph_to_device_keeps_every_field():
    g = tg.batch_homogeneous(2, 4, tg.radius_edges(4, 1))
    moved = g.to("cpu")
    assert moved.scene_stride == g.scene_stride and moved.bsp_tile == g.bsp_tile
    for f in ARRAY_FIELDS:
        a, b = getattr(g, f), getattr(moved, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.numpy(), b.numpy())


def test_graph_to_device_moves_the_expanded_plan():
    g = tg.batch_homogeneous(1, 130, tg.fully_connected_edges(130),
                             max_nodes=256)
    assert_plan_equal(g.to("cpu").bsp_expanded, g.bsp_expanded)
    meta = g.to("meta").bsp_expanded
    assert (meta.rows, meta.width) == (g.bsp_expanded.rows,
                                       g.bsp_expanded.width)
    assert all(getattr(meta, f).device.type == "meta"
               for f in tg._PLAN_FIELDS)
