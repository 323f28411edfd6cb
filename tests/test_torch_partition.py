"""The port's partition plans (``parallel/partition.py``, and the native
builder ``data/graph_native.partition_plan_arrays_native``) against the JAX
package's: every array bit for bit (dtype, shape, values) and every meta
field, static and per-batch (dynamic), 1 and 2 data replicas, ELL widths
below and past 128, numpy and native, with the capacity errors."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as JG
from mrp_gnn_tpu.parallel import partition as JP
from mrp_gnn_tpu_torch import graph as TG
from mrp_gnn_tpu_torch.data import graph_native as tgn
from mrp_gnn_tpu_torch.parallel import partition as TP
from torch_native_jax import jax_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native")


def assert_same_plan(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None or isinstance(b, (int, tuple)):
            assert a == b, (f.name, a, b)
        else:
            b = np.asarray(b)
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, (
                f.name, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f.name)


STATIC = {
    # 2 full teams of 8 over 4 shards: scenes straddle shards
    "fc_2x8_4": (lambda m: m.batch_fully_connected(2, 8), 4),
    "radius_4x32_8": (lambda m: m.batch_homogeneous(4, 32, m.radius_edges(32, 4)), 8),
    "swarm_partitioned_8": (
        lambda m: m.batch_homogeneous(4, 64, m.radius_edges(64, 4)), 8),
    "fc_2x8_1": (lambda m: m.batch_fully_connected(2, 8), 1),
    # 2 x 193 full teams in 512 slots: local width 128 over 4 shards, 192
    # (row-expanded plans) over 2
    "hideg_4": (lambda m: m.batch_homogeneous(
        2, 193, m.fully_connected_edges(193), max_nodes=512), 4),
    "hideg_2": (lambda m: m.batch_homogeneous(
        2, 193, m.fully_connected_edges(193), max_nodes=512), 2),
}


@pytest.mark.parametrize("name", sorted(STATIC))
def test_static_plan_matches_jax(name):
    build, P = STATIC[name]
    got = TP.partition_graph(build(TG), P)
    want = JP.partition_graph(build(JG), P)
    assert_same_plan(got, want)
    assert TP.boundary_fraction(got) == JP.boundary_fraction(want)
    assert TP.exchange_rows(got) == JP.exchange_rows(want)
    if name == "hideg_2":
        assert got.xp_pair_dst is not None and got.xp_rows == 2


def test_plan_requires_divisible_nodes():
    with pytest.raises(ValueError, match="not divisible"):
        TP.partition_graph(TG.batch_fully_connected(1, 5), 4)


def test_pinned_plan_and_capacity_errors_match_jax():
    """A sparser graph under a denser graph's capacities takes them verbatim;
    a denser one under a sparser one's raises the same error as JAX."""
    dense = dict(t=TG.batch_fully_connected(2, 16), j=JG.batch_fully_connected(2, 16))
    sparse = dict(t=TG.batch_homogeneous(2, 16, TG.radius_edges(16, 1)),
                  j=JG.batch_homogeneous(2, 16, JG.radius_edges(16, 1)))
    caps_t = TP.capacities_of(TP.partition_graph(dense["t"], 4))
    caps_j = JP.capacities_of(JP.partition_graph(dense["j"], 4))
    assert dataclasses.asdict(caps_t) == dataclasses.asdict(caps_j)
    assert_same_plan(TP.partition_graph(sparse["t"], 4, capacities=caps_t),
                     JP.partition_graph(sparse["j"], 4, capacities=caps_j))
    small_t = TP.capacities_of(TP.partition_graph(sparse["t"], 4))
    small_j = JP.capacities_of(JP.partition_graph(sparse["j"], 4))
    with pytest.raises(ValueError) as jax_err:
        JP.partition_graph(dense["j"], 4, capacities=small_j)
    with pytest.raises(ValueError, match="exceeds") as err:
        TP.partition_graph(dense["t"], 4, capacities=small_t)
    assert str(err.value) == str(jax_err.value)


def _positions(S, N, seed, jitter=1.5):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, N - 1, N).astype(np.float64)
    return [base + rng.uniform(-jitter, jitter, N) for _ in range(S)]


def _dyn_graphs(seed, S=4, N=32, radius=4.0):
    kw = dict(radius=radius, max_nodes=S * N, max_edges=S * N * (N - 1),
              max_degree=N - 1, backend="numpy")
    pos = _positions(S, N, seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # hideg: no graph plan
        return (TG.batch_from_positions(pos, **kw),
                JG.batch_from_positions(pos, **kw))


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's per-batch plans from the numpy builder alone."""
    monkeypatch.setattr(tgn, "partition_plan_arrays_native",
                        lambda *a, **k: None)


def _dyn_caps(R, P, S=4, N=32):
    t = TP.capacities_of(TP.partition_graph(
        TG.batch_fully_connected(S // R, N, max_nodes=S * N // R), P))
    j = JP.capacities_of(JP.partition_graph(
        JG.batch_fully_connected(S // R, N, max_nodes=S * N // R), P))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("R,P", [(1, 8), (2, 4), (2, 1)])
def test_dynamic_plan_matches_jax(builder, R, P, request):
    if builder == "numpy":
        request.getfixturevalue("numpy_only")
    caps_t, caps_j = _dyn_caps(R, P)
    if builder == "native":
        tg, _ = _dyn_graphs(0)
        src, dst = (np.asarray(tg.edge_src)[np.asarray(tg.edge_mask)],
                    np.asarray(tg.edge_dst)[np.asarray(tg.edge_mask)])
        keep = dst < tg.max_nodes // R  # replica 0's edges
        assert tgn.partition_plan_arrays_native(
            src[keep], dst[keep], tg.max_nodes // (R * P), P,
            caps_t) is not None, "the native builder was not taken"
    shapes = set()
    for seed in (0, 1):
        tg, jg = _dyn_graphs(seed)
        got = TP.partition_batch(tg, R, P, caps_t)
        assert_same_plan(got, JP.partition_batch(jg, R, P, caps_j))
        assert got.ell_src.shape[0] == R * P
        shapes.add(tuple(getattr(got, k).shape for k in
                         ("send_idx", "ell_src", "remote_dst")))
    assert len(shapes) == 1, shapes


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_dynamic_capacity_violation_raises(builder, request):
    if builder == "numpy":
        request.getfixturevalue("numpy_only")
    caps_t, _ = _dyn_caps(2, 4)
    tg, _ = _dyn_graphs(0)
    with pytest.raises(ValueError, match="capacity"):
        TP.partition_batch(tg, 2, 4, dataclasses.replace(caps_t, ell_width=8))


def test_dynamic_plan_refuses_edges_across_replicas():
    g = TG.batch_fully_connected(1, 8)  # one scene over two replicas
    caps = TP.capacities_of(TP.partition_graph(TG.batch_fully_connected(1, 4), 1))
    with pytest.raises(ValueError, match="crosses data-replica"):
        TP.partition_batch(g, 2, 1, caps)


def test_expanded_opt_in_and_warning_match_jax():
    """Capacity-pinned plans past width 128 carry row-expanded arrays only
    under ``xp_pairs``; without it they warn; a violation raises."""
    build = STATIC["hideg_2"][0]
    tg, jg = build(TG), build(JG)
    base_t, base_j = TP.partition_graph(tg, 2), JP.partition_graph(jg, 2)
    caps_t, caps_j = TP.capacities_of(base_t), JP.capacities_of(base_j)
    with pytest.warns(UserWarning, match="xp_pairs"):
        plan = TP.partition_graph(tg, 2, capacities=caps_t)
    assert plan.xp_pair_dst is None and plan.xp_rows == 0
    n_xp = int(base_t.xp_pair_dst.shape[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        got = TP.partition_graph(tg, 2, capacities=dataclasses.replace(
            caps_t, xp_pairs=n_xp))
    assert_same_plan(got, JP.partition_graph(jg, 2, capacities=dataclasses.replace(
        caps_j, xp_pairs=n_xp)))
    with pytest.raises(ValueError, match="pairs exceed"):
        TP.partition_graph(tg, 2, capacities=dataclasses.replace(caps_t,
                                                                 xp_pairs=2))


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_dynamic_expanded_plan_matches_jax(builder, request):
    """Dynamic x partitioned x width past 128: 2 shards of 160 nodes."""
    if builder == "numpy":
        request.getfixturevalue("numpy_only")
    S, N = 2, 160
    caps = []
    for m, P_ in ((TG, TP), (JG, JP)):
        c = P_.capacities_of(P_.partition_graph(
            m.batch_fully_connected(S, N, max_nodes=S * N), 2))
        caps.append(dataclasses.replace(c, xp_pairs=300))
    tg, jg = _dyn_graphs(0, S=S, N=N, radius=80.0)
    got = TP.partition_batch(tg, 1, 2, caps[0])
    assert got.xp_pair_dst is not None and got.xp_pair_dst.shape == (2, 300)
    assert_same_plan(got, JP.partition_batch(jg, 1, 2, caps[1]))


def test_shard_takes_one_rank_block():
    plan = TP.partition_graph(STATIC["radius_4x32_8"][0](TG), 8)
    sp = plan.shard(3)
    for k in ("send_idx", "remote_ell_slot", "remote_ell_srcg",
              "remote_ell_mask", "ell_src", "ell_mask"):
        np.testing.assert_array_equal(getattr(sp, k).numpy(),
                                      getattr(plan, k)[3], err_msg=k)
    assert (sp.deltas, sp.delta_rows, sp.nodes_per_shard) == (
        plan.deltas, plan.delta_rows, plan.nodes_per_shard)
    assert sp.square and not sp.expanded
    moved = sp.apply(lambda t: t.to(torch.float64))
    assert moved.ell_src.dtype == torch.float64 and moved.deltas == sp.deltas
    # the partition plan moves with its graph
    g = dataclasses.replace(STATIC["radius_4x32_8"][0](TG), partition_plan=sp)
    assert g.apply(lambda t: t.clone()).partition_plan.send_idx is not sp.send_idx
