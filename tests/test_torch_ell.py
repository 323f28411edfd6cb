"""The masked max (``ops/ell.py``) and the mean over the tile-pair plan
(``bsp.bsp_mean``) against the JAX package on CPU, the Pallas kernels in
interpret mode as tests/test_pallas_ell.py and tests/test_pallas_bsp.py run
them.

Graphs: three scenes in 48 node slots with duplicate edges, rows without an
in-edge and padded slots (ELL width 8, plan tile 16), and a radius graph of
40 robots (in-degree up to 39, ELL width 40). Tolerances: the max is
compared bit for bit (a max does not round, and both sides compare in
f32); its gradient 1e-6 (sums of the same split shares in another order);
the mean 1e-5 and its gradients 1e-4, as tests/test_pallas_bsp.py holds
the JAX mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import dispatch as jdispatch
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu.ops import pallas_ell as PE
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.ops import bsp, dispatch, ell


def _scenes():
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5],   # 1->0 twice, 5->4 three times
                  [0, 0, 0, 1, 2, 4, 4, 4]])  # nodes 3 and 5 have no in-edge
    return [a, jg.radius_edges(7, 2), np.zeros((2, 0), np.int64)], [6, 7, 3]


def _small():
    edges, sizes = _scenes()
    return (jg.build_graph_batch(edges, sizes, 48, 40),
            tg.build_graph_batch(edges, sizes, 48, 40))


def _radius():
    e = jg.radius_edges(40, 30)
    return (jg.build_graph_batch([e], [40], 64, e.shape[1]),
            tg.build_graph_batch([e], [40], 64, e.shape[1]))


GRAPHS = {"small": _small, "radius": _radius}


def _rand(V, D, seed, ties=False):
    x = np.random.default_rng(seed).normal(size=(V, D)).astype(np.float32)
    return np.round(x * 2) if ties else x  # many equal maxima with ties


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_max_matches_pallas_interpret_bit_for_bit(graph, dtype):
    jgb, tgb = GRAPHS[graph]()
    v = _rand(jgb.max_nodes, 40, seed=1)
    want = np.asarray(PE.ell_max(jnp.asarray(v, dtype), jgb.ell_src,
                                 jgb.ell_mask).astype(jnp.float32))
    got = ell.ell_max(torch.from_numpy(v).to(getattr(torch, dtype)),
                      tgb.ell_src, tgb.ell_mask)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy(), want)
    empty = ~tgb.ell_mask.any(dim=1)
    assert empty.any() and bool((got[empty] == 0).all())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_ell_max_grads_match_jax(graph):
    """Ties among a row's valid slots (and duplicate edges, which always
    tie) split the cotangent equally, as _ell_max_bwd does."""
    jgb, tgb = GRAPHS[graph]()
    V = jgb.max_nodes
    v, ct = _rand(V, 24, seed=2, ties=True), _rand(V, 24, seed=3)
    want = jax.grad(lambda x: jnp.sum(
        PE.ell_max(x, jgb.ell_src, jgb.ell_mask) * ct))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_()
    (ell.ell_max(vt, tgb.ell_src, tgb.ell_mask)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the plain version under torch's autograd (amax splits ties equally)
    # gives the same gradient
    vp = torch.from_numpy(v).requires_grad_()
    (ell.masked_max_reference(vp, tgb.ell_src, tgb.ell_mask)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(vp.grad.numpy(), vt.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ell_max_propagates_nan_as_jax():
    """A NaN among a row's valid values gives NaN (jnp.maximum's rule); a
    NaN only at masked or other rows' slots changes nothing."""
    jgb, tgb = _small()
    v = _rand(jgb.max_nodes, 16, seed=4)
    v[3, 5] = np.nan  # node 3 feeds node 1 only
    want = np.asarray(PE.ell_max(v, jgb.ell_src, jgb.ell_mask))
    got = ell.ell_max(torch.from_numpy(v), tgb.ell_src, tgb.ell_mask).numpy()
    assert np.isnan(want[1, 5]) and np.isnan(got[1, 5])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_ell_max_takes_any_width_on_cpu():
    """No 128-slot cap: an ELL width of 200 (one row of 200 in-edges)."""
    wide = np.stack([np.arange(200) % 12, np.zeros(200, np.int64)])
    g = tg.build_graph_batch([wide], [12], 16, 200)
    assert g.ell_src.shape[1] == 200
    v = torch.from_numpy(_rand(16, 8, seed=5))
    out = ell.ell_max(v, g.ell_src, g.ell_mask)
    torch.testing.assert_close(out[0], v[:12].amax(dim=0), rtol=0, atol=0)
    assert bool((out[1:] == 0).all())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bsp_mean_matches_jax(graph):
    """Values and gradient against JAX bsp_mean (its SpMM kernel and the
    _bsp_spmm vjp); the port's Function runs no SDDMM, since mask / deg needs
    no gradient."""
    jgb, tgb = GRAPHS[graph]()
    assert JB.supports(jgb) and bsp.supports(tgb)
    V = jgb.max_nodes
    v, ct = _rand(V, 32, seed=6), _rand(V, 32, seed=7)
    want = JB.bsp_mean(v, jgb)
    want_g = jax.grad(lambda x: jnp.sum(JB.bsp_mean(x, jgb) * ct))(v)
    vt = torch.from_numpy(v).requires_grad_()
    calls = []
    sddmm = bsp.sddmm
    bsp.sddmm = lambda *a, **k: calls.append(1) or sddmm(*a, **k)
    try:
        got = bsp.bsp_mean(vt, tgb)
        (got * torch.from_numpy(ct)).sum().backward()
    finally:
        bsp.sddmm = sddmm
    assert not calls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)


def test_weighted_aggregate_grads_match_jax():
    """Both gradients of the SpMM Function against _bsp_spmm's vjp:
    dweights through the SDDMM, dvalues through the transposed SpMM."""
    jgb, tgb = _small()
    V, deg = tgb.ell_src.shape
    rng = np.random.default_rng(8)
    w = np.where(tgb.ell_mask.numpy(), rng.normal(size=(V, deg)),
                 0.0).astype(np.float32)
    v, ct = _rand(V, 32, seed=9), _rand(V, 32, seed=10)
    want = jax.grad(lambda w, x: jnp.sum(
        JB.bsp_weighted_aggregate(w, x, jgb) * ct), argnums=(0, 1))(w, v)
    wt, vt = (torch.from_numpy(x).requires_grad_() for x in (w, v))
    (bsp.bsp_weighted_aggregate(wt, vt, tgb)
     * torch.from_numpy(ct)).sum().backward()
    mask = tgb.ell_mask.numpy()  # JAX's SDDMM fills masked slots too
    np.testing.assert_allclose(wt.grad.numpy()[mask], np.asarray(want[0])[mask],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


def test_dispatch_routes_mean_and_max_as_jax():
    jgb, tgb = _small()
    v = _rand(jgb.max_nodes, 24, seed=11)
    jops, tops = jdispatch.get_ops("pallas"), dispatch.get_ops("pallas")
    vt = torch.from_numpy(v)
    bsp.reset_launches()
    np.testing.assert_allclose(tops.ell_mean(vt, tgb).numpy(),
                               np.asarray(jops.ell_mean(v, jgb)), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(tops.ell_max(vt, tgb).numpy(),
                          np.asarray(jops.ell_max(v, jgb)))
    assert set(bsp.launch_counts().values()) == {0}  # CPU: no launches
