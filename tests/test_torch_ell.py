"""The ELL kernels' entries (``ops/ell.py``: masked max, SpMM, SDDMM,
softmax and their attention) and the mean over the tile-pair plan
(``bsp.bsp_mean``) against the JAX package on CPU, the Pallas kernels in
interpret mode as tests/test_pallas_ell.py and tests/test_pallas_bsp.py run
them.

Graphs: three scenes in 48 node slots with duplicate edges, rows without an
in-edge and padded slots (ELL width 8, plan tile 16), and a radius graph of
40 robots (in-degree up to 39, ELL width 40). Tolerances: the max is
compared bit for bit (a max does not round, and both sides compare in
f32); its gradient 1e-6 (sums of the same split shares in another order);
the mean 1e-5 and its gradients 1e-4, as tests/test_pallas_bsp.py holds
the JAX mean. The SpMM, SDDMM, softmax and attention are held on the small
graph against pallas_ell in interpret mode (its kernels unroll over the
width, so wider graphs take minutes there), and at ELL width 136 against
the JAX XLA oracles, which compute the same functions: f32 values and
gradients to 1e-5 of each tensor's largest element; with bf16 values 2^-7
(one bf16 ulp), and 2^-6 for the value gradient, which both sides sum in
bf16 (a scatter-add of bf16-rounded contributions) in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import dispatch as jdispatch
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu.ops import pallas_ell as PE
from mrp_gnn_tpu.ops import reference as JR
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


def _wide():
    """ELL width 136: one row of 130 in-edges (duplicates among them), rows
    without an in-edge and padded slots."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    wide = np.stack([np.arange(130) % 12, np.zeros(130, np.int64)])
    args = ([a, wide], [6, 12], 24, 138)
    return jg.build_graph_batch(*args), tg.build_graph_batch(*args)


def _ell_case(name, jgb, tgb, dtype, pallas):
    """(jax function, torch function, numpy operands, the operands' dtypes)
    of one ELL entry; ``pallas`` picks pallas_ell over the XLA oracles."""
    V, deg = tgb.ell_src.shape
    rng = np.random.default_rng(12)
    jsrc, jmask = jgb.ell_src, jgb.ell_mask
    tsrc, tmask = tgb.ell_src, tgb.ell_mask
    w = rng.normal(size=(V, deg)).astype(np.float32)
    q, k = (rng.normal(size=(V, 16)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(V, 24)).astype(np.float32)
    jax_softmax = PE.ell_softmax if pallas else JR.ell_softmax
    if name == "spmm":
        jfn = ((lambda w, v: PE.ell_spmm(w, v, jsrc, jmask)) if pallas else
               (lambda w, v: JR.ell_aggregate(jnp.where(jmask, w, 0.0), v,
                                              jsrc, jmask, "sum")))
        return (jfn, lambda w, v: ell.ell_spmm(w, v, tsrc, tmask), (w, v),
                ("float32", dtype))
    if name == "sddmm":
        jfn = PE.ell_sddmm if pallas else JR.ell_sddmm
        return (lambda q, k: jfn(q.astype(jnp.float32), k.astype(jnp.float32),
                                 jsrc, jmask),
                lambda q, k: ell.ell_sddmm(q, k, tsrc, tmask), (q, k),
                (dtype, dtype))
    if name == "softmax":
        x = rng.normal(size=(V, deg)).astype(np.float32) * 4
        return (lambda x: jax_softmax(x.astype(jnp.float32), jmask),
                lambda x: ell.ell_softmax(x, tmask), (x,), (dtype,))
    if pallas:
        jfn = jdispatch._compose_ell_attention(PE.ell_sddmm, PE.ell_softmax,
                                               PE.ell_spmm)
    else:
        jfn = jdispatch._compose_ell_attention(
            JR.ell_sddmm, JR.ell_softmax,
            lambda a, v, s, m: JR.ell_aggregate(a, v, s, m, "sum"))
    return (lambda q, k, v: jfn(q, k, v, jgb),
            lambda q, k, v: ell.ell_attention(q, k, v, tgb), (q, k, v),
            ("float32", "float32", dtype))


def _check_ell_case(name, jgb, tgb, dtype, pallas):
    jfn, tfn, args, dtypes = _ell_case(name, jgb, tgb, dtype, pallas)
    jargs = [jnp.asarray(a).astype(d) for a, d in zip(args, dtypes)]
    want = jfn(*jargs)
    ct = np.random.default_rng(13).normal(size=want.shape).astype(np.float32)
    want_grads = jax.grad(lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) * ct),
                          argnums=tuple(range(len(args))))(*jargs)
    targs = [torch.from_numpy(a).to(getattr(torch, d)).requires_grad_()
             for a, d in zip(args, dtypes)]
    bsp.reset_launches()
    got = tfn(*targs)
    (got.float() * torch.from_numpy(ct)).sum().backward()
    assert set(bsp.launch_counts().values()) == {0}  # CPU: plain versions
    bf16 = dtype == "bfloat16"
    out_bf16 = bf16 and name in ("spmm", "attention") and pallas
    assert got.dtype == (torch.bfloat16 if bf16 and name in ("spmm", "attention")
                         else torch.float32)
    want = np.asarray(want.astype(jnp.float32))
    rel = 2.0 ** -7 if out_bf16 else 1e-5
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        assert t.grad.dtype == t.dtype
        w = np.asarray(w.astype(jnp.float32))
        rel = (1e-5 if t.dtype == torch.float32 and not bf16 else
               2.0 ** -6 if t.dtype == torch.bfloat16 and name != "softmax"
               else 2.0 ** -7)
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(),
                                   err_msg=f"gradient {i}")
    empty = ~tgb.ell_mask.any(dim=1)
    if name in ("spmm", "attention", "softmax"):
        assert empty.any() and bool((got[empty] == 0).all())


ELL_FNS = ["spmm", "sddmm", "softmax", "attention"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ELL_FNS)
def test_ell_kernels_match_pallas_interpret(name, dtype):
    """Values and gradients of ell_spmm, ell_sddmm, ell_softmax and their
    attention against pallas_ell's on the small graph (duplicate edges,
    rows without an in-edge, padded slots; ELL width 8)."""
    _check_ell_case(name, *_small(), dtype, pallas=True)


@pytest.mark.parametrize("name", ELL_FNS)
def test_ell_kernels_past_128_match_the_xla_oracles(name):
    """Past ELL width 128, where the kernels walk a row's slots in two
    chunks, against the JAX XLA functions of the same semantics."""
    jgb, tgb = _wide()
    assert tgb.ell_src.shape[1] > 128 and not bsp.supports(tgb)
    _check_ell_case(name, jgb, tgb, "float32", pallas=False)


def test_ell_attention_swap_leaves_the_routing_alone():
    """with_ell_kernels puts the three-kernel composition in ell_attention
    whatever plan the batch has; dispatch still routes as JAX's does."""
    jgb, tgb = _small()
    ops = dispatch.get_ops("pallas")
    swapped = ell.with_ell_kernels(ops)
    assert swapped.ell_attention is ell.ell_attention
    assert ops.ell_attention is not ell.ell_attention
    rng = np.random.default_rng(14)
    q, k = (torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(48, 32)).astype(np.float32))
    torch.testing.assert_close(swapped.ell_attention(q, k, v, tgb),
                               ops.ell_attention(q, k, v, tgb),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ell.ell_attention_reference(q, k, v, tgb),
                               ell.ell_attention(q, k, v, tgb), rtol=0, atol=0)
