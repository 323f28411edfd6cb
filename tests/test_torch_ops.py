"""The port's plain ops against the JAX reference ops, and the port's fused
attention (on CPU: its plain version) against the JAX Pallas kernel run in
interpret mode, as tests/test_pallas_bsp.py runs it.

Tolerances: f32 1e-5 (the same math, sums in another order); bf16 values
2e-2 (the TPU kernel rounds the unnormalized attention weights to bf16
before its value product, pallas_bsp.py:758; the port sums in f32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu.ops import reference as JR
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.ops import _build, bsp, dispatch
from mrp_gnn_tpu_torch.ops import reference as TR

TOL = dict(rtol=1e-5, atol=1e-5)


def _scenes():
    """Three scenes, 16 nodes: duplicate edges and edge-less nodes."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5],   # 1->0 twice, 5->4 three times
                  [0, 0, 0, 1, 2, 4, 4, 4]])  # nodes 3 and 5 have no in-edge
    b = jg.radius_edges(7, 2)
    c = np.zeros((2, 0), np.int64)            # a scene with no edges at all
    return [a, b, c], [6, 7, 3]


def _graphs(max_nodes=32, max_edges=40):
    edges, sizes = _scenes()
    return (jg.build_graph_batch(edges, sizes, max_nodes, max_edges),
            tg.build_graph_batch(edges, sizes, max_nodes, max_edges))


def _block_graphs():
    e = jg.radius_edges(8, 2)
    return (jg.batch_homogeneous(3, 8, e, max_nodes=32),
            tg.batch_homogeneous(3, 8, e, max_nodes=32))


def _rand(V, *dims, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(V, d)).astype(np.float32) for d in dims]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_edge_list_ops_match_jax():
    jgb, tgb = _graphs()
    V = jgb.max_nodes
    q, k, v = _rand(V, 16, 16, 24)
    qt, kt, vt = _t(q, k, v)
    s, d, m = jgb.edge_src, jgb.edge_dst, jgb.edge_mask
    ts, td, tm = tgb.edge_src, tgb.edge_dst, tgb.edge_mask
    want_logits = JR.sddmm(q, k, s, d, m)
    got_logits = TR.sddmm(qt, kt, ts, td, tm)
    _close(got_logits, want_logits)
    want_a = JR.segment_softmax(want_logits, d, V, m)
    got_a = TR.segment_softmax(got_logits, td, V, tm)
    _close(got_a, want_a)
    _close(TR.spmm(got_a, vt, ts, td, V, tm), JR.spmm(want_a, v, s, d, V, m))
    _close(TR.segment_mean_agg(vt, ts, td, V, tm),
           JR.segment_mean_agg(v, s, d, V, m))
    _close(TR.segment_max_agg(vt, ts, td, V, tm),
           JR.segment_max_agg(v, s, d, V, m))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_ell_ops_match_jax(mode):
    jgb, tgb = _graphs()
    V = jgb.max_nodes
    q, k, v = _rand(V, 16, 16, 24, seed=1)
    qt, kt, vt = _t(q, k, v)
    want_l = JR.ell_sddmm(q, k, jgb.ell_src, jgb.ell_mask)
    got_l = TR.ell_sddmm(qt, kt, tgb.ell_src, tgb.ell_mask)
    _close(got_l, want_l)
    want_a = JR.ell_softmax(want_l, jgb.ell_mask)
    got_a = TR.ell_softmax(got_l, tgb.ell_mask)
    _close(got_a, want_a)
    w_j = want_a if mode == "sum" else None
    w_t = got_a if mode == "sum" else None
    _close(TR.ell_aggregate(w_t, vt, tgb.ell_src, tgb.ell_mask, mode),
           JR.ell_aggregate(w_j, v, jgb.ell_src, jgb.ell_mask, mode))


def test_block_ops_match_jax():
    jgb, tgb = _block_graphs()
    q, k, v = _rand(jgb.max_nodes, 16, 16, 24, seed=2)
    qt, kt, vt = _t(q, k, v)
    _close(TR.block_fused_attention(qt, kt, vt, tgb),
           JR.block_fused_attention(q, k, v, jgb))
    _close(TR.block_mean_agg(vt, tgb), JR.block_mean_agg(v, jgb))
    _close(TR.block_max_agg(vt, tgb), JR.block_max_agg(v, jgb))


def test_softmax_gradients_match_jax():
    """The detached row max and the all-masked guards give the same
    gradients as jax's stop_gradient form."""
    jgb, tgb = _graphs()
    (x,) = _rand(jgb.max_nodes, jgb.max_degree, seed=3)
    g_j = jax.grad(lambda x: jnp.sum(JR.ell_softmax(x, jgb.ell_mask) ** 3))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (TR.ell_softmax(xt, tgb.ell_mask) ** 3).sum().backward()
    _close(xt.grad, g_j)


def _kernel_graphs(tile):
    """ELL graph with a tile-pair plan at the given tile (scene_stride 0):
    empty rows, duplicate edges and padded nodes."""
    edges, sizes = _scenes()  # 16 nodes
    V = {8: 24, 16: 48}[tile]  # the largest plan tile dividing V
    jgb = jg.build_graph_batch(edges, sizes, V, 40)
    tgb = tg.build_graph_batch(edges, sizes, V, 40)
    assert jgb.bsp_tile == tile and JB.supports(jgb) and bsp.supports(tgb)
    assert tgb.scene_stride == 0
    return jgb, tgb


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_matches_pallas_interpret(tile, dtype):
    jgb, tgb = _kernel_graphs(tile)
    q, k, v = _rand(jgb.max_nodes, 16, 16, 256, seed=4)
    want = JB.bsp_attention_fused(q, k, jnp.asarray(v, dtype), jgb)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    got = bsp.bsp_attention_fused(*_t(q, k), vt, tgb)
    assert got.dtype == vt.dtype
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got.float(), np.asarray(want, np.float32), tol)
    empty = ~tgb.ell_mask.any(dim=1)
    assert empty.any() and bool((got[empty] == 0).all())


def test_fused_attention_matches_plain_composition():
    """The fused form equals the ELL composition the "xla" backend runs."""
    _, tgb = _kernel_graphs(16)
    q, k, v = _t(*_rand(tgb.max_nodes, 8, 8, 40, seed=5))
    _close(bsp.bsp_attention_fused(q, k, v, tgb),
           dispatch._ell_attention_plain(q, k, v, tgb).numpy())
    _close(bsp.bsp_attention_fused_reference(q, k, v, tgb),
           dispatch._ell_attention_plain(q, k, v, tgb).numpy())


def test_cpu_tensors_take_the_plain_version():
    _, tgb = _kernel_graphs(16)
    q, k, v = _t(*_rand(tgb.max_nodes, 8, 8, 40, seed=6))
    before = bsp.fused_attention.launches
    out = bsp.fused_attention(q / math.sqrt(8), k, v, tgb.ell_src, tgb.ell_mask)
    assert bsp.fused_attention.launches == before  # no kernel on the CPU
    _close(out, bsp.fused_attention_reference(
        q / math.sqrt(8), k, v, tgb.ell_src, tgb.ell_mask).numpy())


def test_non_cpu_tensors_never_fall_back():
    _, tgb = _kernel_graphs(16)
    args = [t.to("meta") for t in _t(*_rand(tgb.max_nodes, 8, 8, 40))]
    with pytest.raises(RuntimeError, match="no fused attention kernel"):
        bsp.fused_attention(*args, tgb.ell_src.to("meta"),
                            tgb.ell_mask.to("meta"))


def test_broken_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("bsp_fused_attention")
    assert not (tmp_path / "build").exists()


def _plan(jgb):
    return (jgb.bsp_pair_dst, jgb.bsp_pair_src, jgb.bsp_pair_first,
            jgb.bsp_pair_last)


def _plan_t(jgb):
    return (jgb.bsp_pair_dst_t, jgb.bsp_pair_src_t, jgb.bsp_pair_first_t,
            jgb.bsp_pair_last_t)


def _slot_weights(tgb, seed):
    """Random [V, deg] f32 weights, 0 on masked slots (as the JAX kernels,
    which do not read the mask, get them from a masked softmax)."""
    (w,) = _rand(tgb.max_nodes, tgb.ell_src.shape[1], seed=seed)
    return np.where(tgb.ell_mask.numpy(), w, 0.0).astype(np.float32)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "bfloat16")])
def test_sddmm_matches_pallas_interpret(dtypes):
    """Single form against _sddmm_forward, on valid slots; masked slots
    are 0 in the port. Mixed f32 x bf16 as the backward's g x values."""
    jgb, tgb = _kernel_graphs(16)
    a, b = _rand(jgb.max_nodes, 256, 256, seed=8)
    ja, jb = (jnp.asarray(x, dt) for x, dt in zip((a, b), dtypes))
    want = np.asarray(JB._sddmm_forward(ja, jb, jgb.ell_src, *_plan(jgb),
                                        jgb.bsp_tile, True))
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dt))
              for x, dt in zip((a, b), dtypes))
    got = bsp.sddmm(ta, tb, tgb.ell_src, tgb.ell_mask)
    assert got.dtype == torch.float32
    mask = tgb.ell_mask.numpy()
    # bf16 products are exact in f32 on both sides: f32 tolerance holds
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-5,
                               atol=1e-4)
    assert bool((got[~tgb.ell_mask] == 0).all())


@pytest.mark.parametrize("tile", [8, 16])
def test_dual_sddmm_matches_pallas_interpret(tile):
    """Dual form against _sddmm2_forward (its kernel runs at this width:
    the combined blocks pass its VMEM gate), on valid slots."""
    jgb, tgb = _kernel_graphs(tile)
    q, k, g, v = _rand(jgb.max_nodes, 16, 16, 256, 256, seed=9)
    w1, w2 = JB._sddmm2_forward(q, k, g, jnp.asarray(v, jnp.bfloat16),
                                jgb.ell_src, *_plan(jgb), tile, True)
    got1, got2 = bsp.sddmm(*_t(q, k), tgb.ell_src, tgb.ell_mask,
                           torch.from_numpy(g),
                           torch.from_numpy(v).to(torch.bfloat16))
    mask = tgb.ell_mask.numpy()
    _close(got1[tgb.ell_mask], np.asarray(w1)[mask])
    np.testing.assert_allclose(got2.numpy()[mask], np.asarray(w2)[mask],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_matches_pallas_interpret(dtype):
    jgb, tgb = _kernel_graphs(16)
    w = _slot_weights(tgb, 10)
    (x,) = _rand(jgb.max_nodes, 256, seed=11)
    want = JB._spmm_forward(w, jnp.asarray(x, dtype), jgb.ell_src,
                            *_plan(jgb), jgb.bsp_tile, True)
    got = bsp.spmm(torch.from_numpy(w), torch.from_numpy(x).to(
        getattr(torch, dtype)), tgb.ell_src, tgb.ell_mask)
    assert got.dtype == getattr(torch, dtype)
    # bf16: the TPU kernel rounds the weights to bf16 before its product
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got.float(), np.asarray(want, np.float32), tol)
    empty = ~tgb.ell_mask.any(dim=1)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_t_matches_pallas_interpret(dtype):
    """Transposed sum against _spmm_t_forward over the source-major plan,
    into an output of another type (the backward's dvalues)."""
    jgb, tgb = _kernel_graphs(16)
    w = _slot_weights(tgb, 12)
    (x,) = _rand(jgb.max_nodes, 256, seed=13)
    V = jgb.max_nodes
    want = JB._spmm_t_forward(w, x, jgb.ell_src, *_plan_t(jgb), jgb.bsp_tile,
                              True, out_dtype=jnp.dtype(dtype), out_rows=V)
    got = bsp.spmm_t(torch.from_numpy(w), torch.from_numpy(x), tgb.ell_src,
                     tgb.ell_mask, V, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (V, 256)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got.float(), np.asarray(want, np.float32), tol)
    unnamed = torch.ones(V, dtype=torch.bool)
    unnamed[tgb.ell_src[tgb.ell_mask].long()] = False
    assert unnamed.any() and bool((got[unnamed] == 0).all())


def test_source_view_drives_the_transposed_sum():
    """The kernel's source-major view, walked as the kernel walks it, gives
    the plain transposed sum; within a source the slots keep (v, j) order."""
    _, tgb = _kernel_graphs(16)
    V, deg = tgb.ell_src.shape
    w = torch.from_numpy(_slot_weights(tgb, 14))
    (x,) = _t(*_rand(V, 24, seed=15))
    offsets, slots = bsp.source_view(tgb.ell_src, tgb.ell_mask, V)
    assert offsets.dtype == slots.dtype == torch.int32
    assert int(offsets[-1]) == int(tgb.ell_mask.sum())
    out = torch.zeros(V, 24)
    for s in range(V):
        run = slots[offsets[s]:offsets[s + 1]].long()
        assert bool((run[1:] > run[:-1]).all())
        assert bool((tgb.ell_src.flatten()[run] == s).all())
        for slot in run.tolist():
            out[s] += w.flatten()[slot] * x[slot // deg]
    _close(out, bsp.spmm_t_reference(w, x, tgb.ell_src, tgb.ell_mask,
                                     V).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_grads_match_jax(dtype):
    """FusedAttention's backward (on CPU: the kernels' plain versions)
    against jax.grad of the Pallas bsp_attention_fused in interpret mode,
    whose custom vjp runs _sddmm2, _spmm_t and _spmm. Tolerance bf16 2e-2:
    the cotangent and values are bf16 and the TPU kernels round their
    weights to bf16 before the products; the port sums in f32."""
    jgb, tgb = _kernel_graphs(16)
    V = jgb.max_nodes
    q, k, v, ct = _rand(V, 16, 16, 256, 256, seed=16)

    def f(q, k, v):
        out = JB.bsp_attention_fused(q, k, v, jgb).astype(jnp.float32)
        return jnp.sum(out * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, jnp.asarray(v, dtype))
    qt, kt = (t.requires_grad_() for t in _t(q, k))
    vt = torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_()
    (bsp.bsp_attention_fused(qt, kt, vt, tgb).float()
     * torch.from_numpy(ct)).sum().backward()
    assert vt.grad.dtype == vt.dtype
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        _close(got.float(), np.asarray(w, np.float32), tol)


def test_fused_attention_grads_match_autograd_of_plain():
    """The Function's gradients equal torch autograd through the plain
    version, with a non-contiguous cotangent (as models/fusion.py gives)."""
    _, tgb = _kernel_graphs(8)
    q, k, v = (t.requires_grad_() for t in _t(*_rand(tgb.max_nodes, 8, 8, 40,
                                                       seed=17)))
    (ct,) = _t(*_rand(40, tgb.max_nodes, seed=18))
    grads = []
    for fn in (bsp.bsp_attention_fused, bsp.bsp_attention_fused_reference):
        (fn(q, k, v, tgb) * ct.t()).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
        for t in (q, k, v):
            t.grad = None
    for got, want in zip(*grads):
        _close(got, want.numpy())


def test_dispatch_routing():
    assert dispatch.resolve_impl("auto", "cpu") == "xla"
    assert dispatch.resolve_impl("auto", torch.device("cuda", 0)) == "pallas"
    assert dispatch.resolve_impl("auto") == "xla"
    assert dispatch.get_ops("auto", "cuda").impl == "pallas"
    with pytest.raises(ValueError, match="unknown ops impl"):
        dispatch.get_ops("triton")
    _, tgb = _kernel_graphs(16)
    (v,) = _t(*_rand(tgb.max_nodes, 24))
    ops = dispatch.get_ops("pallas")
    plain = dispatch.get_ops("xla")
    for name in ("ell_mean", "ell_max"):  # plain ops on CPU tensors
        _close(getattr(ops, name)(v, tgb),
               getattr(plain, name)(v, tgb).numpy())
