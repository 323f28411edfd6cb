"""The high-degree path (ELL width past 128, a row-expanded plan) against the
JAX package on CPU, the Pallas kernels in interpret mode as
tests/test_pallas_bsp.py runs them: the parts kernel's plain version, the
tiled forward's plain version (the softmax of each node over its node-view
slots) and the form rule that ExpandedFusedAttention follows, the one-pass
and two-sweep expanded attention with their gradients, the expanded mean,
the combine and the dispatch.

Graphs: a fully connected team of 130 robots in 256 node slots (in-degree
129, ELL width 136, expanded to 2 rows of 72) and mixed teams of 140, 30
and 6 robots (only the first past the cap). Tolerances: the parts and the
mean 1e-5 (f32, sums in another order); attention values 1e-4 and
gradients 1e-3, as the JAX package's own expanded tests hold its kernels
against the XLA oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import dispatch as jdispatch
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.ops import bsp, dispatch, ell

VALUES = dict(rtol=1e-4, atol=1e-4)
GRADS = dict(rtol=1e-3, atol=1e-3)
TIGHT = dict(rtol=1e-5, atol=1e-5)


def _team(n=130, V=256):
    e = jg.fully_connected_edges(n)
    return (jg.batch_homogeneous(1, n, e, max_nodes=V),
            tg.batch_homogeneous(1, n, e, max_nodes=V))


def _mixed():
    sizes = [140, 30, 6]
    edges = [jg.fully_connected_edges(n) for n in sizes]
    caps = dict(max_nodes=256, max_edges=sum(n * (n - 1) for n in sizes))
    return (jg.build_graph_batch(edges, sizes, **caps),
            tg.build_graph_batch(edges, sizes, **caps))


GRAPHS = {"team": _team, "mixed": _mixed}


def _rand(V, *dims, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(V, d)).astype(np.float32) for d in dims]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_graphs_take_the_expanded_path():
    for make in GRAPHS.values():
        jgb, tgb = make()
        assert JB.supports_expanded(jgb) and not JB.supports(jgb)
        assert bsp.supports_expanded(tgb) and not bsp.supports(tgb)
        assert tgb.scene_stride == 0 and tgb.ell_src.shape[1] > 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_parts_match_pallas_interpret(dtype):
    """The parts kernel's plain version against _fused_parts_forward on every
    expanded row, empty ones included (m = -1e30 exactly, l = 0, acc = 0).
    bf16 2e-2: the TPU kernel rounds its weights to bf16 before the value
    product (pallas_bsp.py:1226); the port sums in f32."""
    jgb, tgb = _team()
    xp = jgb.bsp_expanded
    q, k, v = _rand(jgb.max_nodes, 8, 8, 64, seed=1)
    q_x = np.repeat(q / np.sqrt(8), xp.rows, axis=0).astype(np.float32)
    src_x, mask_x = JB.expand_ell_view(jgb.ell_src, jgb.ell_mask, xp.rows,
                                       xp.width)
    acc, m, l = JB._fused_parts_forward(
        q_x, k, jnp.asarray(v, dtype), src_x, mask_x.astype(jnp.int32),
        xp.pair_dst, xp.pair_src, xp.pair_first, xp.pair_last, jgb.bsp_tile,
        True)
    tsrc, tmask = bsp.expand_ell_view(tgb.ell_src, tgb.ell_mask, xp.rows,
                                      xp.width)
    assert np.array_equal(tsrc.numpy(), np.asarray(src_x))
    assert np.array_equal(tmask.numpy(), np.asarray(mask_x))
    got = bsp.fused_attention_parts(
        torch.from_numpy(q_x), torch.from_numpy(k),
        torch.from_numpy(v).to(getattr(torch, dtype)), tsrc, tmask)
    assert all(t.dtype == torch.float32 for t in got)
    tol = TIGHT if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got[0], acc, tol)
    _close(got[1], np.asarray(m)[:, 0], TIGHT)
    _close(got[2], np.asarray(l)[:, 0], TIGHT)
    empty = ~tmask.any(dim=1)
    assert empty.any()
    assert np.array_equal(got[1][empty].numpy(), np.asarray(m)[empty.numpy(), 0])
    assert bool((got[1][empty] == -1e30).all() and (got[2][empty] == 0).all()
                and (got[0][empty] == 0).all())


def test_xp_combine_matches_jax():
    """Folding R triples per node, rows without a valid slot included."""
    rng = np.random.default_rng(2)
    V, R, D = 6, 3, 5
    acc = rng.normal(size=(V * R, D)).astype(np.float32)
    m = rng.normal(size=(V * R,)).astype(np.float32)
    l = rng.uniform(0.5, 3, size=(V * R,)).astype(np.float32)
    empty = np.array([1, 4, 5, 6, 7, 8])  # node 2 has no valid slot at all
    acc[empty], m[empty], l[empty] = 0.0, -1e30, 0.0
    want = JB._xp_combine(acc, np.repeat(m[:, None], 128, 1),
                          np.repeat(l[:, None], 128, 1), V, R, jnp.float32)
    got = bsp.xp_combine(*(torch.from_numpy(x) for x in (acc, m, l)), V, R,
                         torch.float32)
    _close(got, want, TIGHT)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["expanded_attention_fused",
                                  "expanded_attention"])
def test_expanded_attention_matches_jax(graph, name):
    """Values, and q/k/values gradients against jax.grad of the same JAX
    entry (the one-pass form's vjp runs _sddmm2, _spmm_t and _spmm on the
    expanded view); padded node slots give exactly 0."""
    jgb, tgb = GRAPHS[graph]()
    V = jgb.max_nodes
    q, k, v, ct = _rand(V, 8, 8, 64, 64, seed=3)
    jfn = getattr(JB, name)
    want = jfn(q, k, v, jgb)
    want_g = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, jgb) * ct),
                      argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = getattr(bsp, name)(qt, kt, vt, tgb)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got, want, VALUES)
    assert bool((got[~tgb.node_mask] == 0).all())
    for t, w in zip((qt, kt, vt), want_g):
        _close(t.grad, w, GRADS)


def test_one_pass_and_two_sweep_forms_agree():
    """The two port forms against the plain attention over the whole ELL
    width, in f32 and with bf16 values. bf16: the one-pass form rounds each
    output once (one ulp); the two-sweep form also rounds each expanded
    row's partial sum before adding them (so 4e-3 absolute besides)."""
    _, tgb = _mixed()
    q, k, v = (torch.from_numpy(x) for x in _rand(tgb.max_nodes, 8, 8, 48,
                                                 seed=4))
    for dt in (torch.float32, torch.bfloat16):
        one = bsp.expanded_attention_fused(q, k, v.to(dt), tgb)
        two = bsp.expanded_attention(q, k, v.to(dt), tgb)
        plain = bsp.bsp_attention_fused_reference(q, k, v.to(dt), tgb)
        assert one.dtype == two.dtype == dt
        bf16 = dt == torch.bfloat16
        _close(one, plain.float().numpy(),
               dict(rtol=2 ** -7, atol=1e-6) if bf16 else TIGHT)
        _close(two, plain.float().numpy(),
               dict(rtol=2 ** -7, atol=4e-3) if bf16 else TIGHT)


def test_expanded_mean_matches_jax():
    jgb, tgb = _team()
    v, ct = _rand(jgb.max_nodes, 64, 64, seed=5)
    want = JB.expanded_mean(v, jgb)
    want_g = jax.grad(lambda v: jnp.sum(JB.expanded_mean(v, jgb) * ct))(v)
    vt = torch.from_numpy(v).requires_grad_()
    got = bsp.expanded_mean(vt, tgb)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got, want, TIGHT)
    _close(vt.grad, want_g, dict(rtol=1e-4, atol=1e-4))


def test_dispatch_routes_high_degree_without_launching_on_cpu():
    """The kernel backend routes attention and mean over the expanded view
    and max through the masked max, as the JAX Pallas backend does; CPU
    tensors run the plain versions and launch nothing."""
    jgb, tgb = _team()
    q, k, v = _rand(jgb.max_nodes, 8, 8, 64, seed=6)
    jops, tops = jdispatch.get_ops("pallas"), dispatch.get_ops("pallas")
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    bsp.reset_launches()
    _close(tops.ell_attention(qt, kt, vt, tgb),
           jops.ell_attention(q, k, v, jgb), VALUES)
    _close(tops.ell_mean(vt, tgb), jops.ell_mean(v, jgb), TIGHT)
    # (ell_max against the JAX kernel: tests/test_torch_ell.py, at a width
    # its interpret mode runs quickly)
    _close(tops.ell_max(vt, tgb), dispatch._ell_max_plain(vt, tgb).numpy(),
           dict(rtol=0, atol=0))
    assert set(bsp.launch_counts().values()) == {0}


def test_new_wrappers_never_fall_back():
    """On a non-CPU device the new wrappers launch their kernel or raise."""
    _, tgb = _team()
    x = torch.ones(tgb.max_nodes, 8, device="meta")
    src, mask = tgb.ell_src.to("meta"), tgb.ell_mask.to("meta")
    with pytest.raises(RuntimeError, match="no bsp_fused_parts kernel"):
        bsp.fused_attention_parts(x, x, x, src, mask)
    with pytest.raises(RuntimeError, match="no ell_max kernel"):
        ell.masked_max(x, src, mask)


def _crafted_wide():
    """Duplicate edges, empty rows and a degree-200 row in 128 node slots:
    ELL width 200, expanded to 2 rows of 104."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    wide = np.stack([np.arange(200) % 12, np.zeros(200, np.int64)])
    caps = dict(max_nodes=128, max_edges=256)
    return (jg.build_graph_batch([a, wide], [6, 12], **caps),
            tg.build_graph_batch([a, wide], [6, 12], **caps))


@pytest.mark.parametrize("graph", ["team", "crafted wide"])
def test_node_view_backward_matches_jax_to_1e5(graph):
    """ExpandedFusedAttention's backward runs on the node view [V, R * W] of
    the expanded lists (q_s and g as they are, no repeat), on graphs whose
    ELL width is not a multiple of the rows (so the view has pad columns):
    q, k and values gradients against jax.grad of JAX
    expanded_attention_fused (its _xp_fused_bwd on the expanded view, Pallas
    in interpret mode) to 1e-5 of each gradient's largest element."""
    jgb, tgb = _team() if graph == "team" else _crafted_wide()
    xp = tgb.bsp_expanded
    deg = int(tgb.ell_src.shape[1])
    assert xp.rows * xp.width > deg  # pad columns in the node view
    V = jgb.max_nodes
    q, k, v, ct = _rand(V, 8, 8, 64, 64, seed=7)
    want = jax.grad(lambda q, k, v: jnp.sum(
        JB.expanded_attention_fused(q, k, v, jgb) * ct), argnums=(0, 1, 2))(
            q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = bsp.expanded_attention_fused(*leaves, tgb)
    (out * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(leaves, want):
        w = np.asarray(w)
        _close(t.grad, w, dict(rtol=0, atol=1e-5 * float(np.abs(w).max())))


def test_node_view_is_a_reshape_of_the_expanded_view():
    """The backward's node view holds the ELL lists' slots in order, pad
    columns mask-False: each node's slots as the expanded view splits
    them."""
    _, tgb = _mixed()
    xp = tgb.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(tgb.ell_src, tgb.ell_mask, xp.rows,
                                        xp.width)
    V, deg = tgb.ell_src.shape
    src_n, mask_n = src_x.reshape(V, -1), mask_x.reshape(V, -1)
    assert torch.equal(mask_n[:, :deg], tgb.ell_mask)
    assert not mask_n[:, deg:].any()
    assert torch.equal(src_n[:, :deg][tgb.ell_mask], tgb.ell_src[tgb.ell_mask])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_pairs_match_the_host_pair_plan(graph):
    """bsp.tile_pairs (the pair set the tiled kernels flag on the device)
    against the numpy plan builder at the same tile, less the builder's
    diagonal fallbacks for tiles without a valid slot."""
    _, tgb = GRAPHS[graph]()
    src, mask = tgb.ell_src, tgb.ell_mask
    V = src.shape[0]
    pd, ps, _, _ = tg.build_bsp_pairs(src.numpy(), mask.numpy(), bsp.TILE)
    rows = np.arange(V)[:, None].repeat(src.shape[1], 1)[mask.numpy()]
    cols = src.numpy()[mask.numpy()]
    edged = {(int(r) // bsp.TILE, int(c) // bsp.TILE)
             for r, c in zip(rows, cols)}
    plan = {(int(d), int(s)) for d, s in zip(pd, ps)} & edged
    got = {tuple(p) for p in bsp.tile_pairs(src, mask).tolist()}
    assert got == plan == edged


def test_form_rule_on_the_paths_shapes():
    """The tiled forms run on the hideg backward's node view (V 512, deg
    192) and its expanded view (deg 96), the per-edge forms at the swarm's
    ELL width (32); a graph whose dense [V, Vs] weights pass 2^24 elements
    stays per-edge."""
    assert bsp.tiled_form(512, 512, 192)
    assert bsp.tiled_form(1024, 512, 96)
    assert not bsp.tiled_form(256, 256, 32)
    assert not bsp.tiled_form(512, 512, bsp.TILED_MIN_DEG - 1)
    assert bsp.tiled_form(4096, 4096, 64)
    assert not bsp.tiled_form(8192, 4096, 200)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_forward_plain_version_matches_jax(dtype):
    """The tiled forward's plain version (the softmax of each node over its
    node-view slots, bsp.expanded_forward_reference with tiled=True) against
    JAX expanded_attention_fused (_fused_parts_kernel in interpret mode and
    _xp_combine) on the crafted wide graph: empty rows, duplicate edges, a
    degree-200 row and padded nodes. f32: 1e-5 of the largest output. bf16:
    JAX rounds each unnormalised weight to bf16 before its value product
    (at most 2^-9 of a weight <= 1, so 2^-9 of the largest value in all),
    and each side rounds its output to bf16 once (2^-8 of the largest
    output each)."""
    jgb, tgb = _crafted_wide()
    xp = tgb.bsp_expanded
    V = jgb.max_nodes
    q, k, v = _rand(V, 8, 8, 64, seed=9)
    want = np.asarray(JB.expanded_attention_fused(
        q, k, jnp.asarray(v, dtype), jgb).astype(jnp.float32))
    q_s, kf = bsp._scaled(torch.from_numpy(q), torch.from_numpy(k))
    src_x, mask_x = bsp.expand_ell_view(tgb.ell_src, tgb.ell_mask, xp.rows,
                                        xp.width)
    assert bsp.tiled_form(V, V, xp.rows * xp.width)
    got = bsp.expanded_forward_reference(
        q_s, kf, torch.from_numpy(v).to(getattr(torch, dtype)), src_x,
        mask_x, xp.rows, tiled=True)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        tol = 1e-5 * float(np.abs(want).max())
    else:
        tol = (2.0 ** -9 * float(np.abs(v).max())
               + 2 * 2.0 ** -8 * float(np.abs(want).max()))
    _close(got, want, dict(rtol=0, atol=tol))
    no_edge = ~tgb.ell_mask.any(dim=1)
    assert no_edge.sum() > V // 2  # the padded nodes and node 3
    assert bool((got[no_edge] == 0).all())


def test_expanded_fused_attention_follows_the_form_rule(monkeypatch):
    """On the CPU, ExpandedFusedAttention's forward is the plain version of
    the form bsp.tiled_form gives (tiled on the crafted wide graph's node
    view; per-edge, the parts and the combine, once the rule's threshold
    passes its width), bit for bit, and its gradients match jax.grad of JAX
    expanded_attention_fused to 1e-5 of each gradient's largest element in
    both forms."""
    jgb, tgb = _crafted_wide()
    xp = tgb.bsp_expanded
    V = jgb.max_nodes
    q, k, v, ct = _rand(V, 8, 8, 64, 64, seed=10)
    want_g = jax.grad(lambda q, k, v: jnp.sum(
        JB.expanded_attention_fused(q, k, v, jgb) * ct), argnums=(0, 1, 2))(
            q, k, v)
    src_x, mask_x = bsp.expand_ell_view(tgb.ell_src, tgb.ell_mask, xp.rows,
                                        xp.width)
    for threshold, tiled in ((bsp.TILED_MIN_DEG, True),
                             (xp.rows * xp.width + 1, False)):
        monkeypatch.setattr(bsp, "TILED_MIN_DEG", threshold)
        assert bsp.tiled_form(V, V, xp.rows * xp.width) == tiled
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = bsp.expanded_attention_fused(*leaves, tgb)
        q_s, kf = bsp._scaled(*leaves[:2])
        form = bsp.expanded_forward_reference(q_s, kf, leaves[2], src_x,
                                              mask_x, xp.rows, tiled=tiled)
        assert torch.equal(out, form)
        (out * torch.from_numpy(ct)).sum().backward()
        for t, w in zip(leaves, want_g):
            w = np.asarray(w)
            _close(t.grad, w, dict(rtol=0, atol=1e-5 * float(np.abs(w).max())))
