"""Tests of the CUDA kernels on the card; they skip on a machine without one.

Run them on the card with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
need not have; nothing here imports JAX). TF32 is turned off, as in
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import ell_cases
from mrp_gnn_tpu_torch.graph import build_graph_batch, radius_edges
from mrp_gnn_tpu_torch.ops import _build, bsp, ell

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _graph():
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    b = radius_edges(40, 30)  # in-degree up to 39
    return build_graph_batch([a, b], [6, 40], max_nodes=64, max_edges=2048)


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, D, dtype):
    g = _graph().to(dev)
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(dev)
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32)).to(dev, dtype)
    before = bsp.fused_attention.launches
    got = bsp.bsp_attention_fused(q, k, v, g)
    assert bsp.fused_attention.launches == before + 1
    want = bsp.bsp_attention_fused_reference(q, k, v, g)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:  # one bf16 ulp: both round an f32 sum, summed in another order
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-6)
    empty = ~g.ell_mask.any(dim=1)
    assert bool((got[empty] == 0).all())


def test_broken_build_raises_for_cuda_tensors(dev, monkeypatch, tmp_path):
    (tmp_path / "bsp_fused_attention.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    g = _graph().to(dev)
    x = torch.ones(64, 64, device=dev)
    with pytest.raises(RuntimeError, match="build failed"):
        bsp.fused_attention(x, x, x, g.ell_src, g.ell_mask)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = _graph().to(dev)
    x = torch.ones(64, 64, device=dev)
    with pytest.raises(TypeError):
        bsp.fused_attention(x.double(), x, x, g.ell_src, g.ell_mask)
    with pytest.raises(ValueError, match="contiguous"):
        bsp.fused_attention(x, x, x.t(), g.ell_src, g.ell_mask)
    with pytest.raises(TypeError):
        bsp.spmm(x.double(), x, g.ell_src, g.ell_mask)
    # inputs that need a gradient are taken: the gradient flows
    q = x.clone().requires_grad_()
    bsp.bsp_attention_fused(q, x, x, g).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def _inputs(dev, V, *widths, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32)).to(dev)
            for d in widths]


def _weights(g, seed):
    (w,) = _inputs(g.ell_src.device, g.ell_src.shape[0], g.ell_src.shape[1],
                   seed=seed)
    return w


def _assert_kernel_close(got, want):
    """f32: 2e-5, sums in another order; bf16 outputs: one bf16 ulp."""
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_sddmm_matches_plain(dev, D, dtypes):
    g = _graph().to(dev)
    q, k, a, b = _inputs(dev, 64, 64, 64, D, D, seed=1)
    a, b = a.to(dtypes[0]), b.to(dtypes[1])
    before = bsp.sddmm.launches
    out1, out2 = bsp.sddmm(q, k, g.ell_src, g.ell_mask, a, b)
    single = bsp.sddmm(a, b, g.ell_src, g.ell_mask)
    assert bsp.sddmm.launches == before + 2
    torch.cuda.synchronize()
    _assert_kernel_close(out1, bsp.sddmm_reference(q, k, g.ell_src, g.ell_mask))
    want = bsp.sddmm_reference(a, b, g.ell_src, g.ell_mask)
    # D-long f32 sums of exact products: 2e-5 relative to the sum's size
    torch.testing.assert_close(out2, want, rtol=2e-5, atol=2e-5 * D ** 0.5)
    assert torch.equal(single, out2)
    assert bool((out2[~g.ell_mask] == 0).all())


@pytest.mark.parametrize("D", [8192, 1030, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_matches_plain(dev, D, dtype):
    g = _graph().to(dev)
    (x,) = _inputs(dev, 64, D, seed=2)
    x = x.to(dtype)
    w = _weights(g, 3)
    before = bsp.spmm.launches
    got = bsp.spmm(w, x, g.ell_src, g.ell_mask)
    assert bsp.spmm.launches == before + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    _assert_kernel_close(got, bsp.spmm_reference(w, x, g.ell_src, g.ell_mask))


@pytest.mark.parametrize("D", [8192, 1030, 64])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_spmm_t_matches_plain_and_repeats_bit_for_bit(dev, D, dtypes):
    g = _graph().to(dev)
    (x,) = _inputs(dev, 64, D, seed=4)
    x = x.to(dtypes[0])
    w = _weights(g, 5)
    before = bsp.spmm_t.launches
    got = bsp.spmm_t(w, x, g.ell_src, g.ell_mask, 64, dtypes[1])
    again = bsp.spmm_t(w, x, g.ell_src, g.ell_mask, 64, dtypes[1])
    assert bsp.spmm_t.launches == before + 2 and got.dtype == dtypes[1]
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no atomics: the same bits every run
    _assert_kernel_close(got, bsp.spmm_t_reference(w, x, g.ell_src,
                                                   g.ell_mask, 64, dtypes[1]))
    unnamed = torch.ones(64, dtype=torch.bool, device=dev)
    unnamed[g.ell_src[g.ell_mask].long()] = False
    assert bool((got[unnamed] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_grads_match_plain(dev, dtype):
    """FusedAttention's kernel backward against torch autograd through the
    plain version, on the card."""
    g = _graph().to(dev)
    q, k, v, ct = _inputs(dev, 64, 64, 64, 4096, 4096, seed=6)
    grads = []
    for fn in (bsp.bsp_attention_fused, bsp.bsp_attention_fused_reference):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        (fn(qq, kk, vv, g).float() * ct).sum().backward()
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), **tol)


def _wide_graph():
    """ELL width 200 in 256 slots (a row-expanded plan, 2 rows of 104):
    duplicate edges, empty rows, a deg-200 row and a fully connected scene
    of 140 robots (deg 139)."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    wide = np.stack([np.arange(200) % 12, np.zeros(200, np.int64)])
    full = np.stack(np.nonzero(~np.eye(140, dtype=bool))[::-1])
    sizes = [6, 12, 140]
    return build_graph_batch([a, wide, full], sizes, max_nodes=256,
                             max_edges=8 + 200 + 140 * 139)


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_parts_matches_plain(dev, D, dtype):
    g = _wide_graph()
    assert g.bsp_expanded is not None
    g = g.to(dev)
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q, k, v = _inputs(dev, 256, 64, 64, D, seed=7)
    q_x = (q / 8.0).repeat_interleave(xp.rows, dim=0)
    v = v.to(dtype)
    before = bsp.fused_attention_parts.launches
    acc, m, l = bsp.fused_attention_parts(q_x, k, v, src_x, mask_x)
    assert bsp.fused_attention_parts.launches == before + 1
    want = bsp.fused_attention_parts_reference(q_x, k, v, src_x, mask_x)
    torch.cuda.synchronize()
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    # f32 sums of up to 100 weighted O(1) values in another order
    for got, w in zip((acc, m, l), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=2e-5)
    empty = ~mask_x.any(dim=1)
    assert empty.any()
    assert bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expanded_forward_forms_match_plain_bit_for_bit(dev, tiled, D, dtype):
    """Each form of the high-degree forward (bsp.run_expanded_forward,
    forced) against the plain attention: twice with the same bits, nodes
    without a valid slot exactly 0; bsp.expanded_forward takes the rule's
    form (tiled on the node view of width 208) and counts one launch."""
    g = _wide_graph().to(dev)
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q, k, v = _inputs(dev, 256, 64, 64, D, seed=29)
    q_s, kf = bsp._scaled(q, k)
    v = v.to(dtype)
    args = (q_s, kf, v, src_x, mask_x, xp.rows)
    got, again = (bsp.run_expanded_forward(_Uncounted, *args, tiled=tiled)
                  for _ in range(2))
    before = bsp.fused_attention_parts.launches
    rule = bsp.expanded_forward(*args)
    assert bsp.fused_attention_parts.launches == before + 1
    want = bsp.bsp_attention_fused_reference(q, k, v, g)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    _assert_kernel_close(got, want)
    assert bool((got[~g.ell_mask.any(dim=1)] == 0).all())
    assert bsp.tiled_form(256, 256, xp.rows * xp.width)
    if tiled:
        assert torch.equal(rule, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expanded_attention_grads_match_plain(dev, dtype):
    """ExpandedFusedAttention (parts kernel, combine, backward kernels on
    the expanded view) against torch autograd through the plain version."""
    g = _wide_graph().to(dev)
    q, k, v, ct = _inputs(dev, 256, 64, 64, 4096, 4096, seed=8)
    outs, grads = [], []
    for fn in (bsp.expanded_attention_fused, bsp.bsp_attention_fused_reference):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        out = fn(qq, kk, vv, g)
        (out.float() * ct).sum().backward()
        outs.append(out)
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    _assert_kernel_close(*outs)
    assert bool((outs[0][~g.ell_mask.any(dim=1)] == 0).all())
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("graph", ["square", "wide"])
def test_mean_matches_plain(dev, graph):
    """bsp_mean (square plan) and expanded_mean (row-expanded plan) with
    their gradients against the plain mean on the card."""
    from mrp_gnn_tpu_torch.ops import dispatch
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    V = g.max_nodes
    v, ct = _inputs(dev, V, 2048, 2048, seed=9)
    grads = []
    for impl in ("pallas", "xla"):
        vv = v.clone().requires_grad_()
        out = dispatch.get_ops(impl).ell_mean(vv, g)
        (out * ct).sum().backward()
        grads.append((out, vv.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("D", [8192, 1030, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_ell_max_matches_plain_bit_for_bit(dev, D, dtype, graph):
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    (v,) = _inputs(dev, g.max_nodes, D, seed=10)
    v = v.to(dtype)
    before = ell.masked_max.launches
    got = ell.masked_max(v, g.ell_src, g.ell_mask)
    assert ell.masked_max.launches == before + 1 and got.dtype == dtype
    want = ell.masked_max_reference(v, g.ell_src, g.ell_mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # a max does not round
    assert bool((got[~g.ell_mask.any(dim=1)] == 0).all())


def test_ell_max_propagates_nan_and_its_gradient_matches_plain(dev):
    """A NaN among a row's valid values gives NaN (jnp.maximum's rule), and
    the gradient (plain torch on both devices) with ties among the valid
    slots equals the CPU's within 1e-5 of its largest element: the card's
    index_add_ sums the split shares in another order."""
    g = _wide_graph().to(dev)
    v, ct = _inputs(dev, g.max_nodes, 1024, 1024, seed=11)
    v[3, 5] = float("nan")  # node 3 feeds node 1 of the first scene
    out = ell.masked_max(v, g.ell_src, g.ell_mask)
    assert bool(torch.isnan(out[1, 5])) and bool(torch.isfinite(out[0]).all())
    v = v.nan_to_num().round()  # ties among the valid slots
    grads = []
    for d in (dev, torch.device("cpu")):
        vv = v.detach().to(d).requires_grad_()
        out = ell.ell_max(vv, g.ell_src.to(d), g.ell_mask.to(d))
        (out * ct.to(d)).sum().backward()
        grads.append(vv.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-5 * float(grads[1].abs().max()))


def _assert_block_close(got, want):
    """f32: 2e-5; bf16: one bf16 ulp of the largest element (the kernel and
    the plain version may round a weight to bf16 apart)."""
    if got.dtype == torch.bfloat16:
        limit = 2.0 ** -7 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= limit
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("scenes,robots,slots,D", [
    (16, 8, None, 2048), (8, 5, None, 8192), (3, 8, 40, 256),
    (2, 256, 768, 1030)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_matches_plain(dev, scenes, robots, slots, D, dtype):
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.ops import edge
    g = batch_fully_connected(scenes, robots, max_nodes=slots).to(dev)
    q, k, v = _inputs(dev, g.max_nodes, 64, 64, D, seed=12)
    v = v.to(dtype)
    before = edge.block_attention.launches
    got = edge.block_fused_attention(q, k, v, g)
    assert edge.block_attention.launches == before + 1 and got.dtype == dtype
    want = edge.block_fused_attention_reference(q, k, v, g)
    torch.cuda.synchronize()
    _assert_block_close(got, want)
    assert bool((got[~g.node_mask] == 0).all())


@pytest.mark.parametrize("n", [1, 5, 8, 9, 16, 33, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_scene_sizes_match_plain(dev, n, dtype):
    """Each scene-size bucket of the block kernel (8, 16 and 32 nodes, 16-
    byte rows) and the general kernel past 32: 3 scenes of n in 4 n slots,
    so the fourth scene is padded and gives exactly 0."""
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.ops import edge
    g = batch_fully_connected(3, n, max_nodes=4 * n).to(dev)
    q, k, v = _inputs(dev, g.max_nodes, 64, 64, 1024, seed=14)
    v = v.to(dtype)
    got = edge.block_fused_attention(q, k, v, g)
    want = edge.block_fused_attention_reference(q, k, v, g)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_block_close(got, want)
    assert bool((got[~g.node_mask] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_grads_match_plain(dev, dtype):
    """BlockAttention's backward (plain torch, as JAX's is XLA einsums)
    against autograd through the plain version, on the card."""
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.ops import edge
    g = batch_fully_connected(6, 8, max_nodes=56).to(dev)
    q, k, v, ct = _inputs(dev, 56, 64, 64, 1024, 1024, seed=13)
    grads = []
    for fn in (edge.block_fused_attention, edge.block_fused_attention_reference):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        (fn(qq, kk, vv, g).float() * ct).sum().backward()
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= (
            rel * float(want.float().abs().max()))


def test_block_attention_rejects_what_the_kernel_does_not_take(dev):
    from mrp_gnn_tpu_torch.ops import edge
    x = torch.ones(514, 8, device=dev)
    valid = torch.ones(514, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="256"):
        edge.block_attention(x, x, x, valid, torch.ones(257, 257, device=dev))
    adj = torch.ones(2, 2, device=dev)
    with pytest.raises(TypeError):
        edge.block_attention(x, x.bfloat16(), x, valid, adj)
    with pytest.raises(ValueError, match="contiguous"):
        edge.block_attention(x, x, x.t().contiguous().t(), valid, adj)


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_ell_kernels_match_plain(dev, D, dtype, graph):
    """The plan-free ELL SpMM, SDDMM and softmax at widths up to 200, each
    counted in its own wrapper and not in the BSP wrappers. The SpMM's
    weights are a masked softmax, as on the attention path: f32 sums of up
    to 200 random-normal weights would differ by more than 2e-5 in another
    order."""
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    V = g.max_nodes
    q, k, x = _inputs(dev, V, 64, 64, D, seed=14)
    w = bsp.masked_softmax(_weights(g, 15), g.ell_mask)
    before = bsp.launch_counts()
    out = ell.spmm(w, x.to(dtype), g.ell_src, g.ell_mask)
    lo = ell.sddmm(q, k, g.ell_src, g.ell_mask)
    alpha = ell.softmax(lo, g.ell_mask)
    after = bsp.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"ell_spmm": 1, "ell_sddmm": 1, "ell_softmax": 1}
    torch.cuda.synchronize()
    _assert_kernel_close(out, bsp.spmm_reference(w, x.to(dtype), g.ell_src,
                                                 g.ell_mask))
    _assert_kernel_close(lo, bsp.sddmm_reference(q, k, g.ell_src, g.ell_mask))
    _assert_kernel_close(alpha, bsp.masked_softmax(lo, g.ell_mask))
    empty = ~g.ell_mask.any(dim=1)
    assert bool((out[empty] == 0).all() and (alpha[empty] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_attention_grads_match_plain(dev, dtype):
    """The three ELL kernels' attention with the JAX custom vjps' gradients
    (plain torch) against autograd through its plain version."""
    g = _wide_graph().to(dev)
    q, k, v, ct = _inputs(dev, 256, 64, 64, 2048, 2048, seed=16)
    outs, grads = [], []
    for fn in (ell.ell_attention, ell.ell_attention_reference):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        out = fn(qq, kk, vv, g)
        (out.float() * ct).sum().backward()
        outs.append(out)
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    _assert_kernel_close(*outs)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for got, want in zip(*grads):
        assert float((got.float() - want.float()).abs().max()) <= (
            rel * float(want.float().abs().max()))


def _padded_plan_graph():
    """_graph() with its tile-pair plan padded to twice its pairs (inert)."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    b = radius_edges(40, 30)
    tight = _graph()
    return build_graph_batch([a, b], [6, 40], max_nodes=64, max_edges=2048,
                             max_bsp_pairs=2 * tight.bsp_pair_dst.shape[0])


@pytest.mark.parametrize("graph", ["square", "padded_plan"])
@pytest.mark.parametrize("dk", [64, 200])
def test_attention_weights_match_plain(dev, graph, dk):
    """The weights kernel (SDDMM and masked softmax) against its plain
    version: f32 within 2e-5; masked slots and rows without a valid slot
    exactly 0; duplicate edges count once per slot."""
    g = (_graph() if graph == "square" else _padded_plan_graph()).to(dev)
    q, k = _inputs(dev, 64, dk, dk, seed=17)
    q_s = q / dk ** 0.5
    before = bsp.attention_weights.launches
    got = bsp.attention_weights(q_s, k, g.ell_src, g.ell_mask)
    assert bsp.attention_weights.launches == before + 1
    want = bsp.attention_weights_reference(q_s, k, g.ell_src, g.ell_mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert bool((got[~g.ell_mask] == 0).all())
    assert bool((got[~g.ell_mask.any(dim=1)] == 0).all())
    rows = g.ell_mask.any(dim=1)
    torch.testing.assert_close(got[rows].sum(-1),
                               torch.ones(int(rows.sum()), device=dev),
                               rtol=0, atol=1e-5)


def test_attention_weights_reject_what_the_kernel_does_not_take(dev):
    g = _wide_graph().to(dev)
    x = torch.ones(256, 64, device=dev)
    with pytest.raises(ValueError, match="deg"):
        bsp.attention_weights(x, x, g.ell_src, g.ell_mask)
    g = _graph().to(dev)
    x = torch.ones(64, 300, device=dev)
    with pytest.raises(ValueError, match="dk"):
        bsp.attention_weights(x, x, g.ell_src, g.ell_mask)
    with pytest.raises(TypeError):
        bsp.attention_weights(x.bfloat16(), x, g.ell_src, g.ell_mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsp_attention_grads_match_plain(dev, dtype):
    """The two-kernel attention (BspWeights, then WeightedAggregate) with
    its kernel backward against torch autograd through the plain fused
    version, on the card."""
    g = _graph().to(dev)
    q, k, v, ct = _inputs(dev, 64, 64, 64, 4096, 4096, seed=18)
    outs, grads = [], []
    for fn in (bsp.bsp_attention, bsp.bsp_attention_fused_reference):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        out = fn(qq, kk, vv, g)
        (out.float() * ct).sum().backward()
        outs.append(out)
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    _assert_kernel_close(*outs)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_spmm_t2_equals_two_spmm_t_bit_for_bit(dev, D, dtypes, graph):
    """The dual transposed SpMM gives the bits of two single launches, for
    a first operand of width D (values' dtype, out dtype) and a second of
    width 64 in f32, as the attention backward pairs dvalues and dk; on
    the wide graph over its row-expanded view."""
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    src, mask = g.ell_src, g.ell_mask
    if graph == "wide":
        xp = g.bsp_expanded
        src, mask = bsp.expand_ell_view(src, mask, xp.rows, xp.width)
    Vs = g.max_nodes
    x1, x2 = _inputs(dev, src.shape[0], D, 64, seed=19)
    x1 = x1.to(dtypes[0])
    w1 = bsp.masked_softmax(_inputs(dev, src.shape[0], src.shape[1], seed=20)[0],
                            mask)
    (w2,) = _inputs(dev, src.shape[0], src.shape[1], seed=21)
    w2 = torch.where(mask, w2, 0.0)
    before = bsp.launch_counts()
    out1, out2 = bsp.spmm_t2(w1, x1, w2, x2, src, mask, Vs, dtypes[1])
    mid = bsp.launch_counts()
    one = bsp.spmm_t(w1, x1, src, mask, Vs, dtypes[1])
    two = bsp.spmm_t(w2, x2, src, mask, Vs)
    torch.cuda.synchronize()
    assert {n: mid[n] - before[n] for n in mid if mid[n] != before[n]} \
        == {"bsp_spmm_t2": 1}
    assert out1.dtype == dtypes[1] and out2.dtype == torch.float32
    assert torch.equal(out1, one) and torch.equal(out2, two)
    # f32 sums of up to 200 random-normal products, in another order
    torch.testing.assert_close(
        out2, bsp.spmm_t_reference(w2, x2, src, mask, Vs), rtol=2e-5,
        atol=2e-5 * src.shape[1] ** 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_dual_backward_gives_the_same_bits(dev, dtype, graph, monkeypatch):
    """The fused attention's backward launches one spmm_t2 and gives the
    gradients of two spmm_t launches in its place, bit for bit."""
    from mrp_gnn_tpu_torch.ops import dispatch
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    q, k, v, ct = _inputs(dev, g.max_nodes, 64, 64, 2048, 2048, seed=22)
    ops = dispatch.get_ops("pallas")
    spmm_t = bsp.spmm_t

    def separate(w1, x1, w2, x2, src, mask, num_rows, out1_dtype=None,
                 out2_dtype=None, view=None):
        return (spmm_t(w1, x1, src, mask, num_rows, out1_dtype, view),
                spmm_t(w2, x2, src, mask, num_rows, out2_dtype, view))

    separate.launches = 0
    grads, counts = [], []
    for run in range(2):
        if run:
            monkeypatch.setattr(bsp, "spmm_t2", separate)
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        vv = v.to(dtype).requires_grad_()
        out = ops.ell_attention(qq, kk, vv, g)
        before = (bsp.spmm_t.launches, bsp.spmm_t2.launches)
        (out.float() * ct).sum().backward()
        counts.append((bsp.spmm_t.launches - before[0],
                       bsp.spmm_t2.launches - before[1]))
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    assert counts == [(0, 1), (2, 0)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


class _Uncounted:
    launches = 0


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_sddmm_forms_match_plain(dev, tiled, D, dtypes, graph):
    """Each form of bsp_sddmm.cu, forced, against the plain version: the
    dual form (q, k) and (a, b), and a single (a, b) launch that gives the
    dual's second output bit for bit; masked slots 0."""
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
    q, k, a, b = _inputs(dev, V, 64, 64, D, D, seed=23)
    a, b = a.to(dtypes[0]), b.to(dtypes[1])
    out1, out2 = bsp.run_sddmm(_Uncounted, q, k, src, mask, a, b, tiled=tiled)
    single = bsp.run_sddmm(_Uncounted, a, b, src, mask, tiled=tiled)
    torch.cuda.synchronize()
    _assert_kernel_close(out1, bsp.sddmm_reference(q, k, src, mask))
    # D-long f32 sums of exact products: 2e-5 relative to the sum's size
    torch.testing.assert_close(out2, bsp.sddmm_reference(a, b, src, mask),
                               rtol=2e-5, atol=2e-5 * D ** 0.5)
    assert torch.equal(single, out2)
    assert bool((out2[~mask] == 0).all())


@pytest.mark.parametrize("form", bsp.SPMM_T_FORMS)
@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("graph", ["square", "wide"])
def test_spmm_t_forms_match_plain_bit_for_bit(dev, form, D, dtypes, graph):
    """Each form of bsp_spmm_t.cu, forced, against the plain version, as
    the attention backward pairs dvalues (width D) and dk (width 64, f32):
    two single launches give the same bits, the dual gives the bits of the
    singles, and a source no valid slot names gives 0."""
    g = (_graph() if graph == "square" else _wide_graph()).to(dev)
    src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
    x1, x2 = _inputs(dev, V, D, 64, seed=24)
    x1 = x1.to(dtypes[0])
    w1 = bsp.masked_softmax(_weights(g, 25), mask)
    w2 = torch.where(mask, _weights(g, 26), 0.0)
    p1, p2 = (w1, x1, dtypes[1]), (w2, x2, torch.float32)
    out1, out2 = bsp._run_spmm_t(_Uncounted, (p1, p2), src, mask, V, None,
                                 form=form)
    one, again, two = (bsp._run_spmm_t(_Uncounted, (p,), src, mask, V, None,
                                       form=form)[0] for p in (p1, p1, p2))
    torch.cuda.synchronize()
    assert torch.equal(one, again) and torch.equal(out1, one)
    assert torch.equal(out2, two)
    _assert_kernel_close(out1, bsp.spmm_t_reference(w1, x1, src, mask, V,
                                                    dtypes[1]))
    # f32 sums of up to 200 random-normal products, in another order
    torch.testing.assert_close(
        out2, bsp.spmm_t_reference(w2, x2, src, mask, V), rtol=2e-5,
        atol=2e-5 * src.shape[1] ** 0.5)
    unnamed = torch.ones(V, dtype=torch.bool, device=dev)
    unnamed[src[mask].long()] = False
    assert bool((out1[unnamed] == 0).all() and (out2[unnamed] == 0).all())


def test_wrappers_take_the_form_of_the_rule(dev, monkeypatch):
    """bsp.sddmm and bsp.spmm_t give the bits of the forms that
    bsp.tiled_form and bsp.spmm_t_form pick for the ELL shape: per-edge at
    width 40 (past STAGED_MAX_DEG), the transposed SpMM staged at width 8
    (the crafted scenes alone), tiled at width 200; only the per-edge
    transposed SpMM builds a source view."""
    views = []
    real = bsp.source_view
    monkeypatch.setattr(bsp, "source_view",
                        lambda *a: views.append(1) or real(*a))
    narrow = build_graph_batch(
        [np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])],
        [6], max_nodes=64, max_edges=8)
    for graph, want_tiled, want_t in (("square", False, "per-edge"),
                                      ("narrow", False, "staged"),
                                      ("wide", True, "tiled")):
        g = {"square": _graph, "wide": _wide_graph,
             "narrow": lambda: narrow}[graph]().to(dev)
        src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
        assert bsp.tiled_form(V, V, src.shape[1]) == want_tiled
        assert bsp.SPMM_T_FORMS[bsp.spmm_t_form(V, V, src.shape[1])] == want_t
        a, b, x = _inputs(dev, V, 256, 256, 256, seed=27)
        w = bsp.masked_softmax(_weights(g, 28), mask)
        assert torch.equal(bsp.sddmm(a, b, src, mask), bsp.run_sddmm(
            _Uncounted, a, b, src, mask, tiled=want_tiled))
        views.clear()
        got = bsp.spmm_t(w, x, src, mask, V)
        assert len(views) == (want_t == "per-edge")
        assert torch.equal(got, bsp._run_spmm_t(
            _Uncounted, ((w, x, torch.float32),), src, mask, V, None,
            form=want_t)[0])


def _rect_lists(dev, V, Vs, deg, seed):
    """ELL lists of V destination rows over Vs sources (V not a multiple of
    the 64-node tile): a duplicate slot in every row, rows with no valid
    slot, and 5 sources no slot names."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, Vs - 5, size=(V, deg)).astype(np.int32)
    src[:, 1] = src[:, 0]
    mask = rng.random((V, deg)) < 0.7
    mask[::7] = False
    return torch.from_numpy(src).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("D", [64, 1030, 8192])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("lists", ["square", "more sources", "fewer sources"])
def test_staged_spmm_t_is_the_per_edge_form_bit_for_bit(dev, D, dtypes,
                                                        lists):
    """The staged transposed SpMM, forced, gives the per-edge form's bits
    (single and dual launches), its dual the bits of two single launches,
    a rerun the same bits, and matches the plain version: on the square
    graph (duplicate edges, empty rows, ELL width 40) and on rectangular
    lists (V 100 rows over 200 or 50 sources, width 12), for x of width D
    (f32, bf16, bf16 into f32) paired with dk's width 64 in f32."""
    if lists == "square":
        g = _graph().to(dev)
        src, mask, Vs = g.ell_src, g.ell_mask, g.max_nodes
    else:
        Vs = 200 if lists == "more sources" else 50
        src, mask = _rect_lists(dev, 100, Vs, 12, seed=29)
    V, deg = src.shape
    x1, x2 = _inputs(dev, V, D, 64, seed=30)
    x1 = x1.to(dtypes[0])
    w1 = bsp.masked_softmax(_inputs(dev, V, deg, seed=31)[0], mask)
    w2 = torch.where(mask, _inputs(dev, V, deg, seed=32)[0], 0.0)
    p1, p2 = (w1, x1, dtypes[1]), (w2, x2, torch.float32)

    def run(form, pairs):
        return bsp._run_spmm_t(_Uncounted, pairs, src, mask, Vs, None,
                               form=form)

    dual, per_edge = run("staged", (p1, p2)), run("per-edge", (p1, p2))
    one, again = run("staged", (p1,))[0], run("staged", (p1,))[0]
    two = run("staged", (p2,))[0]
    torch.cuda.synchronize()
    assert torch.equal(dual[0], per_edge[0]) and torch.equal(dual[1],
                                                             per_edge[1])
    assert torch.equal(dual[0], one) and torch.equal(one, again)
    assert torch.equal(dual[1], two)
    _assert_kernel_close(dual[0], bsp.spmm_t_reference(w1, x1, src, mask, Vs,
                                                       dtypes[1]))
    torch.testing.assert_close(
        dual[1], bsp.spmm_t_reference(w2, x2, src, mask, Vs), rtol=2e-5,
        atol=2e-5 * deg ** 0.5)
    unnamed = torch.ones(Vs, dtype=torch.bool, device=dev)
    unnamed[src[mask].long()] = False
    assert unnamed.any() and bool((dual[0][unnamed] == 0).all())


# --- the fused forward's forms and the per-edge SDDMM on the edge cases ----
# (tests/ell_cases.py at the card's sizes: the swarm, sources spread over
# every node tile, duplicates, rows without an in-edge, ELL widths 8-200)


def _case(name, dev):
    return build_graph_batch(*ell_cases.CASES[name][1]()).to(dev)


@pytest.mark.parametrize("form", bsp.FUSED_FORMS)
@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in ell_cases.CASES
                                  if c not in ell_cases.WIDE])
def test_fused_forms_match_plain_bit_for_bit(dev, case, dtype, D, form):
    """Each form of the fused forward, forced, against the plain version;
    a second launch gives the same bits; rows without a valid slot give 0;
    at D 1030 (4-byte loads) only the row form launches, the vector form
    raises; the wrapper gives the bits of its rule's form."""
    g = _case(case, dev)
    src, mask = g.ell_src, g.ell_mask
    q, k, v = _inputs(dev, g.max_nodes, 64, 64, D, seed=7)
    q_s, kf = bsp._scaled(q, k)
    v = v.to(dtype)
    vec = bsp._fused_vec(v, v)
    if vec == 1 and form != "row":
        with pytest.raises(ValueError):
            bsp.run_fused_attention(_Uncounted, q_s, kf, v, src, mask, form=form)
        return
    got = bsp.run_fused_attention(_Uncounted, q_s, kf, v, src, mask, form=form)
    again = bsp.run_fused_attention(_Uncounted, q_s, kf, v, src, mask,
                                    form=form)
    torch.cuda.synchronize()
    _assert_kernel_close(got, bsp.fused_attention_reference(q_s, kf, v, src,
                                                            mask))
    assert torch.equal(got, again)
    empty = ~mask.any(dim=1)
    assert bool((got[empty] == 0).all())
    if bsp.FUSED_FORMS[bsp.fused_form(vec, dtype == torch.bfloat16)] == form:
        assert torch.equal(got, bsp.fused_attention(q_s, kf, v, src, mask))


@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_per_edge_sddmm_matches_plain_bit_for_bit(dev, case, dtypes, D):
    """The per-edge SDDMM, forced: single (d 64, narrow) and dual (d 64
    and D: a wide pair at 8192, a scalar one at 1030) against the plain
    versions; the dual's outputs equal two single launches bit for bit; a
    second launch gives the same bits; masked slots give 0."""
    g = _case(case, dev)
    src, mask = g.ell_src, g.ell_mask
    q, k, a, b = _inputs(dev, g.max_nodes, 64, 64, D, D, seed=9)
    a, b = a.to(dtypes[0]), b.to(dtypes[1])

    def run(*args):
        return bsp.run_sddmm(_Uncounted, *args, tiled=False)

    one = run(q, k, src, mask)
    dual = run(q, k, src, mask, a, b)
    two = run(a, b, src, mask)
    torch.cuda.synchronize()
    _assert_kernel_close(one, bsp.sddmm_reference(q, k, src, mask))
    torch.testing.assert_close(two, bsp.sddmm_reference(a, b, src, mask),
                               rtol=2e-5, atol=2e-5 * D ** 0.5)
    assert torch.equal(dual[0], one) and torch.equal(dual[1], two)
    assert torch.equal(run(q, k, src, mask), one)
    assert bool((one[~mask] == 0).all()) and bool((two[~mask] == 0).all())


@pytest.mark.parametrize("form", bsp.SPMM_FORMS)
@pytest.mark.parametrize("D", [8192, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_spmm_forms_and_max_match_plain_bit_for_bit(dev, case, dtype, D, form):
    """Each form of the SpMM, forced: within tolerance of the plain version
    and bit-equal to the row form and to a second launch; at D 1030 (4-byte
    loads) the vector form raises; the wrappers give the bits of their
    rule's form. The masked max on the same graph: bit-equal to the plain
    version, NaN in giving NaN out. Rows without a valid slot give 0."""
    g = _case(case, dev)
    src, mask = g.ell_src, g.ell_mask
    (x,) = _inputs(dev, g.max_nodes, D, seed=17)
    x = x.to(dtype)
    # attention-like weights: positive, each row's summing to 1, so the
    # sums stay O(1) at any degree and f32 differences of order stay 2e-5
    w = torch.where(mask, _weights(g, 18).abs(), 0.0)
    w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-30)
    empty = ~mask.any(dim=1)
    mx = ell.masked_max(x, src, mask)
    r = int(mask.any(dim=1).nonzero()[0])
    poisoned = x.clone()
    poisoned[src[r, int(mask[r].nonzero()[0])].long(), 5] = float("nan")
    torch.cuda.synchronize()
    assert torch.equal(mx, ell.masked_max_reference(x, src, mask))
    assert bool((mx[empty] == 0).all())
    assert bool(torch.isnan(ell.masked_max(poisoned, src, mask)[r, 5]))
    vec = 8 if bsp._vec8(x) else 1
    if vec == 1 and form != "row":
        with pytest.raises(ValueError):
            bsp.run_spmm(_Uncounted, w, x, src, mask, form=form)
        return
    got = bsp.run_spmm(_Uncounted, w, x, src, mask, form=form)
    again = bsp.run_spmm(_Uncounted, w, x, src, mask, form=form)
    row = bsp.run_spmm(_Uncounted, w, x, src, mask, form="row")
    torch.cuda.synchronize()
    _assert_kernel_close(got, bsp.spmm_reference(w, x, src, mask))
    assert torch.equal(got, again) and torch.equal(got, row)
    assert bool((got[empty] == 0).all())
    if bsp.SPMM_FORMS[bsp.spmm_form(vec, D, dtype == torch.bfloat16)] == form:
        assert torch.equal(bsp.spmm(w, x, src, mask), got)
        assert torch.equal(ell.spmm(w, x, src, mask), got)


# --- the two softmax kernels' forms (rows 2 and 12) ------------------------


def _assert_softmax_rows(got, want, mask):
    """f32 within 2e-5 of the plain version; masked slots and rows without
    a valid slot exactly 0; each valid row sums to 1 within 1e-5."""
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert bool((got[~mask] == 0).all())
    rows = mask.any(dim=1)
    assert bool((got[~rows] == 0).all())
    torch.testing.assert_close(got[rows].sum(-1),
                               torch.ones(int(rows.sum()), device=got.device),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("form", bsp.WEIGHTS_FORMS)
@pytest.mark.parametrize("dk", [36, 64, 200])
@pytest.mark.parametrize("case", [c for c in ell_cases.CASES
                                  if c not in ell_cases.WIDE])
def test_weights_forms_match_plain(dev, case, dk, form):
    """Each form of the attention weights, forced, against the plain
    version (_assert_softmax_rows); a second launch gives the same bits; at
    dk 36 (4-byte loads) the rows form raises; the rows form's logits have
    the bits of the per-edge SDDMM on the same (q_s, k); the wrapper gives
    the bits of its rule's form."""
    g = _case(case, dev)
    src, mask = g.ell_src, g.ell_mask
    q, k = _inputs(dev, g.max_nodes, dk, dk, seed=31)
    q_s, kf = bsp._scaled(q, k)
    rule = bsp.WEIGHTS_FORMS[bsp.weights_form(dk, bsp._vec8(q_s, kf))]
    if form == "rows" and dk % 8:
        with pytest.raises(ValueError):
            bsp.run_attention_weights(_Uncounted, q_s, kf, src, mask, form=form)
        return
    got = bsp.run_attention_weights(_Uncounted, q_s, kf, src, mask, form=form)
    again = bsp.run_attention_weights(_Uncounted, q_s, kf, src, mask,
                                      form=form)
    torch.cuda.synchronize()
    _assert_softmax_rows(got, bsp.attention_weights_reference(q_s, kf, src,
                                                              mask), mask)
    assert torch.equal(got, again)
    if form == "rows":
        alpha, lo = bsp.run_attention_weights(_Uncounted, q_s, kf, src, mask,
                                              form=form, logits=True)
        assert torch.equal(alpha, got)
        assert torch.equal(lo, bsp.run_sddmm(_Uncounted, q_s, kf, src, mask,
                                             tiled=False))
    else:
        with pytest.raises(ValueError):
            bsp.run_attention_weights(_Uncounted, q_s, kf, src, mask,
                                      form=form, logits=True)
    if rule == form:
        assert torch.equal(bsp.attention_weights(q_s, kf, src, mask), got)


@pytest.mark.parametrize("form", ell.SOFTMAX_FORMS)
@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_softmax_forms_match_plain(dev, case, form):
    """Each form of the ELL softmax, forced, against the plain version
    (_assert_softmax_rows) on logits spread wide enough that the max
    matters; a second launch gives the same bits; past REGISTER_MAX_DEG the
    register form raises; the wrapper gives the bits of its rule's form."""
    g = _case(case, dev)
    mask = g.ell_mask
    V, deg = mask.shape
    x = torch.from_numpy(np.random.default_rng(32).normal(
        size=(V, deg)).astype(np.float32) * 8).to(dev)
    rule = ell.SOFTMAX_FORMS[ell.softmax_form(deg)]
    if form == "register" and deg > ell.REGISTER_MAX_DEG:
        with pytest.raises(ValueError):
            ell.run_softmax(_Uncounted, x, mask, form=form)
        return
    got = ell.run_softmax(_Uncounted, x, mask, form=form)
    again = ell.run_softmax(_Uncounted, x, mask, form=form)
    torch.cuda.synchronize()
    _assert_softmax_rows(got, bsp.masked_softmax(x, mask), mask)
    assert torch.equal(got, again)
    if rule == form:
        assert torch.equal(ell.softmax(x, mask), got)


@pytest.mark.parametrize("deg", [1, 4, 12, 30, 33, 128, 132])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_forms_at_any_width(dev, deg, offset):
    """Both forms on a random mask (every 5th row empty) at widths the
    graph builders never give (the register form at deg 1: one lane a row;
    deg 12: a group of 16 lanes with 4 idle; deg 33: one lane with two
    slots), also on rows that start one element past a 16-byte boundary;
    past REGISTER_MAX_DEG the register form raises."""
    V = 77
    rng = np.random.default_rng(deg)
    base = torch.from_numpy(rng.normal(size=(V * deg + 1,)).astype(
        np.float32) * 8).to(dev)
    x = base[offset:offset + V * deg].view(V, deg)
    mask = torch.from_numpy(rng.random((V, deg)) < 0.6).to(dev)
    mask[::5] = False
    want = bsp.masked_softmax(x, mask)
    for form in ell.SOFTMAX_FORMS:
        if form == "register" and deg > ell.REGISTER_MAX_DEG:
            with pytest.raises(ValueError):
                ell.run_softmax(_Uncounted, x, mask, form=form)
            continue
        got = ell.run_softmax(_Uncounted, x, mask, form=form)
        torch.cuda.synchronize()
        _assert_softmax_rows(got, want, mask)
    rule = ell.SOFTMAX_FORMS[ell.softmax_form(deg)]
    assert torch.equal(ell.softmax(x, mask),
                       ell.run_softmax(_Uncounted, x, mask, form=rule))


def test_resume_and_from_checkpoint_on_the_card(dev, tmp_path):
    """The small dynamic_swarm of tests/torch_small.py on the card, through
    the kernels: 4 straight steps against 2, a checkpoint, a new train()
    and 2 more, bit for bit with no cuDNN setting made here (the entry
    points pin deterministic cuDNN; the port's kernels sum in a fixed
    order); then Predictor.from_checkpoint gives the in-memory model's
    outputs bit for bit, launching the fused attention."""
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.serving import Predictor
    from torch_small import small
    kw = dict(log_every=1, eval_every=2, checkpoint_every=2)
    timing = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")
    terms = lambda recs: [{k: v for k, v in r.items() if k not in timing}  # noqa: E731
                          for r in recs]
    cfg = small(get_config("dynamic_swarm"), impl="auto",
                checkpoint_dir=str(tmp_path / "a"), **kw)
    before = bsp.launch_counts()
    straight, recs = TT.train(cfg, num_steps=4, device=dev)
    assert bsp.launch_counts()["bsp_fused_attention"] > before["bsp_fused_attention"]
    cfg_b = small(get_config("dynamic_swarm"), impl="auto",
                  checkpoint_dir=str(tmp_path / "b"), **kw)
    _, first = TT.train(cfg_b, num_steps=2, device=dev)
    resumed, rest = TT.train(cfg_b, num_steps=4, device=dev)
    assert rest[0]["step"] == 3
    assert terms(first[:-1] + rest) == terms(recs)
    for (n, a), (_, b) in zip(straight.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    before = bsp.fused_attention.launches
    got = Predictor.from_checkpoint(cfg, str(tmp_path / "a"),
                                    graph=batch["graph"])(batch["images"])
    assert bsp.fused_attention.launches == before + 1
    want = Predictor(cfg, straight.model, graph=batch["graph"])(batch["images"])
    for k in ("depth", "seg"):
        np.testing.assert_array_equal(got[k], want[k])


def test_exported_artifact_launches_the_kernel_on_the_card(dev, tmp_path):
    """The small dynamic_swarm's Predictor exported on the card, loaded on
    the card: the fused attention launched once a request, the Predictor's
    outputs bit for bit; the same artifact also loads on the CPU."""
    from mrp_gnn_tpu_torch import serving as TS
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
    from torch_small import small
    cfg = small(get_config("dynamic_swarm"), impl="auto")
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    model = MultiRobotPerceptionNet(
        cfg.model, ops_impl="auto",
        generator=torch.Generator().manual_seed(0)).to(dev)
    pred = TS.Predictor(cfg, model, graph=batch["graph"])
    path = str(tmp_path / "a.pt2")
    meta = TS.export_predictor(pred, path)
    assert meta["route"] == "kernels"
    assert meta["ops"] == ["mrp_gnn_torch::fused_attention"]
    infer = TS.load_exported(path)
    before = bsp.launch_counts()
    got = infer(batch["images"])
    after = bsp.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"bsp_fused_attention": 1}
    want = pred(batch["images"])
    for k in ("depth", "seg"):
        np.testing.assert_array_equal(got[k], want[k])
    on_cpu = TS.load_exported(path, device="cpu")(batch["images"])
    np.testing.assert_allclose(on_cpu["depth"], want["depth"], rtol=0,
                               atol=1e-3)


def test_placed_batches_equal_the_host_batches(dev):
    """BatchPlacer on the card, on a producer thread: images, depth, seg
    and every graph tensor read back equal to the host batch, the static
    graph copied once, the step's stream waiting on each batch's event."""
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import (TransformIterator,
                                                 make_dataset)
    from torch_small import small
    for name in ("dynamic_swarm", "multitask_batched"):
        cfg = small(get_config(name))
        host = [b for _, b in zip(range(3), make_dataset(cfg.data, "train"))]
        it = TransformIterator(iter(host), TT.BatchPlacer(dev))
        graphs = []
        for b in host:
            images, depth, seg, graph = TT.batch_to_device(next(it), dev)
            for got, k in ((images, "images"), (depth, "depth"),
                           (seg, "seg")):
                assert got.device.type == "cuda"
                np.testing.assert_array_equal(got.cpu().numpy(), b[k])
            seen = []
            graph.apply(lambda t: seen.append(t.cpu()) or t)
            want = []
            b["graph"].apply(lambda t: want.append(t) or t)
            assert len(seen) == len(want)
            for x, y in zip(seen, want):
                assert torch.equal(x, y)
            graphs.append(graph)
        it.close()
        static = name == "multitask_batched"
        assert (graphs[0] is graphs[2]) == static


@pytest.fixture
def tf32_caller(dev):
    """This process as a careless caller sets itself: TF32 on for cuBLAS and
    cuDNN (the legacy switches), cuDNN non-deterministic and benchmarking;
    the dev fixture's settings come back after the test."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


_SERVING_MAIN = """
import json, sys
import numpy as np
from mrp_gnn_tpu_torch.serving import load_exported, main
ckpt, art, images, out = sys.argv[1:5]
main(["--config", "dynamic_swarm", "--checkpoint_dir", ckpt, "--export", art])
infer = load_exported(art)
got = [infer(x) for x in np.load(images)]
np.savez(out, depth=np.stack([g["depth"] for g in got]),
         seg=np.stack([g["seg"] for g in got]))
"""


@pytest.mark.usefixtures("tf32_caller")
def test_serving_main_in_a_fresh_process_is_the_predictor(dev, tmp_path):
    """``serving.main``'s path (``Predictor.from_checkpoint`` on the
    preset's serving graph, ``--export``) in a fresh process that sets no
    flag, then its artifact's requests: bit for bit the Predictor of this
    process, which has TF32 on and cuDNN non-deterministic. Both pin their
    numerics (``utils.platform.reference_numerics``)."""
    import os
    import subprocess
    import sys
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.serving import Predictor
    cfg = get_config("dynamic_swarm")
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, TT.create_train_state(cfg, dev))
    it = iter(make_dataset(cfg.data, "eval", shuffle=False))
    images = np.stack([next(it)["images"] for _ in range(2)])
    np.save(tmp_path / "images.npy", images)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", _SERVING_MAIN, ckpt, str(tmp_path / "a.pt2"),
         str(tmp_path / "images.npy"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(tmp_path / "out.npz")
    pred = Predictor.from_checkpoint(cfg, ckpt)
    for i, x in enumerate(images):
        want = pred(x)
        for k in ("depth", "seg"):
            np.testing.assert_array_equal(got[k][i], want[k])


@pytest.mark.usefixtures("tf32_caller")
def test_the_predictor_pins_its_numerics_on_the_card(dev):
    """Under a caller's TF32, the Predictor's convolutions run in IEEE f32
    with deterministic cuDNN (read from a hook on the first convolution),
    and its outputs are those it gives a caller with TF32 off."""
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.models.encoder import Conv
    from mrp_gnn_tpu_torch.serving import Predictor
    from torch_small import small
    cfg = small(get_config("dynamic_swarm"), impl="auto")
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    pred = Predictor(cfg, TT.create_train_state(cfg, dev).model,
                     graph=batch["graph"])
    seen = []
    conv = next(m for m in pred.model.modules() if isinstance(m, Conv))
    conv.register_forward_pre_hook(lambda *_: seen.append((
        torch.backends.cudnn.conv.fp32_precision,
        torch.backends.cuda.matmul.fp32_precision,
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)))
    hostile = pred(batch["images"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    careful = pred(batch["images"])
    assert seen == [("ieee", "ieee", True, False)] * 2
    for k in ("depth", "seg"):
        np.testing.assert_array_equal(hostile[k], careful[k])


def test_checked_on_the_card(dev):
    """``utils.debug.checked`` on the card: a small attention step through
    the kernels, forward and backward, bit for bit the unchecked step; a NaN
    that the dual transposed SpMM (launched through ctypes in the backward,
    unseen by the dispatcher) writes is caught at the op that reads it; an
    out-of-range gather raises IndexError before any kernel runs it; the
    card then goes on."""
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
    from mrp_gnn_tpu_torch.utils.debug import checked
    from mrp_gnn_tpu_torch.utils.platform import reference_numerics
    from torch.utils._python_dispatch import _disable_current_modes
    from torch_small import small
    cfg = small(get_config("dynamic_swarm"), impl="auto")
    batch = TT.batch_to_device(next(make_train_iterator(cfg.data)), dev)
    grad_fn = TT.make_grad_fn(cfg, TT.create_train_state(cfg, dev).model)
    with reference_numerics():
        g0, t0 = grad_fn(*batch)
        before = bsp.launch_counts()
        g1, t1 = checked(grad_fn)(*batch)
        assert bsp.launch_counts()["bsp_spmm_t2"] == before["bsp_spmm_t2"] + 1
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert all(torch.equal(t0[k], t1[k]) for k in t0)
        real = bsp.spmm_t2

        def nan_dvalues(*args, **kw):
            out = real(*args, **kw)
            with _disable_current_modes():
                out[0].view(-1)[0] = float("nan")
            return out

        nan_dvalues.launches = 0
        bsp.spmm_t2 = nan_dvalues
        try:
            with pytest.raises(FloatingPointError):
                checked(grad_fn)(*batch)
        finally:
            bsp.spmm_t2 = real
        v = torch.ones(batch[3].max_nodes, 8, device=dev)
        bad = batch[3].ell_src.clone()
        bad[0, 0] = batch[3].max_nodes
        with pytest.raises(IndexError):
            checked(lambda x, i: x[i])(v, bad)
        g2, _ = checked(grad_fn)(*batch)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(g0, g2))
