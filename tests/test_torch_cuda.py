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

from mrp_gnn_tpu_torch.graph import build_graph_batch, radius_edges
from mrp_gnn_tpu_torch.ops import _build, bsp

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
    from mrp_gnn_tpu_torch.ops import ell
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
    from mrp_gnn_tpu_torch.ops import ell
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
    from mrp_gnn_tpu_torch.ops import ell
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
    from mrp_gnn_tpu_torch.ops import ell
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
