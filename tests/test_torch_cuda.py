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
