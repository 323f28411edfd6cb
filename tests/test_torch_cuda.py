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
    with pytest.raises(NotImplementedError, match="backward"):
        bsp.fused_attention(x.requires_grad_(), x, x, g.ell_src, g.ell_mask)
