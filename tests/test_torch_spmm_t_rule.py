"""The transposed SpMM's form rule (``bsp.spmm_t_form``) on the shapes the
paths give it, its forcing hook and the alignment it asks of the index,
on the CPU: the kernels themselves run only on the card
(tests/test_torch_cuda.py), where the staged form is held bit for bit
against the per-edge form."""

import numpy as np
import pytest
import torch

from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.ops import bsp


def _form(V, Vs, deg, aligned=True, form=None):
    return bsp.SPMM_T_FORMS[bsp.spmm_t_form(V, Vs, deg, aligned, form)]


def test_the_swarm_batch_takes_the_staged_form():
    """dynamic_swarm's first train batch (the attention, mean and bsp2
    paths' transposed SpMMs, and the spatial path's rows over the same
    nodes): ELL width 32 (teams of 32 robots), 256 node slots, aligned
    lists: the staged form, whose launch builds no source view."""
    cfg = get_config("dynamic_swarm")
    g = next(iter(make_dataset(cfg.data, "train")))["graph"]
    V, deg = g.ell_src.shape
    assert (V, deg) == (256, 32)
    assert bsp._aligned16(g.ell_src, g.ell_mask)
    assert _form(V, g.max_nodes, deg) == "staged"


@pytest.mark.parametrize("V,Vs,deg,want", [
    (256, 256, 32, "staged"),      # the swarm's lists
    (32, 96, 32, "staged"),        # a partitioned shard: its rows, halo sources
    (100, 50, 12, "staged"),       # fewer sources than rows
    (512, 512, 192, "tiled"),      # the hideg backward's node view
    (256, 256, bsp.STAGED_MAX_DEG, "staged"),
    (256, 256, bsp.STAGED_MAX_DEG + 1, "per-edge"),
    (512, 512, 48, "per-edge"),    # teams of 49: chains of 48 (PERF.md)
    (256, 256, 63, "per-edge"),    # the widest below the tiled form
    (256, 256, 64, "tiled"),
    (bsp.STAGED_MAX_NODES, bsp.STAGED_MAX_NODES, 7, "staged"),
    (bsp.STAGED_MAX_NODES + 1, bsp.STAGED_MAX_NODES, 7, "per-edge"),
    (bsp.STAGED_MAX_NODES, bsp.STAGED_MAX_NODES + 1, 7, "per-edge"),
    (8192, 8192, 7, "per-edge"),   # benchmark.py's train_edge block
    (8192, 4096, 200, "per-edge"),  # too wide for both other forms
])
def test_form_rule_on_shapes(V, Vs, deg, want):
    assert _form(V, Vs, deg) == want
    # the tiled side is the SDDMM's rule, so both take the tiled form
    # together
    assert (want == "tiled") == bsp.tiled_form(V, Vs, deg)


def test_unaligned_lists_keep_the_per_edge_form():
    assert _form(256, 256, 32, aligned=False) == "per-edge"
    assert _form(512, 512, 192, aligned=False) == "tiled"


@pytest.mark.parametrize("form", bsp.SPMM_T_FORMS)
def test_a_forced_form_is_taken_at_any_shape(form):
    for V, Vs, deg in ((256, 256, 32), (512, 512, 192), (8192, 8192, 7)):
        assert _form(V, Vs, deg, form=form) == form


def test_forcing_refuses_an_unknown_form_and_unaligned_staged_lists():
    with pytest.raises(ValueError, match="unknown"):
        bsp.spmm_t_form(256, 256, 32, form="dense")
    with pytest.raises(ValueError, match="16-byte aligned"):
        bsp.spmm_t_form(256, 256, 32, aligned=False, form="staged")


def test_aligned16_reads_each_tensors_start():
    src = torch.zeros(64, 8, dtype=torch.int32)
    mask = torch.zeros(64, 8, dtype=torch.bool)
    assert bsp._aligned16(src, mask)
    assert not bsp._aligned16(src.view(-1)[1:])    # 4 bytes in
    assert not bsp._aligned16(src, mask.view(-1)[8:])
    assert bsp._aligned16(mask.view(-1)[16:], src.view(-1)[4:])


def test_cpu_wrappers_build_no_view(monkeypatch):
    """On CPU tensors the wrappers run the plain version: no source view,
    whatever the rule would take on the card."""
    monkeypatch.setattr(bsp, "source_view", lambda *a: pytest.fail(
        "source_view called"))
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, 40, size=(30, 5)).astype(np.int32))
    mask = torch.from_numpy(rng.random((30, 5)) < 0.8)
    w = torch.from_numpy(rng.random((30, 5)).astype(np.float32))
    x1 = torch.from_numpy(rng.normal(size=(30, 6)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    one = bsp.spmm_t(w, x1, src, mask, 40)
    dual = bsp.spmm_t2(w, x1, w, x2, src, mask, 40)
    assert torch.equal(dual[0], one)
    torch.testing.assert_close(dual[1], bsp.spmm_t_reference(w, x2, src,
                                                              mask, 40))
