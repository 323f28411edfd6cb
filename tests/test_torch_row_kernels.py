"""The per-row kernels' plain versions against the JAX package on the
edge-case graphs that the card tests use (tests/ell_cases.py: a swarm of
scenes packed into consecutive slots, sources spread over every node tile,
duplicate edges, rows without an in-edge, ELL widths 8 to 200), and the
host-side rules and checks of their wrappers (bsp.fused_form and the form
index shared with csrc/bsp_fused_attention.cu).

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode as its own tests do, or, past the fused
kernels' 128 columns, the XLA oracles of the same semantics.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ell_cases
from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu.ops import reference as JR
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.ops import _build, bsp

NARROW = [c for c in ell_cases.CASES if c not in ell_cases.WIDE]


def _pair(name):
    args = ell_cases.CASES[name][0]()
    return jg.build_graph_batch(*args), tg.build_graph_batch(*args)


def _rand(V, *dims, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(V, d)).astype(np.float32) for d in dims]


def _plan(jgb):
    return (jgb.bsp_pair_dst, jgb.bsp_pair_src, jgb.bsp_pair_first,
            jgb.bsp_pair_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", NARROW)
def test_fused_attention_matches_the_jax_kernel_on_edge_cases(case, dtype):
    """The fused forward against pallas_bsp.bsp_attention_fused (interpret
    mode): f32 to 1e-5; bf16 outputs to 2e-2, both sides rounding an f32
    sum; rows without an in-edge exactly 0."""
    jgb, tgb = _pair(case)
    assert JB.supports(jgb) and bsp.supports(tgb)
    q, k, v = _rand(jgb.max_nodes, 16, 16, 40, seed=3)
    want = np.asarray(JB.bsp_attention_fused(q, k, jnp.asarray(v, dtype), jgb),
                      np.float32)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    bsp.reset_launches()
    got = bsp.bsp_attention_fused(torch.from_numpy(q), torch.from_numpy(k), vt,
                                  tgb)
    assert set(bsp.launch_counts().values()) == {0}  # CPU: the plain version
    assert got.dtype == vt.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    empty = ~tgb.ell_mask.any(dim=1)
    assert empty.any() and bool((got[empty] == 0).all())


@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_sddmm_matches_jax_on_edge_cases(case):
    """The SDDMM, single and dual, against pallas_bsp._sddmm_forward
    (interpret mode) within 128 columns and the XLA ell_sddmm past them, on
    the valid slots; masked slots are 0 in the port; the dual form's
    outputs equal two single calls."""
    jgb, tgb = _pair(case)
    q, k, g, v = _rand(jgb.max_nodes, 16, 16, 24, 24, seed=5)
    mask = tgb.ell_mask.numpy()
    if case in ell_cases.WIDE:
        assert not JB.supports(jgb)
        want = np.asarray(JR.ell_sddmm(q, k, jgb.ell_src, jgb.ell_mask))
    else:
        want = np.asarray(JB._sddmm_forward(q, k, jgb.ell_src, *_plan(jgb),
                                            jgb.bsp_tile, True))
    tq, tk, tgr, tv = (torch.from_numpy(x) for x in (q, k, g, v))
    one = bsp.sddmm(tq, tk, tgb.ell_src, tgb.ell_mask)
    dual = bsp.sddmm(tq, tk, tgb.ell_src, tgb.ell_mask, tgr, tv)
    np.testing.assert_allclose(one.numpy()[mask], want[mask], rtol=1e-5,
                               atol=1e-5)
    assert bool((one[~tgb.ell_mask] == 0).all())
    assert torch.equal(dual[0], one)
    assert torch.equal(dual[1], bsp.sddmm(tgr, tv, tgb.ell_src, tgb.ell_mask))


@pytest.mark.parametrize("vec,bf16,form,want", [
    (4, False, None, "vec"),    # f32 values in 16-byte rows: the vector form
    (8, True, None, "row"),     # bf16 values: the row form, fastest there
    (1, False, None, "row"),    # any D: only the row form takes 4-byte loads
    (1, True, None, "row"),
    (8, True, "vec", "vec"),    # a forced form (the card's A/B)
    (4, False, "row", "row"),
    (1, False, "row", "row"),
])
def test_fused_form_rule(vec, bf16, form, want):
    assert bsp.FUSED_FORMS[bsp.fused_form(vec, bf16, form)] == want


@pytest.mark.parametrize("vec,form", [(4, "tiled"), (1, "vec"), (8, "rows")])
def test_fused_form_raises_for_a_form_the_kernel_does_not_take(vec, form):
    with pytest.raises(ValueError):
        bsp.fused_form(vec, False, form)


def test_fused_forms_match_the_source():
    """FUSED_FORMS names the source's forms in their order: the C entry
    takes forms 0 .. len - 1, form 1 launches the vector kernel and any
    other the row kernel."""
    src = (_build.CSRC_DIR / "bsp_fused_attention.cu").read_text()
    assert int(re.search(r"form > (\d+)", src).group(1)) == len(bsp.FUSED_FORMS) - 1
    assert re.findall(r"if \(form == (\d+)\) err = launch_vec", src) == ["1", "1"]
    assert bsp.FUSED_FORMS[:2] == ("row", "vec")


def test_run_fused_attention_never_falls_back():
    """The launching entry takes no CPU tensors: the plain path is the
    wrapper's alone."""
    _, tgb = _pair("duplicates")
    x = torch.ones(tgb.max_nodes, 8)
    before = bsp.fused_attention.launches
    with pytest.raises(RuntimeError, match="no fused attention kernel"):
        bsp.run_fused_attention(bsp.fused_attention, x, x, x, tgb.ell_src,
                                tgb.ell_mask, form="vec")
    assert bsp.fused_attention.launches == before
