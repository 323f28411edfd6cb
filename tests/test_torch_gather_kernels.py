"""The value-gather kernels' wrappers, the SpMM (``bsp.spmm``,
``bsp.run_spmm``, ``ell.spmm``; ``csrc/bsp_spmm.cu``) and the masked max
(``ell.masked_max``; ``csrc/ell_max.cu``): the SpMM's form rule and its
index shared with the source, and both plain versions against the JAX
package on the edge-case graphs of the card tests
(tests/ell_cases.py: a swarm of scenes packed into consecutive slots,
sources spread over the whole batch, duplicate edges, rows without an
in-edge, ELL widths 8 to 200).

On the CPU the wrappers run their plain versions; the JAX side runs
``pallas_ell`` in interpret mode at ELL widths up to 32, as its own tests
run it (its kernels unroll over the width), and past that the XLA oracle
of the same function (``reference.ell_aggregate``). The max is compared
bit for bit (a max does not round); the SpMM to 1e-5 of the largest
output in f32 (sums in another order) and to one bf16 ulp of it with bf16
values.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ell_cases
from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.ops import pallas_ell as PE
from mrp_gnn_tpu.ops import reference as JR
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.ops import _build, bsp, ell

INTERPRET_MAX_DEG = 32


def _pair(name):
    args = ell_cases.CASES[name][0]()
    return jg.build_graph_batch(*args), tg.build_graph_batch(*args)


@pytest.mark.parametrize("vec,D,bf16,form,want", [
    (8, 8192, False, None, "vec"),  # f32 in 16-byte rows, wide: the vector form
    (8, 2048, False, None, "vec"),  # one vector block's features
    (8, 2040, False, None, "row"),  # narrower: the row form
    (8, 64, False, None, "row"),    # dq's width
    (8, 8192, True, None, "row"),   # bf16: the row form, fastest there
    (1, 8192, False, None, "row"),  # 4-byte loads: only the row form takes them
    (1, 1030, True, None, "row"),
    (8, 64, False, "vec", "vec"),   # a forced form (the card's checks and A/B)
    (8, 8192, True, "vec", "vec"),
    (8, 8192, False, "row", "row"),
    (1, 1030, False, "row", "row"),
])
def test_spmm_form_rule(vec, D, bf16, form, want):
    assert bsp.SPMM_FORMS[bsp.spmm_form(vec, D, bf16, form)] == want


@pytest.mark.parametrize("vec,form", [(8, "window"), (8, "rows"), (1, "vec")])
def test_spmm_form_raises_for_a_form_the_kernel_does_not_take(vec, form):
    with pytest.raises(ValueError):
        bsp.spmm_form(vec, 8192, False, form)


def test_spmm_forms_match_the_source():
    """SPMM_FORMS names the source's forms in their order: the C entry
    takes forms 0 .. len - 1, form 1 launches the vector kernel and needs
    vec 8, any other the row kernel."""
    src = (_build.CSRC_DIR / "bsp_spmm.cu").read_text()
    assert int(re.search(r"form > (\d+)", src).group(1)) == len(bsp.SPMM_FORMS) - 1
    assert re.findall(r"if \(form == (\d+)\) err = launch_vec", src) == ["1", "1"]
    assert "(form == 1 && vec != 8)" in src
    assert bsp.SPMM_FORMS == ("row", "vec")


def test_run_spmm_never_falls_back():
    """The launching entry takes no CPU tensors, forced form or not: the
    plain path is the wrappers' alone."""
    _, tgb = _pair("duplicates")
    x = torch.ones(tgb.max_nodes, 8)
    w = torch.ones(tgb.ell_src.shape)
    before = (bsp.spmm.launches, ell.spmm.launches)
    for form in (None, "vec"):
        with pytest.raises(RuntimeError, match="no bsp_spmm kernel"):
            bsp.run_spmm(ell.spmm, w, x, tgb.ell_src, tgb.ell_mask, form=form)
    assert (bsp.spmm.launches, ell.spmm.launches) == before


def _operands(jgb, seed):
    V, deg = jgb.ell_src.shape
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(V, deg)).astype(np.float32)
    v = rng.normal(size=(jgb.max_nodes, 24)).astype(np.float32)
    return np.where(np.asarray(jgb.ell_mask), w, 0.0).astype(np.float32), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_spmm_matches_jax_on_edge_cases(case, dtype):
    """ell.spmm and bsp.spmm (the plain version on the CPU) against the JAX
    package's ELL SpMM; rows without a valid slot give 0."""
    jgb, tgb = _pair(case)
    w, v = _operands(jgb, seed=3)
    jv = jnp.asarray(v).astype(dtype)
    if tgb.ell_src.shape[1] <= INTERPRET_MAX_DEG:
        want = PE.ell_spmm(jnp.asarray(w), jv, jgb.ell_src, jgb.ell_mask)
    else:
        want = JR.ell_aggregate(jnp.asarray(w), jv.astype(jnp.float32),
                                jgb.ell_src, jgb.ell_mask, "sum")
    want = np.asarray(want.astype(jnp.float32))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    for fn in (ell.spmm, bsp.spmm):
        got = fn(torch.from_numpy(w), tv, tgb.ell_src, tgb.ell_mask)
        assert got.dtype == tv.dtype
        tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
        empty = ~tgb.ell_mask.any(dim=1)
        assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_masked_max_matches_jax_on_edge_cases_bit_for_bit(case, dtype):
    """ell.masked_max (the plain version on the CPU) against the JAX
    package's ELL max, bit for bit; rows without a valid slot give 0."""
    jgb, tgb = _pair(case)
    _, v = _operands(jgb, seed=5)
    jv = jnp.asarray(v).astype(dtype)
    if tgb.ell_src.shape[1] <= INTERPRET_MAX_DEG:
        want = PE.ell_max(jv, jgb.ell_src, jgb.ell_mask)
    else:
        want = JR.ell_aggregate(None, jv, jgb.ell_src, jgb.ell_mask, "max")
    got = ell.masked_max(torch.from_numpy(v).to(getattr(torch, dtype)),
                         tgb.ell_src, tgb.ell_mask)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
