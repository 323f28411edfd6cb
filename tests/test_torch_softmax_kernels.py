"""The softmax kernels' wrappers, the attention weights (``bsp.attention_weights``,
``bsp.run_attention_weights``; ``csrc/bsp_weights.cu``) and the ELL
softmax (``ell.softmax``, ``ell.run_softmax``; ``csrc/ell_softmax.cu``):
each form rule and its indices shared with the source, and both plain
versions against the JAX package on the edge-case graphs of the card tests
(tests/ell_cases.py: a swarm of scenes packed into consecutive slots,
sources spread over the whole batch, duplicate edges, rows without an
in-edge, ELL widths 8 to 200; the weights kernel takes widths up to 128).

On the CPU the wrappers run their plain versions; the JAX side runs
``pallas_ell.ell_softmax`` in interpret mode at ELL widths up to 32, as its
own tests run it, and past that, and for the weights, the XLA oracles of
the same functions (``reference.ell_sddmm``, ``reference.ell_softmax``).
Tolerance 1e-6 absolute on weights in [0, 1] (exp and sums in another
order); masked slots and rows without a valid slot exactly 0.
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


class _Uncounted:
    launches = 0


@pytest.mark.parametrize("dk,aligned,form,want", [
    (64, True, None, "rows"),     # the bsp2 path's dk
    (200, True, None, "rows"),    # 25 loads: one group of 32 lanes
    (256, True, None, "rows"),    # MAX_DK: 32 loads
    (8, True, None, "rows"),
    (36, True, None, "block"),    # not a multiple of 8: 4-byte loads
    (64, False, None, "block"),   # unaligned rows
    (264, True, None, "block"),   # past MAX_DK (the wrapper raises first)
    (64, True, "block", "block"),  # a forced form (the card's checks and A/B)
    (36, False, "block", "block"),
    (64, True, "rows", "rows"),
])
def test_weights_form_rule(dk, aligned, form, want):
    assert bsp.WEIGHTS_FORMS[bsp.weights_form(dk, aligned, form)] == want


@pytest.mark.parametrize("dk,aligned,form", [
    (64, True, "row"), (36, True, "rows"), (64, False, "rows"),
    (264, True, "rows")])
def test_weights_form_raises_for_a_form_the_kernel_does_not_take(dk, aligned,
                                                                   form):
    with pytest.raises(ValueError):
        bsp.weights_form(dk, aligned, form)


def test_weights_forms_match_the_source():
    """WEIGHTS_FORMS names the source's forms in their order: the C entry
    takes forms 0 .. len - 1, form 0 launches the block kernel, form 1 the
    rows kernel and needs dk % 8 == 0 in aligned rows, and only form 1
    writes the logits."""
    src = (_build.CSRC_DIR / "bsp_weights.cu").read_text()
    assert int(re.search(r"form > (\d+)", src).group(1)) == len(bsp.WEIGHTS_FORMS) - 1
    assert "(form == 1 && (dk % 8 != 0 || !aligned))" in src
    assert "(form == 0 && logits != nullptr)" in src
    assert re.search(r"if \(form == 0\) \{\s*weights_kernel<<<", src)
    assert bsp.WEIGHTS_FORMS == ("block", "rows")


def test_run_attention_weights_never_falls_back():
    """The launching entry takes no CPU tensors, forced form or not: the
    plain path is the wrapper's alone."""
    _, tgb = _pair("duplicates")
    q = torch.ones(tgb.max_nodes, 64)
    before = bsp.attention_weights.launches
    for form in (None, "block", "rows"):
        with pytest.raises(RuntimeError, match="no bsp_weights kernel"):
            bsp.run_attention_weights(bsp.attention_weights, q, q, tgb.ell_src,
                                      tgb.ell_mask, form=form)
    assert bsp.attention_weights.launches == before


@pytest.mark.parametrize("deg,form,want", [
    (32, None, "register"),   # the ell path's width: a warp a row
    (1, None, "register"),    # one lane a row, 32 rows a warp
    (12, None, "register"),   # a group of 16 lanes, 4 of them idle
    (30, None, "register"),   # any width: scalar loads need no alignment
    (33, None, "register"),   # a warp a row, two slots in some lanes
    (128, None, "register"),  # REGISTER_MAX_DEG: 4 slots a lane
    (129, None, "loop"),      # past it
    (200, None, "loop"),
    (32, "loop", "loop"),     # a forced form (the card's checks and A/B)
    (200, "loop", "loop"),
    (8, "register", "register"),
])
def test_softmax_form_rule(deg, form, want):
    assert ell.SOFTMAX_FORMS[ell.softmax_form(deg, form)] == want


@pytest.mark.parametrize("deg,form", [(32, "rows"), (129, "register"),
                                      (200, "register")])
def test_softmax_form_raises_for_a_form_the_kernel_does_not_take(deg, form):
    with pytest.raises(ValueError):
        ell.softmax_form(deg, form)


def test_softmax_forms_match_the_source():
    """SOFTMAX_FORMS names the source's forms in their order: the C entry
    takes forms 0 .. len - 1, form 0 launches the loop kernel, form 1 the
    register kernel for widths up to REGISTER_MAX_DEG (32 lanes of kChunks
    slots)."""
    src = (_build.CSRC_DIR / "ell_softmax.cu").read_text()
    assert int(re.search(r"form > (\d+)", src).group(1)) == len(ell.SOFTMAX_FORMS) - 1
    chunks = int(re.search(r"constexpr int kChunks = (\d+);", src).group(1))
    assert "constexpr int kRegisterMaxDeg = 32 * kChunks;" in src
    assert 32 * chunks == ell.REGISTER_MAX_DEG
    assert "(form == 1 && deg > kRegisterMaxDeg)" in src
    assert re.search(r"if \(form == 0\) \{.*?ell_softmax_kernel<<<", src,
                     re.DOTALL)
    assert ell.SOFTMAX_FORMS == ("loop", "register")


def test_run_softmax_never_falls_back():
    _, tgb = _pair("duplicates")
    x = torch.ones(tgb.ell_src.shape)
    before = ell.softmax.launches
    for form in (None, "loop", "register"):
        with pytest.raises(RuntimeError, match="no ell_softmax kernel"):
            ell.run_softmax(ell.softmax, x, tgb.ell_mask, form=form)
    assert ell.softmax.launches == before


def _logits(jgb, dk, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(jgb.max_nodes, dk)).astype(np.float32)
    k = rng.normal(size=(jgb.max_nodes, dk)).astype(np.float32)
    return q * np.float32(1 / np.sqrt(dk)), k


def _assert_softmax_close(got, want, mask):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert bool((got[~mask] == 0).all())
    assert bool((got[~mask.any(dim=1)] == 0).all())


@pytest.mark.parametrize("dk", [36, 64])
@pytest.mark.parametrize("case", [c for c in ell_cases.CASES
                                  if c not in ell_cases.WIDE])
def test_attention_weights_match_jax_on_edge_cases(case, dk):
    """bsp.attention_weights (the plain version on the CPU) against the
    JAX package's logits and masked softmax; duplicate edges count once per
    slot."""
    jgb, tgb = _pair(case)
    q_s, k = _logits(jgb, dk, seed=7)
    want = JR.ell_softmax(JR.ell_sddmm(jnp.asarray(q_s), jnp.asarray(k),
                                       jgb.ell_src, jgb.ell_mask), jgb.ell_mask)
    got = bsp.attention_weights(torch.from_numpy(q_s), torch.from_numpy(k),
                                tgb.ell_src, tgb.ell_mask)
    _assert_softmax_close(got, np.asarray(want), tgb.ell_mask)


@pytest.mark.parametrize("case", list(ell_cases.CASES))
def test_softmax_matches_jax_on_edge_cases(case):
    """ell.softmax (the plain version on the CPU) against the JAX
    package's ELL softmax, on logits spread wide enough that the max
    matters."""
    jgb, tgb = _pair(case)
    V, deg = tgb.ell_src.shape
    x = np.random.default_rng(9).normal(size=(V, deg)).astype(np.float32) * 8
    jfn = PE.ell_softmax if deg <= INTERPRET_MAX_DEG else JR.ell_softmax
    want = np.asarray(jfn(jnp.asarray(x), jgb.ell_mask))
    got = ell.softmax(torch.from_numpy(x), tgb.ell_mask)
    _assert_softmax_close(got, want, tgb.ell_mask)
