"""The two-kernel attention (``bsp.bsp_attention``: the weights kernel's
plain version, then the SpMM) and the dual transposed SpMM
(``bsp.spmm_t2``, the fused attention's backward) against the JAX package
on CPU, its Pallas kernels in
interpret mode as tests/test_pallas_bsp.py runs them.

Graphs: the ``GRAPHS`` of tests/test_pallas_bsp.py (ELL widths 8, deg <=
16, since ``_col_loop`` unrolls over the width in interpret mode), padded
node slots, and a capacity-padded tile-pair plan. Tolerances: values 1e-5,
gradients 1e-4 (f32 sums in another order, as the JAX tests hold
``B.bsp_attention`` against its oracle); bf16 values 2e-2, as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu import train as JT
from mrp_gnn_tpu.config import get_config as jax_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jax_dataset
from mrp_gnn_tpu.models.fusion import default_edge_fusion as jax_edge_fusion
from mrp_gnn_tpu.ops import pallas_bsp as JB
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp, dispatch
from torch_native_jax import jax_native  # noqa: F401

GRAPHS = {
    "fc_2x8": lambda m: m.batch_fully_connected(2, 8),
    "radius_4x32": lambda m: m.batch_homogeneous(4, 32, m.radius_edges(32, 4)),
    "fc_16x8": lambda m: m.batch_fully_connected(16, 8),
}


def _rand(V, D=24, dk=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, dk)).astype(np.float32),
            rng.normal(size=(V, dk)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32))


def _positions(S, N, seed):
    rng = np.random.default_rng(seed)
    return [np.linspace(0, N - 1, N) + rng.uniform(-1.5, 1.5, N)
            for _ in range(S)]


def _padded_plan_pair(backend):
    """A tight and a capacity-padded (inert pairs) plan of one batch."""
    pos = _positions(4, 32, 3)
    caps = dict(radius=3.0, max_nodes=128, max_edges=2048, max_degree=15)
    build = jg.batch_from_positions if backend == "jax" else tg.batch_from_positions
    kw = {"backend": "numpy"} if backend == "jax" else {}
    return (build(pos, **caps, **kw),
            build(pos, max_bsp_pairs=48, **caps, **kw))


def _jax_weights(q_s, k, gb):
    return JB._weights_forward(
        jnp.asarray(q_s), jnp.asarray(k), gb.ell_src,
        gb.ell_mask.astype(jnp.int32), gb.bsp_pair_dst, gb.bsp_pair_src,
        gb.bsp_pair_first, gb.bsp_pair_last, gb.bsp_tile, True)


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["padded_plan"])
def test_attention_weights_reference_matches_jax_kernel(name):
    """attention_weights (plain on CPU) against _weights_forward, the TPU
    kernel in interpret mode; masked slots and empty rows exactly 0."""
    if name == "padded_plan":
        jgb, tgb = _padded_plan_pair("jax")[1], _padded_plan_pair("torch")[1]
        assert jgb.bsp_pair_dst.shape[0] == 48
    else:
        jgb, tgb = GRAPHS[name](jg), GRAPHS[name](tg)
    q, k, _ = _rand(jgb.max_nodes, seed=1)
    q_s = q * np.float32(1 / np.sqrt(q.shape[1]))
    want = np.asarray(_jax_weights(q_s, k, jgb))
    args = (torch.from_numpy(q_s), torch.from_numpy(k), tgb.ell_src,
            tgb.ell_mask)
    got = bsp.attention_weights(*args)
    assert torch.equal(got, bsp.attention_weights_reference(*args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert bool((got[~tgb.ell_mask] == 0).all())


def _jax_loss(fn, gb, ct):
    return lambda q, k, v: jnp.sum(fn(q, k, v, gb).astype(jnp.float32) * ct)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bsp_attention_matches_jax(name):
    """Values and the gradients for q, k and values against JAX's
    bsp_attention (_weights_kernel and _spmm_kernel, their vjps)."""
    jgb, tgb = GRAPHS[name](jg), GRAPHS[name](tg)
    assert JB.supports(jgb) and bsp.supports(tgb)
    q, k, v = _rand(jgb.max_nodes)
    ct = np.random.default_rng(2).normal(size=v.shape).astype(np.float32)
    want = JB.bsp_attention(*(jnp.asarray(x) for x in (q, k, v)), jgb)
    want_grads = jax.grad(_jax_loss(JB.bsp_attention, jgb, ct),
                          argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = bsp.bsp_attention(*leaves, tgb)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_bsp_attention_padding_and_padded_plan():
    """Padded node slots give exactly 0 and leave the valid rows as they
    are; a capacity-padded plan gives the tight plan's values, as JAX's
    two-kernel form does on it."""
    small = tg.batch_fully_connected(2, 8)
    padded = tg.batch_fully_connected(2, 8, max_nodes=32)
    q, k, v = (torch.from_numpy(x) for x in _rand(32))
    out = bsp.bsp_attention(q, k, v, padded)
    assert bool((out[16:] == 0).all())
    torch.testing.assert_close(out[:16], bsp.bsp_attention(q[:16], k[:16],
                                                           v[:16], small),
                               rtol=1e-5, atol=1e-5)
    (jt, jp), (tt, tp) = _padded_plan_pair("jax"), _padded_plan_pair("torch")
    q, k, v = _rand(128, seed=4)
    want = JB.bsp_attention(*(jnp.asarray(x) for x in (q, k, v)), jp)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = bsp.bsp_attention(qt, kt, vt, tp)
    assert torch.equal(got, bsp.bsp_attention(qt, kt, vt, tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bsp_attention_bf16_values():
    """bf16 values: output and value gradient in bf16 against JAX's
    bsp_attention on the same bf16 values."""
    jgb, tgb = jg.batch_fully_connected(2, 8), tg.batch_fully_connected(2, 8)
    q, k, v = _rand(16, D=256)
    ct = np.random.default_rng(5).normal(size=v.shape).astype(np.float32)
    jv = jnp.asarray(v).astype(jnp.bfloat16)
    want = JB.bsp_attention(jnp.asarray(q), jnp.asarray(k), jv, jgb)
    want_grads = jax.grad(_jax_loss(JB.bsp_attention, jgb, ct),
                          argnums=(0, 1, 2))(q, k, jv)
    qt, kt = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    vt = torch.from_numpy(v).bfloat16().requires_grad_()
    got = bsp.bsp_attention(qt, kt, vt, tgb)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(ct)).sum().backward()
    assert vt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    for leaf, w in zip((qt, kt, vt), want_grads):
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2e-2,
                                   atol=2e-2)


def test_bsp_weights_gradient_matches_autograd_of_the_plain_version():
    """BspWeights' backward (the _bsp_weights vjp) against torch autograd
    through attention_weights_reference, on a graph with duplicate edges,
    an empty row and padded nodes."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    g = tg.build_graph_batch([a, tg.radius_edges(10, 3)], [6, 10],
                             max_nodes=32, max_edges=128)
    q, k, _ = _rand(32, seed=6)
    ct = torch.from_numpy(np.random.default_rng(7).normal(
        size=g.ell_src.shape).astype(np.float32))
    grads = []
    for fn in (bsp.BspWeights.apply, bsp.attention_weights_reference):
        qq, kk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
        (fn(qq, kk, g.ell_src, g.ell_mask) * ct).sum().backward()
        grads.append((qq.grad, kk.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_spmm_t2_reference_matches_jax_kernel():
    """spmm_t2 (plain on CPU) against _spmm_t2_forward, the TPU kernel in
    interpret mode, at the shapes of tests/test_pallas_bsp.py."""
    jgb = jg.batch_homogeneous(2, 16, jg.radius_edges(16, 5), max_nodes=64)
    tgb = tg.batch_homogeneous(2, 16, tg.radius_edges(16, 5), max_nodes=64)
    V, deg = tgb.ell_src.shape
    rng = np.random.default_rng(0)
    # 0 on masked slots, as a softmax or its gradient is: the JAX kernel
    # sums every slot of its plan, the port's the valid ones
    mask = tgb.ell_mask
    w1 = rng.uniform(size=(V, deg)).astype(np.float32) * mask.numpy()
    w2 = rng.normal(size=(V, deg)).astype(np.float32) * mask.numpy()
    x1 = rng.normal(size=(V, 32)).astype(np.float32)
    x2 = rng.normal(size=(V, 8)).astype(np.float32)
    plan_t = (jgb.bsp_pair_dst_t, jgb.bsp_pair_src_t, jgb.bsp_pair_first_t,
              jgb.bsp_pair_last_t)
    want = JB._spmm_t2_forward(
        *(jnp.asarray(x) for x in (w1, x1, w2, x2)), jgb.ell_src, *plan_t,
        jgb.bsp_tile, True, out_rows=V, out1_dtype=jnp.float32,
        out2_dtype=jnp.float32)
    got = bsp.spmm_t2(*(torch.from_numpy(x) for x in (w1, x1, w2, x2)),
                      tgb.ell_src, mask, V)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    singles = [bsp.spmm_t(torch.from_numpy(w), torch.from_numpy(x),
                          tgb.ell_src, mask, V) for w, x in ((w1, x1), (w2, x2))]
    for g, s in zip(got, singles):
        assert torch.equal(g, s)


def two_sweeps(monkeypatch, calls: list):
    """Replace bsp.spmm_t2 with two bsp.spmm_t calls, the JAX backwards'
    two sweeps, recording the calls of both in ``calls``."""
    spmm_t, spmm_t2 = bsp.spmm_t, bsp.spmm_t2

    def single(*args, **kw):
        calls.append("spmm_t")
        return spmm_t(*args, **kw)

    def dual(w1, x1, w2, x2, src, mask, num_rows, out1_dtype=None,
             out2_dtype=None, view=None):
        calls.append("spmm_t2")
        return spmm_t2(w1, x1, w2, x2, src, mask, num_rows, out1_dtype,
                       out2_dtype, view)

    def separate(w1, x1, w2, x2, src, mask, num_rows, out1_dtype=None,
                 out2_dtype=None, view=None):
        return (single(w1, x1, src, mask, num_rows, out1_dtype, view),
                single(w2, x2, src, mask, num_rows, out2_dtype, view))

    separate.launches = dual.launches = single.launches = 0
    monkeypatch.setattr(bsp, "spmm_t", single)
    monkeypatch.setattr(bsp, "spmm_t2", dual)
    return lambda: monkeypatch.setattr(bsp, "spmm_t2", separate)


@pytest.mark.parametrize("graph", ["square", "expanded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_backward_gives_the_two_sweep_gradients(graph, dtype,
                                                     monkeypatch):
    """The fused attention's backward takes dvalues and dk from one
    spmm_t2 call, and gives the gradients of two spmm_t sweeps, over a
    tile-pair plan and over the row-expanded view (2 rows of 72)."""
    gb = (tg.batch_fully_connected(4, 8) if graph == "square"
          else tg.batch_homogeneous(1, 140, tg.fully_connected_edges(140),
                                    max_nodes=256))
    ops = dispatch.get_ops("pallas")
    q, k, v = _rand(gb.max_nodes, D=40, seed=8)
    ct = torch.from_numpy(np.random.default_rng(9).normal(
        size=v.shape).astype(np.float32))
    calls = []
    use_two_sweeps = two_sweeps(monkeypatch, calls)
    grads, seen = [], []
    for run in range(2):
        if run:
            use_two_sweeps()
        del calls[:]
        leaves = [torch.from_numpy(q).requires_grad_(),
                  torch.from_numpy(k).requires_grad_(),
                  torch.from_numpy(v).to(dtype).requires_grad_()]
        (ops.ell_attention(*leaves, gb).float() * ct).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
        seen.append(list(calls))
    assert seen == [["spmm_t2"], ["spmm_t", "spmm_t"]]
    for a, b in zip(*grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_swaps_replace_only_the_ell_attention():
    ops = dispatch.get_ops("pallas")
    swapped = bsp.with_bsp_attention(ops)
    for f in dataclasses.fields(ops):
        if f.name != "ell_attention":
            assert getattr(swapped, f.name) == getattr(ops, f.name)
    assert swapped.ell_attention is not ops.ell_attention
    # a batch past the 128-column cap keeps ops' own routing
    gb = tg.batch_homogeneous(1, 140, tg.fully_connected_edges(140),
                              max_nodes=256)
    q, k, v = (torch.from_numpy(x) for x in _rand(256, seed=10))
    assert torch.equal(bsp.with_bsp_attention(ops).ell_attention(q, k, v, gb),
                       ops.ell_attention(q, k, v, gb))


def _small(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(16, 16), num_robots=8,
                                 scenes_per_batch=2, num_train_scenes=8),
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(16, 32, 64)),
        train=dataclasses.replace(cfg.train, learning_rate=1e-3,
                                  warmup_steps=2, steps=100),
        parallel=dataclasses.replace(cfg.parallel, ops_impl="pallas"))


def _jax_two_kernel(ops, *args):
    ops = dataclasses.replace(ops, ell_attention=JB.bsp_attention)
    return jax_edge_fusion(ops, *args)


@pytest.mark.usefixtures("jax_native")
def test_swarm_train_steps_with_the_two_kernel_form_match_jax():
    """Small dynamic_swarm train steps (16x16 images, encoder 16/32/64, 2
    scenes x 8 drifting robots, default renderer and graph builder on both
    sides) with the two-kernel attention swapped in through edge_fusion_fn,
    against the JAX steps with B.bsp_attention swapped in the same way: the
    loss terms and grad norm to 1e-5 relative, and after the second step
    (the first has lr 0) every parameter to 2e-5 (the key bias, whose
    gradient is noise, to 2 x lr)."""
    jcfg, tcfg = _small(jax_config("dynamic_swarm")), _small(get_config("dynamic_swarm"))
    jbs = [b for _, b in zip(range(2), jax_dataset(jcfg.data, "train"))]
    tbs = [b for _, b in zip(range(2), make_dataset(tcfg.data, "train"))]
    state, jmodel = JT.create_train_state(jcfg, jax.random.PRNGKey(0), jbs[0],
                                          edge_fusion_fn=_jax_two_kernel)
    jstep = JT.make_train_step(jcfg, jmodel, JT.make_optimizer(jcfg),
                               donate=False)
    calls = []

    def swap(ops, *args):
        calls.append(args[0])
        return default_edge_fusion(bsp.with_bsp_attention(ops), *args)

    model = load_flax_params(
        MultiRobotPerceptionNet(tcfg.model, ops_impl="pallas",
                                edge_fusion_fn=swap),
        jax.tree.map(np.asarray, state.params))
    opt = TT.make_optimizer(tcfg, model.parameters())
    tstate = TT.TrainState(model, opt)
    tstep = TT.make_train_step(tcfg, model, opt)
    for jb, tb in zip(jbs, tbs):
        assert np.array_equal(np.asarray(jb["images"]), tb["images"])
        assert bsp.supports(tb["graph"])
        state, jterms = jstep(state, jb["images"], jb["depth"], jb["seg"],
                              jb["graph"])
        tstate, terms = tstep(tstate, *(torch.from_numpy(np.asarray(tb[n]))
                                        for n in ("images", "depth", "seg")),
                              tb["graph"])
        jterms = jax.device_get(jterms)
        assert sorted(terms) == sorted(jterms)
        for key in jterms:
            np.testing.assert_allclose(float(terms[key]), float(jterms[key]),
                                       rtol=1e-5, err_msg=key)
    assert calls and set(calls) == {"attention"}
    ref = dict(load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                                jax.tree.map(np.asarray, state.params))
               .named_parameters())
    lr = TT.warmup_cosine_lr(tcfg, 0) + TT.warmup_cosine_lr(tcfg, 1)
    for name, p in model.named_parameters():
        atol = 2 * lr + 1e-12 if name.endswith("key.bias") else 2e-5
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=0,
                                   atol=atol, err_msg=name)
