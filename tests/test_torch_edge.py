"""The block-diagonal attention (``ops/edge.py``) and the model's
``edge_fusion_fn`` hook against the JAX package on CPU, the Pallas block
kernel in interpret mode as tests/test_pallas_ops.py runs it.

Batches from ``batch_fully_connected``, as tests/test_pallas_ops.py makes
them: 16 scenes of 8, 3 scenes of 5, and 3 scenes of 8 in 40 node slots (a
padded scene). Tolerances, relative to the largest element of each
compared tensor: f32 1e-5 (sums in another order); bf16 values 2^-7, one
bf16 ulp: both sides round q, k, the weights and the output to bf16 at the
same places and sum in f32, in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.config import ModelConfig as JModelConfig
from mrp_gnn_tpu.models.fusion import default_edge_fusion as jax_edge_fusion
from mrp_gnn_tpu.models.net import MultiRobotPerceptionNet as JNet
from mrp_gnn_tpu.ops import pallas_edge as PEdge
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.config import ModelConfig as TModelConfig
from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
from mrp_gnn_tpu_torch.models.net import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp, dispatch, edge

SHAPES = {"16x8": (16, 8, None), "3x5": (3, 5, None),
          "3x8_in_40": (3, 8, 40)}
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# The encoder's first two ConvBlocks (relu(GroupNorm_0(Conv_0(x)))). Their
# ReLU inputs differ from JAX's by up to 1e-5 on the test batch, so a gate
# whose input sits that close to 0 may flip, and one flipped gate moves
# those blocks' gradients by up to 4e-2 of their largest element. The
# gradient test forces JAX's gates into them (:func:`force_jax_gates`).
GATED = ("stem", "down0")


def _close(got, want, rel, name=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=name)


def _inputs(shape, D=256, dk=64, seed=0):
    scenes, robots, max_nodes = SHAPES[shape]
    jgb = jg.batch_fully_connected(scenes, robots, max_nodes=max_nodes)
    tgb = tg.batch_fully_connected(scenes, robots, max_nodes=max_nodes)
    assert tgb.scene_stride == robots
    V = jgb.max_nodes
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(V, dk)).astype(np.float32) for _ in range(2))
    v, ct = (rng.normal(size=(V, D)).astype(np.float32) for _ in range(2))
    return jgb, tgb, q, k, v, ct


@pytest.mark.parametrize("dtype", sorted(REL))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_block_fused_attention_matches_pallas_interpret(shape, dtype):
    """Values and the gradients for q, k and values, against JAX's
    block_fused_attention (the _attn_kernel, its _block_attn_bwd)."""
    jgb, tgb, q, k, v, ct = _inputs(shape)
    jv = jnp.asarray(v).astype(dtype)

    def jax_loss(q, k, v):
        out = PEdge.block_fused_attention(q, k, v, jgb)
        return jnp.sum(out.astype(jnp.float32) * ct)

    want = PEdge.block_fused_attention(jnp.asarray(q), jnp.asarray(k), jv, jgb)
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, jv)

    qt, kt = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    vt = torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_()
    got = edge.block_fused_attention(qt, kt, vt, tgb)
    (got.float() * torch.from_numpy(ct)).sum().backward()

    assert got.dtype == vt.dtype
    _close(got.detach().float(), want.astype(jnp.float32), REL[dtype])
    for name, g, w in zip(("dq", "dk", "dvalues"), (qt.grad, kt.grad, vt.grad),
                          want_grads):
        assert g.dtype == (vt.dtype if name == "dvalues" else torch.float32)
        _close(g.float(), w.astype(jnp.float32), REL[dtype], name)
    pad = ~tgb.node_mask
    assert bool((got[pad] == 0).all())


def test_kernel_function_rounds_as_the_tpu_kernel():
    """With bf16 values the kernel's function rounds q, k and the weights to
    bf16, so it differs from the einsum route (f32 logits and weights);
    with f32 values both agree."""
    _, tgb, q, k, v, _ = _inputs("16x8")
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    plain = dispatch.get_ops("xla").block_fused_attention
    torch.testing.assert_close(edge.block_fused_attention(qt, kt, vt, tgb),
                               plain(qt, kt, vt, tgb), rtol=1e-5, atol=1e-5)
    vb = vt.bfloat16()
    got = edge.block_fused_attention(qt, kt, vb, tgb).float()
    einsum = plain(qt, kt, vb, tgb).float()  # f32: alpha is f32
    assert not torch.equal(got, einsum)
    torch.testing.assert_close(got, einsum, rtol=0.05, atol=0.05)


def test_block_attention_wrapper_on_cpu_runs_the_plain_version():
    _, tgb, q, k, v, _ = _inputs("3x5", D=16)
    q_s, kk = edge._kernel_inputs(*(torch.from_numpy(x) for x in (q, k, v)))
    args = (q_s, kk, torch.from_numpy(v), tgb.node_mask, tgb.scene_adj)
    bsp.reset_launches()
    assert torch.equal(edge.block_attention(*args),
                       edge.block_attention_reference(*args))
    assert bsp.launch_counts()["block_attention"] == 0


def test_with_block_kernel_swaps_only_the_block_attention():
    ops = dispatch.get_ops("pallas")
    swapped = edge.with_block_kernel(ops)
    assert swapped.block_fused_attention is edge.block_fused_attention
    for f in dataclasses.fields(ops):
        if f.name != "block_fused_attention":
            assert getattr(swapped, f.name) == getattr(ops, f.name), f.name
    # dispatch keeps the JAX routing: the block league on the einsum route
    assert ops.block_fused_attention is not edge.block_fused_attention


def _jax_block_swap(ops, *args):
    return jax_edge_fusion(dataclasses.replace(
        ops, block_fused_attention=PEdge.block_fused_attention), *args)


def _net_pair(heads, edge_fn):
    """A small multitask_batched: 2 fully connected scenes of 5, 16x16
    images, encoder 16/32/64, depth and 6 classes; flax weights moved into
    the port's net."""
    kw = dict(image_size=(16, 16), encoder_channels=(16, 32, 64),
              attention_dim=16, attention_heads=heads, num_seg_classes=6)
    jgb = jg.batch_fully_connected(2, 5)
    tgb = tg.batch_fully_connected(2, 5)
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(10, 16, 16, 3)).astype(np.float32)
    jm = JNet(JModelConfig(**kw), ops_impl="pallas",
              edge_fusion_fn=_jax_block_swap)
    params = jm.init(jax.random.PRNGKey(2), images, jgb)
    tm = load_flax_params(
        MultiRobotPerceptionNet(TModelConfig(**kw), ops_impl="pallas",
                                edge_fusion_fn=edge_fn),
        jax.tree.map(np.asarray, params))
    return jm, params, tm, images, jgb, tgb


def force_jax_gates(intermediates, encoder, blocks):
    """Forward hooks that make the ReLUs of the port's encoder ``blocks``
    open where JAX's forward opened them. ``intermediates``: the JAX
    encoder's flax ``capture_intermediates`` (each module's output). A
    ConvBlock is relu(GroupNorm_0(Conv_0(x))): its gate is JAX's GroupNorm
    output > 0; a ResidualBlock is relu(x + GroupNorm_0(Conv_0(
    ConvBlock_0(x)))): its inner gate as a ConvBlock's, its outer gate JAX's
    block output > 0. Returns (hook handles, and per gate the port's ReLU
    input and JAX's reference of the last forward, NCHW)."""
    def nchw(a):
        return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)

    stats, handles = {}, []
    for n in blocks:
        it = intermediates[n]
        if "ConvBlock_0" in it:
            inner = nchw(it["ConvBlock_0"]["GroupNorm_0"]["__call__"][0])
            outer = nchw(it["__call__"][0])

            def hook(block, inputs, _out, n=n, inner=inner, outer=outer):
                x = inputs[0]
                c = block.ConvBlock_0
                pre = c.GroupNorm_0(c.Conv_0(x))
                h = block.GroupNorm_0(block.Conv_0(pre * (inner > 0)))
                stats[f"{n}.ConvBlock_0"] = (pre.detach(), inner)
                stats[n] = ((x + h).detach(), outer)
                return (x + h) * (outer > 0)
        else:
            ref = nchw(it["GroupNorm_0"]["__call__"][0])

            def hook(block, inputs, _out, n=n, ref=ref):
                pre = block.GroupNorm_0(block.Conv_0(inputs[0]))
                stats[n] = (pre.detach(), ref)
                return pre * (ref > 0)
        handles.append(getattr(encoder, n).register_forward_hook(hook))
    return handles, stats


def assert_few_flips(stats, most: int = 4) -> None:
    """At most ``most`` gates per block that the port would have set apart
    from JAX, each with both ReLU inputs within 1e-5 of 0."""
    for n, (mine, ref) in stats.items():
        flipped = (mine > 0) != (ref > 0)
        assert int(flipped.sum()) <= most, (n, int(flipped.sum()))
        assert bool((mine[flipped].abs() < 1e-5).all()
                    and (ref[flipped].abs() < 1e-5).all()), n


@pytest.mark.parametrize("heads", [1, 2])
def test_edge_fusion_hook_with_the_block_kernel_matches_jax(heads):
    """The net with the block kernel swapped in through edge_fusion_fn (as
    bench.py swaps it) against the JAX net built with the same swap:
    activations, and every parameter's gradient of a loss on depth and
    segmentation, to 1e-5 of each tensor's largest element, with JAX's ReLU
    gates forced into the first two encoder blocks; the gates that the port
    would set apart from JAX are few and each has an input within 1e-5 of
    0. The hook runs once per head."""
    calls = []

    def swap(ops, *args):
        calls.append(args[0])
        return default_edge_fusion(edge.with_block_kernel(ops), *args)

    jm, params, tm, images, jgb, tgb = _net_pair(heads, swap)
    rng = np.random.default_rng(3)
    ct_d = rng.normal(size=(10, 16, 16)).astype(np.float32)
    ct_s = rng.normal(size=(10, 16, 16, 6)).astype(np.float32)

    def jax_loss(p):
        out = jm.apply(p, images, jgb)
        return (jnp.sum(out["depth"] * ct_d)
                + jnp.sum(out["seg_logits"] * ct_s)), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    _, state = jm.apply(params, images, jgb, capture_intermediates=True,
                        mutable=["intermediates"])
    handles, gates = force_jax_gates(state["intermediates"]["encoder"],
                                     tm.encoder, GATED)
    got = tm(torch.from_numpy(images), tgb)
    for h in handles:
        h.remove()
    assert_few_flips(gates)
    assert calls == ["attention"] * heads
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key].detach(), want[key], 1e-5, key)
    ((got["depth"] * torch.from_numpy(ct_d)).sum()
     + (got["seg_logits"] * torch.from_numpy(ct_s)).sum()).backward()
    grads = dict(load_flax_params(MultiRobotPerceptionNet(tm.config),
                                  jax.tree.map(np.asarray, jgrads))
                 .named_parameters())
    for name, p in tm.named_parameters():
        if name.endswith("key.bias"):  # its true gradient is 0: noise
            continue
        _close(p.grad, grads[name].detach(), 1e-5, name)


def test_edge_fusion_hook_default_is_the_default_edge_block():
    """edge_fusion_fn None leaves the net as it was: the same outputs as an
    explicit default_edge_fusion."""
    _, _, tm, images, _, tgb = _net_pair(1, None)
    explicit = MultiRobotPerceptionNet(tm.config, ops_impl="pallas",
                                       edge_fusion_fn=default_edge_fusion)
    explicit.load_state_dict(tm.state_dict())
    with torch.no_grad():
        a = tm(torch.from_numpy(images), tgb)
        b = explicit(torch.from_numpy(images), tgb)
    for key in a:
        assert torch.equal(a[key], b[key]), key
