"""AttFuse (``fusion="attfuse"``): per-pixel cross-robot attention at
every encoder stage.

On the CPU, at a tiny size with seeded weights: the port's whole network
against the benchmark's plain reference (``perfbench/reference/
attfuse.py``), outputs and every parameter's gradient, on an ELL, a
block-diagonal and a radius batch; one module against
``scaled_dot_product_attention`` over the agent axis; a robot alone and
the padded slots; planted faults that the comparison catches; the train
step and the Predictor; the refusals. The card tests (marker ``cuda``)
hold the kernels against the plain form at ``dense_swarm``'s sizes; run
them on the card with
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_attfuse.py -m cuda
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.graph import (batch_homogeneous, build_graph_batch,
                                     fully_connected_edges, radius_edges)
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.fusion import AttFuse
from mrp_gnn_tpu_torch.ops import attfuse as A
from mrp_gnn_tpu_torch.ops import bsp
from perfbench import weights
from perfbench.reference import attfuse as RA
from perfbench.reference.graph import RefGraph

SIZE = 16
CHANNELS = (8, 16, 16)
_FUSE = RA.attfuse   # the reference's block, which the faults wrap


def _cfg(**model):
    cfg = get_config("dynamic_swarm")
    m = dict(image_size=(SIZE, SIZE), encoder_channels=CHANNELS,
             fusion="attfuse", num_fusion_layers=len(CHANNELS))
    m.update(model)
    return cfg.replace(model=dataclasses.replace(cfg.model, **m),
                       parallel=dataclasses.replace(cfg.parallel,
                                                    ops_impl="xla"))


def _model_dict(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg.model).items()}


def _ref_graph(g) -> RefGraph:
    m = g.edge_mask
    return RefGraph(g.edge_src[m].long(), g.edge_dst[m].long(), g.node_mask)


def _ell():
    return build_graph_batch([fully_connected_edges(5), radius_edges(6, 2)],
                             [5, 6], max_nodes=16, max_edges=64)


def _block():
    g = batch_homogeneous(2, 4, fully_connected_edges(4), max_nodes=16)
    assert g.scene_stride == 4
    return g


def _radius():
    from mrp_gnn_tpu_torch.data.pipeline import DynamicGraphBuilder
    from perfbench.reference.render import scene_world
    cfg = get_config("dynamic_swarm")
    d = dataclasses.replace(cfg.data, num_robots=7, scenes_per_batch=2,
                            max_nodes=16, comm_radius=2, mobility=1.5,
                            graph_builder="numpy")
    pos = [scene_world(7, 1.5, 3, j)["offsets"] for j in range(2)]
    return DynamicGraphBuilder(d, 16, spacing=0.25)(pos)


GRAPHS = {"ell": _ell, "block": _block, "radius": _radius}


def _net_and_params(cfg, seed: int = 5):
    net = MultiRobotPerceptionNet(cfg.model, ops_impl="xla")
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    p = weights.seeded_state_dict(shapes, seed, "cpu")
    net.load_state_dict(p)
    return net, p


def _gap(cfg, g, forward=RA.forward) -> float:
    """The largest gap between the port and ``forward`` (the reference,
    or a planted fault), relative to each tensor's largest magnitude: the
    depth and the logits of real robots and every parameter's gradient
    of their sum."""
    net, p = _net_and_params(cfg)
    images = torch.rand(16, SIZE, SIZE, 3,
                        generator=torch.Generator().manual_seed(2))
    mask = g.node_mask

    def loss(out):
        return (out["depth"][mask].sum()
                + (out["seg_logits"][mask] ** 2).sum() * 0.1)

    want = net(images, g)
    want_g = torch.autograd.grad(loss(want), list(net.parameters()))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    got = forward(leaves, images, _ref_graph(g), _model_dict(cfg))
    got_g = torch.autograd.grad(loss(got), list(leaves.values()),
                                allow_unused=True)
    pairs = [(got["depth"][mask], want["depth"][mask]),
             (got["seg_logits"][mask], want["seg_logits"][mask])]
    pairs += [(a if a is not None else torch.zeros_like(b), b)
              for a, b in zip(got_g, want_g)]
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
               for a, b in ((a.detach(), b.detach()) for a, b in pairs))


@pytest.mark.parametrize("layout", sorted(GRAPHS))
def test_network_matches_the_reference(layout):
    """(a) outputs and every parameter's gradient, three layouts."""
    g = GRAPHS[layout]()
    assert (g.scene_stride > 0) == (layout == "block")
    assert _gap(_cfg(), g) < 2e-5


def _fault_no_self(p, images, graph, model):
    def fused(x, g):
        V = x.shape[0]
        allowed = torch.zeros(V, V, dtype=torch.bool)
        allowed[g.dst, g.src] = True
        allowed |= torch.diag(~g.node_mask)
        bias = torch.zeros(V, V).masked_fill(~allowed, -math.inf)
        xp = x.permute(2, 3, 0, 1).reshape(-1, V, x.shape[1])
        a = torch.softmax(xp @ xp.transpose(1, 2) / math.sqrt(x.shape[1])
                          + bias, dim=-1)
        y = (a @ xp).reshape(x.shape[2], x.shape[3], V, -1).permute(2, 3, 0, 1)
        return y * g.node_mask[:, None, None, None]
    return _with_fusion(fused, p, images, graph, model)


def _fault_no_scale(p, images, graph, model):
    def fused(x, g):
        return _FUSE(x * math.sqrt(math.sqrt(x.shape[1])), g) / \
            math.sqrt(math.sqrt(x.shape[1]))
    return _with_fusion(fused, p, images, graph, model)


def _fault_first_scale_unfused(p, images, graph, model):
    calls = []

    def fused(x, g):
        calls.append(1)
        return x * g.node_mask[:, None, None, None] if len(calls) == 1 \
            else _FUSE(x, g)
    return _with_fusion(fused, p, images, graph, model)


def _with_fusion(fused, p, images, graph, model):
    RA.attfuse = fused
    try:
        return RA.forward(p, images, graph, model)
    finally:
        RA.attfuse = _FUSE


@pytest.mark.parametrize("fault", [_fault_no_self, _fault_no_scale,
                                   _fault_first_scale_unfused])
def test_planted_faults_fail_by_a_wide_margin(fault):
    """(d) the self pair left out, the 1/sqrt(C) dropped (the logits
    scaled by sqrt(C): x by C^(1/4)), the 32x32 scale not fused."""
    assert _gap(_cfg(), _ell(), forward=fault) > 1e-2


def test_one_module_is_sdpa_over_the_agents():
    """(b) on a fully connected graph, per pixel, q = k = v = x and scale
    1/sqrt(C): torch's scaled_dot_product_attention over the agent axis."""
    g = batch_homogeneous(1, 6, fully_connected_edges(6))
    x = torch.randn(6, 16, 4, 4, generator=torch.Generator().manual_seed(3))
    y = AttFuse()(x, g)
    xp = x.permute(2, 3, 0, 1).reshape(16, 6, 16)
    want = F.scaled_dot_product_attention(xp, xp, xp)
    torch.testing.assert_close(
        y, want.reshape(4, 4, 6, 16).permute(2, 3, 0, 1), rtol=1e-5,
        atol=1e-6)


def test_a_robot_alone_gets_its_map_and_padding_is_zero():
    """(c) a scene of one robot among a team of four in 8 slots."""
    alone = np.zeros((2, 0), np.int32)
    g = build_graph_batch([fully_connected_edges(4), alone], [4, 1],
                          max_nodes=8, max_edges=16)
    x = torch.randn(8, 16, 2, 2, generator=torch.Generator().manual_seed(4))
    y = AttFuse()(x, g)
    assert torch.equal(y[4], x[4])
    assert bool((y[5:] == 0).all())
    assert not torch.allclose(y[:4], x[:4])


def _tiny_train_cfg():
    cfg = _cfg()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(SIZE, SIZE),
                                 num_robots=5, scenes_per_batch=2,
                                 num_train_scenes=4, num_eval_scenes=2,
                                 renderer="numpy", graph_builder="numpy",
                                 max_nodes=16),
        parallel=dataclasses.replace(cfg.parallel, ops_impl="auto"))


def test_train_step_and_predictor_run_it():
    """(e) two steps of ``make_train_step`` move every parameter and give
    a finite loss; the Predictor answers."""
    from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
    from mrp_gnn_tpu_torch.serving import Predictor
    cfg = _tiny_train_cfg()
    torch.manual_seed(0)
    state = TT.create_train_state(cfg, "cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    step = TT.make_train_step(cfg, state.model, state.optimizer)
    it = make_train_iterator(cfg.data)
    try:
        for _ in range(2):  # the schedule's first rate is 0
            batch = TT.batch_to_device(next(it), "cpu")
            state, terms = step(state, *batch)
    finally:
        it.close()
    assert math.isfinite(float(terms["total"]))
    assert all(not torch.equal(a, b.detach())
               for a, b in zip(before, state.model.parameters()))
    pred = Predictor(cfg, state.model, graph=batch[-1], device="cpu")
    out = pred(np.random.default_rng(0).uniform(
        size=pred.input_shape).astype(np.float32))
    assert out["depth"].shape == (16, SIZE, SIZE)
    assert np.isfinite(out["depth"]).all()


def test_wrong_layer_count_and_a_shard_are_refused():
    """(f) one AttFuse per encoder stage; one device only."""
    with pytest.raises(ValueError, match="num_fusion_layers must be 3"):
        MultiRobotPerceptionNet(_cfg(num_fusion_layers=1).model)
    x = torch.zeros(16, 8, 2, 2)
    with pytest.raises(ValueError, match="one device"):
        AttFuse()(x, _ell(), shard=object())
    with pytest.raises(ValueError, match="one device"):
        AttFuse()(x, dataclasses.replace(_ell(), partition_plan=object()))


def test_the_plain_route_launches_nothing():
    bsp.reset_launches()
    AttFuse(ops_impl="pallas")(torch.rand(16, 16, 4, 4), _ell())
    assert set(bsp.launch_counts().values()) == {0}


# --- on the card -------------------------------------------------------------

DENSE_SCALES = ((32, 32), (16, 64), (8, 128))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _dense_graph():
    """dense_swarm's batch: 2 fully connected scenes of 193 robots in 512
    slots (ELL width 192)."""
    return build_graph_batch([fully_connected_edges(193)] * 2, [193, 193],
                             max_nodes=512, max_edges=2 * 193 * 192)


def _sparse_graph():
    """Scenes of other sizes in 200 slots (no multiple of 64), a robot
    alone, a radius graph."""
    return build_graph_batch(
        [fully_connected_edges(70), np.zeros((2, 0), np.int32),
         radius_edges(90, 5)], [70, 1, 90], max_nodes=200, max_edges=8192)


def _plain(x, g):
    mask = A.dense_mask(g, x.shape[0])
    xt = x.permute(2, 3, 0, 1).reshape(-1, x.shape[0], x.shape[1])
    y = A.attfuse_reference(xt, mask, g.node_mask)
    h, w = x.shape[2:]
    return y.reshape(h, w, x.shape[0], -1).permute(2, 3, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["dense", "sparse"])
@pytest.mark.parametrize("size,C", DENSE_SCALES + ((8, 16),))
def test_kernels_match_the_plain_form(dev, graph, size, C):
    """(g) forward and backward, chunked plain form beside; the launch
    counts; padded rows 0."""
    g = (_dense_graph() if graph == "dense" else _sparse_graph()).to(dev)
    V = g.node_mask.shape[0]
    gen = torch.Generator(device=dev).manual_seed(size * C)
    x = (torch.randn(V, C, size, size, device=dev, generator=gen) * 0.5
         ).requires_grad_()
    gy = torch.randn(V, C, size, size, device=dev, generator=gen)
    before = bsp.launch_counts()
    y = A.attfuse(x, g, kernels=True)
    (gx,) = torch.autograd.grad(y, x, gy)
    after = bsp.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"attfuse_graph": 1, "attfuse_forward": 1, "attfuse_backward": 2}
    xr = x.detach().requires_grad_()
    want = _plain(xr, g)
    (want_gx,) = torch.autograd.grad(want, xr, gy)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(gx, want_gx, rtol=1e-4, atol=1e-4)
    pad = ~g.node_mask
    assert bool((y[pad] == 0).all()) and bool((gx[pad] == 0).all())


@pytest.mark.cuda
def test_launch_spans_hold_the_kernels(dev):
    """With the recorder on, each call records its two spans, whose
    events the kernels' launcher records: their device time is at most
    the call's stream time, and the slots counter holds its device
    count."""
    from mrp_gnn_tpu_torch.utils import profiling
    g = _dense_graph().to(dev)
    x = torch.rand(512, 32, 32, 32, device=dev).requires_grad_()
    A.attfuse(x, g, kernels=True).sum().backward()  # built and warm
    profiling.reset()
    profiling.enable()
    try:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        A.attfuse(x, g, kernels=True).sum().backward()
        end.record()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    spans = {s["name"]: s["device_ms"] for s in snap["spans"]}
    assert set(spans) == {"fusion.attfuse", "fusion.attfuse_backward"}
    assert all(0 < ms < start.elapsed_time(end) for ms in spans.values())
    (count,) = snap["counts"]
    assert count["n"] == (31 * 64 * 64 - 386) * 32 * 32


@pytest.mark.cuda
def test_a_cuda_ell_batch_never_takes_the_plain_form(dev):
    """bf16 maps on a CUDA ELL batch run the kernels in f32 and come back
    bf16; a width the kernels are not built for raises rather than fall
    back to the plain form."""
    g = _dense_graph().to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(512, 64, 8, 8, device=dev, generator=gen) * 0.5).to(
        torch.bfloat16).requires_grad_()
    before = bsp.launch_counts()
    y = A.attfuse(x, g, kernels=True)
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    after = bsp.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"attfuse_graph": 1, "attfuse_forward": 1, "attfuse_backward": 2}
    assert y.dtype == gx.dtype == torch.bfloat16
    want = _plain(x.detach().float(), g).to(torch.bfloat16)
    torch.testing.assert_close(y, want)
    with pytest.raises(ValueError, match="C in"):
        A.attfuse(torch.rand(512, 48, 4, 4, device=dev), g, kernels=True)
