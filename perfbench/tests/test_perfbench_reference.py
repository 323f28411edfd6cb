"""The plain reference against the program's plain ops, at a tiny size on
the CPU: the forward on a radius graph and on a full one, and three
training steps with the program's optimizer."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import compare, weights
from perfbench.reference import model as M
from perfbench.reference import train as RT
from perfbench.reference.graph import full_graph, radius_graph
from perfbench.reference.render import scene_world

MODEL = {"image_size": [16, 16], "in_channels": 3,
         "encoder_channels": [8, 16, 16], "attention_dim": 8,
         "num_fusion_layers": 1, "num_seg_classes": 6, "norm_groups": 8,
         "min_depth": 0.1, "max_depth": 20.0}


def _program(num_robots: int, scenes: int, max_nodes: int, full: bool):
    from mrp_gnn_tpu_torch.config import get_config
    cfg = get_config("dynamic_swarm")
    data = dict(num_robots=num_robots, scenes_per_batch=scenes,
                image_size=(16, 16), max_nodes=max_nodes, comm_radius=2,
                mobility=1.5, graph_builder="numpy")
    if full:
        data.update(connectivity="full", comm_radius=0, mobility=0.0)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(8, 16, 16),
                                  attention_dim=8),
        data=dataclasses.replace(cfg.data, **data),
        parallel=dataclasses.replace(cfg.parallel, ops_impl="xla"))


def _graphs(cfg, seed: int):
    """The program's graph and the reference's, from the same positions."""
    from mrp_gnn_tpu_torch.data.pipeline import DynamicGraphBuilder
    from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for
    d = cfg.data
    if d.connectivity == "full":
        prog = batch_homogeneous(d.scenes_per_batch, d.num_robots,
                                 scene_edges_for(d.num_robots, "full"),
                                 max_nodes=d.max_nodes)
        return prog, full_graph(d.scenes_per_batch, d.num_robots, d.max_nodes)
    pos = [scene_world(d.num_robots, d.mobility, seed, j)["offsets"]
           for j in range(d.scenes_per_batch)]
    prog = DynamicGraphBuilder(d, d.max_nodes, spacing=0.25)(pos)
    return prog, radius_graph(pos, float(d.comm_radius), d.max_nodes)


@pytest.mark.parametrize("robots,scenes,slots,full", [
    (8, 2, 16, False), (5, 2, 16, True), (6, 3, 20, False)])
def test_forward_matches_the_programs_plain_ops(robots, scenes, slots, full):
    from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
    cfg = _program(robots, scenes, slots, full)
    net = MultiRobotPerceptionNet(cfg.model, ops_impl="xla")
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    p = weights.seeded_state_dict(shapes, 7, "cpu")
    net.load_state_dict(p)
    prog_graph, ref_graph = _graphs(cfg, 3)
    assert int(prog_graph.n_edges) == ref_graph.num_edges
    images = torch.rand(slots, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = net(images, prog_graph)
        got = M.forward(p, images, ref_graph, MODEL)
    mask = ref_graph.node_mask
    torch.testing.assert_close(got["depth"][mask], want["depth"][mask],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["seg_logits"][mask],
                               want["seg_logits"][mask], rtol=1e-5, atol=1e-5)


def test_three_training_steps_match_the_programs_step():
    from mrp_gnn_tpu_torch.train import create_train_state, make_train_step
    cfg = _program(8, 2, 16, False)
    state = create_train_state(cfg, "cpu")
    names = [n for n, _ in state.model.named_parameters()]
    shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
    p0 = weights.seeded_state_dict(shapes, 9, "cpu")
    state.model.load_state_dict(p0)
    step = make_train_step(cfg, state.model, state.optimizer)
    gen = torch.Generator().manual_seed(4)
    batches, losses, grads = [], [], None
    for i in range(3):
        prog_graph, ref_graph = _graphs(cfg, 10 + i)
        images = torch.rand(16, 16, 16, 3, generator=gen)
        depth = torch.rand(16, 16, 16, generator=gen) * 10
        depth[:, :2] = 0.0  # pixels without ground truth
        seg = torch.randint(0, 6, (16, 16, 16), generator=gen)
        state, terms = step(state, images, depth, seg, prog_graph)
        losses.append({k: float(v) for k, v in terms.items()})
        if i == 0:
            grads = {n: m / (1 - RT.B1)
                     for n, m in zip(names, state.optimizer.mu)}
        batches.append((images, depth, seg, ref_graph))
    prog = {"losses": losses, "grads": grads,
            "params": dict(state.model.named_parameters())}
    ref = RT.follow(p0, batches, MODEL, dataclasses.asdict(cfg.train),
                    forward=M.forward)
    for a, b in zip(losses, ref["losses"]):
        for k in ("depth_l1", "seg_ce", "total"):
            assert a[k] == pytest.approx(b[k], rel=1e-5)
    r = compare.train_readings(prog, ref, p0)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4
    assert r["update_gap"] < 1e-2


def test_the_learning_rate_schedule_is_the_programs():
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.train import warmup_cosine_lr
    cfg = get_config("dynamic_swarm")
    tr = dataclasses.asdict(cfg.train)
    for count in (0, 1, 2, 99, 100, 101, 500, 999, 1000, 1500):
        assert RT.learning_rate(tr, count) == pytest.approx(
            warmup_cosine_lr(cfg, count), rel=1e-12, abs=1e-15)


def test_drift_model_is_the_programs():
    from mrp_gnn_tpu_torch.data.synthetic import SceneSpec
    from mrp_gnn_tpu_torch.data.synthetic import scene_positions as prog
    spec = SceneSpec(num_robots=32, num_classes=6, max_baseline=0.25 * 31,
                     mobility=1.5 * 0.25)
    for seed, idx in ((0, 0), (2**32 + 4, 17), (123456789, 511)):
        np.testing.assert_array_equal(
            scene_world(32, 1.5, seed, idx)["offsets"], prog(spec, seed, idx))
