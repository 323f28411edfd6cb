"""The work counts against ``FlopCounterMode`` and the program's shapes,
at a tiny size on the CPU, and at the configurations' real sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import cells, work
from perfbench.reference import model as M
from perfbench.reference.graph import full_graph

MODEL = {"image_size": [16, 16], "in_channels": 3,
         "encoder_channels": [8, 16, 16], "attention_dim": 8,
         "num_fusion_layers": 1, "num_seg_classes": 6, "norm_groups": 8,
         "min_depth": 0.1, "max_depth": 20.0}


def _params(gen):
    return {k: torch.randn(s, generator=gen, requires_grad=True)
            for k, s in M.param_shapes(MODEL).items()}


def test_meta_parameters_are_the_programs():
    from mrp_gnn_tpu_torch.config import ModelConfig
    from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
    cfg = ModelConfig(image_size=(16, 16), encoder_channels=(8, 16, 16),
                      attention_dim=8, num_seg_classes=6)
    net = MultiRobotPerceptionNet(cfg)
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert M.param_shapes(MODEL) == want


@pytest.mark.parametrize("scenes,robots", [(2, 5), (3, 4)])
def test_counts_match_flop_counter_on_real_tensors(scenes, robots):
    gen = torch.Generator().manual_seed(0)
    p = _params(gen)
    V = scenes * robots
    graph = full_graph(scenes, robots, V)
    images = torch.rand(V, 16, 16, 3, generator=gen)
    E = graph.num_edges
    with FlopCounterMode(display=False) as fwd:
        out = M.forward(p, images, graph, MODEL)
    # the edge block's gathers carry no formula: the counter sees the rest
    assert work.forward_flops(M, MODEL, V, E) == pytest.approx(
        fwd.get_total_flops() + M.edge_flops(MODEL, E))
    with FlopCounterMode(display=False) as both:
        out = M.forward(p, images, graph, MODEL)
        torch.autograd.grad(out["depth"].sum() + out["seg_logits"].sum(),
                            list(p.values()))
    assert work.step_flops(M, MODEL, V, E) == pytest.approx(
        both.get_total_flops() + 3 * M.edge_flops(MODEL, E))


def test_fusion_work_matches_flop_counter():
    gen = torch.Generator().manual_seed(1)
    p = _params(gen)
    V = 10
    graph = full_graph(2, 5, V)
    feats = torch.rand(M.fusion_input_shape(MODEL, V), generator=gen)
    with FlopCounterMode(display=False) as fwd:
        M.fusion(p, "fusion0", feats, graph, MODEL["norm_groups"])
    flops, n_bytes = M.fusion_work(MODEL, V, graph.num_edges, False)
    assert flops == pytest.approx(fwd.get_total_flops()
                                  + M.edge_flops(MODEL, graph.num_edges))
    assert M.fusion_work(MODEL, V, graph.num_edges, True)[0] == 3 * flops
    assert n_bytes > 2 * feats.numel() * 4


@pytest.mark.parametrize("config,V,E,counts", [
    # a swarm batch: V 256 with 1,888 edges
    ("dynamic_swarm", 256, 1888,
     (90904965120.0, 270902956032.0, (1650176000.0, 17056768),
      (4950528000.0, 42766336))),
    # V 512 with 2 x 193 x 192 edges
    ("dense_swarm", 512, 74112,
     (182971318272.0, 545290076160.0, (4461740032.0, 34412032),
      (13385220096.0, 85865472)))])
def test_the_cells_sizes(config, V, E, counts):
    """The counts at the configurations' real sizes, pinned exactly: the
    cells' ``train_mfu``, ``serve_forward_mfu`` and fusion rooflines
    divide by them."""
    doc = cells.load("configs", config)
    ref, model = cells.reference(doc), doc["model"]
    assert (work.forward_flops(ref, model, V, E),
            work.step_flops(ref, model, V, E),
            ref.fusion_work(model, V, E, False),
            ref.fusion_work(model, V, E, True)) == counts


def test_roofline_share():
    assert work.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.share_pct(0.5, 2.0) == pytest.approx(25.0)
    assert work.share_pct(0.5, 0.0) is None
