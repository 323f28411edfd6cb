"""The work that the yardstick credits, counted from shapes alone, and the
card's published peaks.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the plain
  reference (``reference/model.py``) on the meta device, at the cell's node
  count, with an empty graph, so the count is the convolutions' and the
  dense layers' and does not depend on who implements them; plus, for the
  attention edge block, whose gathers carry no FLOP formula, 2 E (dk + D)
  a pass over the E valid edges (the logit's dot product and the weighted
  sum of the D-wide values). A backward pass counts twice its forward.
- Bytes, for the fusion layer's roofline: the least traffic, each input and
  weight read once and each output written once (the edge list as two
  int32 a valid edge).
- Peaks: NVIDIA's published figures for one H100 SXM, dense: 67 TFLOP/s in
  float32 outside the tensor cores (the configurations compute in IEEE
  f32) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import model as M
from perfbench.reference.graph import RefGraph

F32_PEAK_FLOPS = 67e12
HBM_PEAK_BYTES = 3.35e12
F32_BYTES = 4


def _meta_params(model: dict) -> dict:
    """The reference's parameters as meta tensors of the model's shapes."""
    c = list(model["encoder_channels"])
    groups = lambda ch: {".weight": (ch,), ".bias": (ch,)}  # noqa: E731
    shapes = {}

    def block(name, cin, cout):
        shapes[name + ".Conv_0.weight"] = (cout, cin, 3, 3)
        for s, shp in groups(cout).items():
            shapes[name + ".GroupNorm_0" + s] = shp

    block("encoder.stem", model["in_channels"], c[0])
    prev = c[0]
    for i, ch in enumerate(c):
        block(f"encoder.down{i}", prev, ch)
        block(f"encoder.res{i}.ConvBlock_0", ch, ch)
        shapes[f"encoder.res{i}.Conv_0.weight"] = (ch, ch, 3, 3)
        for s, shp in groups(ch).items():
            shapes[f"encoder.res{i}.GroupNorm_0" + s] = shp
        prev = ch
    C, dk = c[-1], model["attention_dim"]
    for i in range(model["num_fusion_layers"]):
        f = f"fusion{i}"
        shapes.update({f + ".value.weight": (C, C, 1, 1), f + ".value.bias": (C,),
                       f + ".query.weight": (dk, C), f + ".query.bias": (dk,),
                       f + ".key.weight": (dk, C), f + ".key.bias": (dk,),
                       f + ".update.weight": (C, 2 * C, 1, 1),
                       f + ".update_norm.weight": (C,),
                       f + ".update_norm.bias": (C,)})
    x = C
    for i in reversed(range(len(c))):
        cin = x + (c[i - 1] if i > 0 else 0)
        x = c[max(i - 1, 0)]
        block(f"decoder.up{i}", cin, x)
    shapes["depth_head.out.weight"] = (1, x, 1, 1)
    shapes["depth_head.out.bias"] = (1,)
    k = model["num_seg_classes"]
    shapes["seg_head.out.weight"] = (k, x, 1, 1)
    shapes["seg_head.out.bias"] = (k,)
    return {n: torch.empty(s, device="meta", requires_grad=True)
            for n, s in shapes.items()}


def _empty_graph(num_nodes: int) -> RefGraph:
    idx = torch.zeros(0, dtype=torch.int64, device="meta")
    return RefGraph(idx, idx, torch.ones(num_nodes, dtype=torch.bool,
                                         device="meta"))


def _freeze(model: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in model.items()))


@functools.lru_cache(maxsize=8)
def _dense_counts(frozen: tuple, num_nodes: int) -> tuple:
    """(forward, forward + backward) FLOPs of everything but the edge
    block, at ``num_nodes`` views."""
    model = dict(frozen)
    p = _meta_params(model)
    H, W = model["image_size"]
    images = torch.empty(num_nodes, H, W, model["in_channels"], device="meta")
    graph = _empty_graph(num_nodes)
    with FlopCounterMode(display=False) as fwd:
        out = M.forward(p, images, graph, model)
    with FlopCounterMode(display=False) as both:
        out = M.forward(p, images, graph, model)
        loss = out["depth"].sum() + out["seg_logits"].sum()
        torch.autograd.grad(loss, list(p.values()))
    return fwd.get_total_flops(), both.get_total_flops()


def edge_flops(model: dict, num_edges: int) -> float:
    """One pass of the attention edge block over ``num_edges`` valid edges,
    per fusion layer: 2 E (dk + D), D the flattened bottleneck width."""
    _, C, h, w = M.fusion_input_shape(model, 1)
    return (2.0 * num_edges * (model["attention_dim"] + C * h * w)
            * model["num_fusion_layers"])


def forward_flops(model: dict, num_nodes: int, num_edges: int) -> float:
    return _dense_counts(_freeze(model), num_nodes)[0] + edge_flops(
        model, num_edges)


def step_flops(model: dict, num_nodes: int, num_edges: int) -> float:
    """A training step's forward and backward (the optimizer's elementwise
    update is not counted)."""
    return _dense_counts(_freeze(model), num_nodes)[1] + 3 * edge_flops(
        model, num_edges)


def fusion_work(model: dict, num_nodes: int, num_edges: int,
                backward: bool) -> tuple:
    """(FLOPs, least bytes) of the fusion layers, forward or forward and
    backward, at ``num_nodes`` node slots and ``num_edges`` valid edges."""
    V, C, h, w = M.fusion_input_shape(model, num_nodes)
    dk = model["attention_dim"]
    maps = V * C * h * w * F32_BYTES
    weights = (C * C + C + 2 * (C * dk + dk) + 2 * C * C + 2 * C) * F32_BYTES
    graph = num_edges * 2 * 4 + V          # edge ends and the node mask
    dense = 2 * V * h * w * (C * C + 2 * C * C) + 2 * 2 * V * C * dk
    per_layer_flops = dense + edge_flops(model, num_edges) / model[
        "num_fusion_layers"]
    fwd_bytes = maps + weights + graph + maps          # features in, out
    bwd_bytes = (2 * maps + weights + graph            # grad out, features
                 + maps + weights)                     # grad in, grad weights
    n = model["num_fusion_layers"]
    if backward:
        return 3 * per_layer_flops * n, (fwd_bytes + bwd_bytes) * n
    return per_layer_flops * n, fwd_bytes * n


def least_seconds(flops: float, n_bytes: float) -> float:
    """The roofline's least time: the larger of the operations at the f32
    peak and the bytes at the HBM peak."""
    return max(flops / F32_PEAK_FLOPS, n_bytes / HBM_PEAK_BYTES)


def share_pct(least_s: float, measured_s: float) -> float | None:
    if not measured_s or not math.isfinite(measured_s):
        return None
    return 100.0 * least_s / measured_s
