"""The work that the yardstick credits, counted from shapes alone, and the
card's published peaks.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  configuration's plain reference (``reference/<module>.py``, passed in as
  ``ref``) on the meta device, with the parameters of its ``param_shapes``,
  at the cell's node count, with an empty graph, so the count is the
  convolutions' and the dense layers' and does not depend on who
  implements them; plus the reference's ``edge_flops`` for the operations
  that carry no FLOP formula (the attention edge block's gathers). A
  backward pass counts twice its forward.
- Bytes, for the fusion layer's roofline: the reference's ``fusion_work``,
  the least traffic, each input and weight read once and each output
  written once.
- Peaks: NVIDIA's published figures for one H100 SXM, dense: 67 TFLOP/s in
  float32 outside the tensor cores (the configurations compute in IEEE
  f32) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.graph import RefGraph

F32_PEAK_FLOPS = 67e12
HBM_PEAK_BYTES = 3.35e12


def _empty_graph(num_nodes: int) -> RefGraph:
    idx = torch.zeros(0, dtype=torch.int64, device="meta")
    return RefGraph(idx, idx, torch.ones(num_nodes, dtype=torch.bool,
                                         device="meta"))


def _freeze(model: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in model.items()))


@functools.lru_cache(maxsize=8)
def _dense_counts(ref, frozen: tuple, num_nodes: int) -> tuple:
    """(forward, forward + backward) FLOPs that ``FlopCounterMode`` sees in
    the reference module ``ref``, at ``num_nodes`` views."""
    model = dict(frozen)
    p = {n: torch.empty(s, device="meta", requires_grad=True)
         for n, s in ref.param_shapes(model).items()}
    H, W = model["image_size"]
    images = torch.empty(num_nodes, H, W, model["in_channels"], device="meta")
    graph = _empty_graph(num_nodes)
    with FlopCounterMode(display=False) as fwd:
        out = ref.forward(p, images, graph, model)
    with FlopCounterMode(display=False) as both:
        out = ref.forward(p, images, graph, model)
        loss = out["depth"].sum() + out["seg_logits"].sum()
        torch.autograd.grad(loss, list(p.values()))
    return fwd.get_total_flops(), both.get_total_flops()


def forward_flops(ref, model: dict, num_nodes: int, num_edges: int) -> float:
    return _dense_counts(ref, _freeze(model), num_nodes)[0] + ref.edge_flops(
        model, num_edges)


def step_flops(ref, model: dict, num_nodes: int, num_edges: int) -> float:
    """A training step's forward and backward (the optimizer's elementwise
    update is not counted)."""
    return _dense_counts(ref, _freeze(model), num_nodes)[1] + 3 * \
        ref.edge_flops(model, num_edges)


def least_seconds(flops: float, n_bytes: float) -> float:
    """The roofline's least time: the larger of the operations at the f32
    peak and the bytes at the HBM peak."""
    return max(flops / F32_PEAK_FLOPS, n_bytes / HBM_PEAK_BYTES)


def share_pct(least_s: float, measured_s: float) -> float | None:
    if not measured_s or not math.isfinite(measured_s):
        return None
    return 100.0 * least_s / measured_s
