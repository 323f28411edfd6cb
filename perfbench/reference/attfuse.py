"""The network with AttFuse at every encoder stage, in plain PyTorch, as a
function of a flat state dict.

AttFuse is the attentive intermediate fusion of OPV2V (Xu, Xiang, Gao,
Han, Li, Ma, ICRA 2022, arXiv:2109.07644), as OpenCOOD computes it
(``opencood/models/fuse_modules/self_attn.py``, ``AttFusion``): the
stack of the connected agents' maps [n, C, H, W] viewed as [H W, n, C],
then per location p ``ScaledDotProductAttention`` with q = k = v = x and
no learned projection:

    y_i,p = sum over j in {i} u N(i) of
            softmax_j(<x_i,p, x_j,p> / sqrt(C)) x_j,p

``AttBEVBackbone`` (``opencood/models/sub_modules/att_bev_backbone.py``)
applies one such fusion at each backbone level: the fused map goes to
that level's up-sampling branch, the next level takes the unfused map.
Here: the encoder of ``model.py`` (a stem, then per stage a stride-2 conv
block and a residual block), one AttFuse on each stage's output, the
decoder of ``model.py`` on the fused skips and the fused bottleneck, and
its depth and segmentation heads. The fusion has no parameters.

Departures from the published model:

- it sits on an image encoder's stages, not on a LiDAR BEV backbone;
- every robot is an ego, every row is kept (OpenCOOD keeps row 0 of each
  sample);
- a robot attends to itself and its graph neighbours, as a set; on a
  fully connected team that is every agent, as in OPV2V;
- no pose warping and no compression: the views carry no pose transform.

Every pass runs under ``perfbench.reference.numerics`` ("ieee": float32
matmuls and cuDNN convolutions without TF32; the control's "tf32" is the
one exception), as the drivers and ``calibrate.py`` call it; this module
sets no process-wide switch, since the legacy ``allow_tf32`` booleans,
set beside the new per-operator switches that the program pins, make
PyTorch raise.

Padded node slots are zeroed after each fusion. The block is written as
a dense attention over all V node slots per pixel, masked to each
robot's set, in chunks of pixels so that the card holds it, with
elementwise products and sums only: ``FlopCounterMode`` credits it
nothing (its count is the convolutions'), and :func:`edge_flops` gives
its operations from the edge count, 4 C a (pair, pixel) at every scale,
which ``work.py`` adds; the V own pairs are left uncredited.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import model as M
from perfbench.reference.graph import RefGraph

F32_BYTES = 4
CHUNK = 1 << 26   # elements of a chunk's [pixels, V, V, C] products


def attfuse(x, graph: RefGraph):
    """x [V, C, h, w] -> the fused maps, padded slots 0."""
    V, C, h, w = x.shape
    allowed = torch.eye(V, dtype=torch.bool, device=x.device)
    allowed[graph.dst, graph.src] = True
    bias = torch.zeros(V, V, dtype=x.dtype, device=x.device).masked_fill(
        ~allowed, -math.inf)
    xp = x.permute(2, 3, 0, 1).reshape(h * w, V, C)
    chunk = max(1, CHUNK // (V * V * C))
    out = []
    for lo in range(0, h * w, chunk):
        xc = xp[lo:lo + chunk]
        logits = (xc[:, :, None, :] * xc[:, None, :, :]).sum(-1)
        a = torch.softmax(logits / math.sqrt(C) + bias, dim=-1)
        out.append((a[..., None] * xc[:, None, :, :]).sum(-2))
    y = torch.cat(out).reshape(h, w, V, C).permute(2, 3, 0, 1)
    return y * graph.node_mask[:, None, None, None].to(y.dtype)


def forward(p: dict, images, graph: RefGraph, model: dict) -> dict:
    """images [V, H, W, 3] -> {"depth" [V, H, W], "seg_logits" [V, H, W, K]}.
    ``model``: the configuration's model sizes."""
    g = model["norm_groups"]
    stages = len(model["encoder_channels"])
    x = M.conv_block(p, "encoder.stem", images.permute(0, 3, 1, 2), g)
    skips = []
    for i in range(stages):
        x = M.conv_block(p, f"encoder.down{i}", x, g, stride=2)
        x = M.residual_block(p, f"encoder.res{i}", x, g)
        skips.append(attfuse(x, graph))
    x = skips[-1]
    for i in reversed(range(stages)):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i > 0:
            x = torch.cat([x, skips[i - 1]], dim=1)
        x = M.conv_block(p, f"decoder.up{i}", x, g)
    lo, hi = model["min_depth"], model["max_depth"]
    raw = M.conv(x, p["depth_head.out.weight"], p["depth_head.out.bias"])
    seg = M.conv(x, p["seg_head.out.weight"], p["seg_head.out.bias"])
    return {"depth": lo + (hi - lo) * torch.sigmoid(raw[:, 0]),
            "seg_logits": seg.permute(0, 2, 3, 1)}


def scales(model: dict) -> list:
    """(pixels, channels) of each fused map, stage by stage."""
    H, W = model["image_size"]
    return [((H >> (i + 1)) * (W >> (i + 1)), c)
            for i, c in enumerate(model["encoder_channels"])]


def fusion_input_shape(model: dict, num_nodes: int) -> tuple:
    """The bottleneck's shape [V, C, h, w], the last fused map."""
    stride = 2 ** len(model["encoder_channels"])
    H, W = model["image_size"]
    return (num_nodes, model["encoder_channels"][-1], H // stride, W // stride)


def param_shapes(model: dict) -> dict:
    """{parameter name: shape}: ``model.py``'s network without fusion
    parameters."""
    return M.param_shapes({**model, "num_fusion_layers": 0})


def edge_flops(model: dict, num_edges: int) -> float:
    """One forward pass of the fusions over ``num_edges`` valid edges: a
    C-wide dot and a C-wide weighted sum a (edge, pixel), 4 E sum P C."""
    return 4.0 * num_edges * sum(P * C for P, C in scales(model))


def fusion_work(model: dict, num_nodes: int, num_edges: int,
                backward: bool) -> tuple:
    """(FLOPs, least bytes) of the fusions, forward or forward and backward
    (twice the forward's operations), at ``num_nodes`` node slots and
    ``num_edges`` valid edges: each map read once and written once (the
    backward reads the maps and their gradients and writes the input
    gradients), and the graph."""
    maps = sum(num_nodes * P * C for P, C in scales(model)) * F32_BYTES
    graph = num_edges * 2 * 4 + num_nodes   # edge ends and the node mask
    flops = edge_flops(model, num_edges)
    fwd_bytes = 2 * maps + graph
    if backward:
        return 3 * flops, fwd_bytes + 3 * maps + graph
    return flops, fwd_bytes
