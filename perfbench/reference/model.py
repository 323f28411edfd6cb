"""The network in plain PyTorch, as a function of a flat state dict.

Per robot view: a CNN encoder (a stem, then per stage a stride-2 conv
block and a residual block; 3x3 convs with 'SAME' padding, GroupNorm with
eps 1e-6, ReLU), one attention message-passing layer over the robot graph
at the bottleneck, a decoder of nearest 2x upsampling with skip
concatenation, and a depth head (scaled sigmoid) and a segmentation head.

The attention layer: values are a 1x1 conv of the bottleneck, flattened
per node in NHWC order; query and key are dense maps of the spatially
pooled bottleneck; each edge's logit is q[dst] . k[src] / sqrt(dk), a
softmax over each destination's incoming edges weights the values of the
sources, and a 1x1 conv of [ego, message] with GroupNorm and ReLU is added
to the ego features, padded node slots zeroed.

Parameter names are the state-dict keys of the measured model, so the
benchmark hands both sides the same dict. The edge block is made of gathers
and index additions only: it carries no FLOP formula, so
:func:`edge_flops` gives its operations from the edge count, which
``work.py`` adds to what ``FlopCounterMode`` counts.

A configuration file names this module as its ``reference`` ("model").
Every reference module provides the same five functions: ``forward``,
``param_shapes``, ``fusion_input_shape``, ``edge_flops`` and
``fusion_work`` (``cells.reference`` refuses one that lacks any).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.graph import RefGraph

GN_EPS = 1e-6
F32_BYTES = 4


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """'SAME' padding for a k x k, stride-s conv: the odd pixel of padding
    goes bottom/right."""
    ih, iw = x.shape[-2:]
    ph = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pw = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def conv(x, w, b=None, stride: int = 1):
    return F.conv2d(same_pad(x, w.shape[-1], stride), w, b, stride=stride)


def group_norm(p: dict, name: str, x, groups: int):
    c = x.shape[1]
    return F.group_norm(x, min(groups, c), p[name + ".weight"],
                        p[name + ".bias"], eps=GN_EPS)


def conv_block(p: dict, name: str, x, groups: int, stride: int = 1):
    y = conv(x, p[name + ".Conv_0.weight"], stride=stride)
    return F.relu(group_norm(p, name + ".GroupNorm_0", y, groups))


def residual_block(p: dict, name: str, x, groups: int):
    h = conv_block(p, name + ".ConvBlock_0", x, groups)
    h = group_norm(p, name + ".GroupNorm_0",
                   conv(h, p[name + ".Conv_0.weight"]), groups)
    return F.relu(x + h)


def edge_attention(q, k, values, graph: RefGraph):
    """Softmax attention over each destination's incoming edges; a node
    without edges receives zeros. q, k [V, dk]; values [V, D]."""
    V = values.shape[0]
    src, dst = graph.src, graph.dst
    logits = (q[dst] * k[src]).sum(-1) / math.sqrt(q.shape[-1])
    # softmax is shift-invariant: the per-row max only keeps exp in range
    top = torch.full((V,), -math.inf, dtype=logits.dtype,
                     device=logits.device)
    top = top.scatter_reduce(0, dst, logits.detach(), "amax")
    ex = torch.exp(logits - top[dst])
    den = torch.zeros(V, dtype=ex.dtype, device=ex.device).index_add(
        0, dst, ex)
    alpha = ex / den[dst]
    return torch.zeros_like(values).index_add(
        0, dst, alpha[:, None] * values[src])


def fusion(p: dict, name: str, feats, graph: RefGraph, groups: int):
    V, C, h, w = feats.shape
    values = conv(feats, p[name + ".value.weight"], p[name + ".value.bias"])
    values = values.permute(0, 2, 3, 1).reshape(V, -1)
    pooled = feats.mean(dim=(2, 3))
    q = F.linear(pooled, p[name + ".query.weight"], p[name + ".query.bias"])
    k = F.linear(pooled, p[name + ".key.weight"], p[name + ".key.bias"])
    msg = edge_attention(q, k, values, graph)
    msg = msg.reshape(V, h, w, C).permute(0, 3, 1, 2)
    fused = conv(torch.cat([feats, msg], dim=1), p[name + ".update.weight"])
    fused = group_norm(p, name + ".update_norm", fused, groups)
    out = feats + F.relu(fused)
    return out * graph.node_mask[:, None, None, None].to(out.dtype)


def forward(p: dict, images, graph: RefGraph, model: dict) -> dict:
    """images [V, H, W, 3] -> {"depth" [V, H, W], "seg_logits" [V, H, W, K]}.
    ``model``: the configuration's model sizes."""
    g = model["norm_groups"]
    stages = len(model["encoder_channels"])
    x = conv_block(p, "encoder.stem", images.permute(0, 3, 1, 2), g)
    skips = []
    for i in range(stages):
        x = conv_block(p, f"encoder.down{i}", x, g, stride=2)
        x = residual_block(p, f"encoder.res{i}", x, g)
        skips.append(x)
    for i in range(model["num_fusion_layers"]):
        x = fusion(p, f"fusion{i}", x, graph, g)
    for i in reversed(range(stages)):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i > 0:
            x = torch.cat([x, skips[i - 1]], dim=1)
        x = conv_block(p, f"decoder.up{i}", x, g)
    lo, hi = model["min_depth"], model["max_depth"]
    raw = conv(x, p["depth_head.out.weight"], p["depth_head.out.bias"])
    seg = conv(x, p["seg_head.out.weight"], p["seg_head.out.bias"])
    return {"depth": lo + (hi - lo) * torch.sigmoid(raw[:, 0]),
            "seg_logits": seg.permute(0, 2, 3, 1)}


def fusion_input_shape(model: dict, num_nodes: int) -> tuple:
    """The bottleneck's shape [V, C, h, w] that the fusion layer takes."""
    stride = 2 ** len(model["encoder_channels"])
    H, W = model["image_size"]
    return (num_nodes, model["encoder_channels"][-1], H // stride, W // stride)


def param_shapes(model: dict) -> dict:
    """{parameter name: shape} of the network at ``model``'s sizes."""
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
    return shapes


def edge_flops(model: dict, num_edges: int) -> float:
    """One pass of the attention edge block over ``num_edges`` valid edges,
    per fusion layer: 2 E (dk + D), D the flattened bottleneck width."""
    _, C, h, w = fusion_input_shape(model, 1)
    return (2.0 * num_edges * (model["attention_dim"] + C * h * w)
            * model["num_fusion_layers"])


def fusion_work(model: dict, num_nodes: int, num_edges: int,
                backward: bool) -> tuple:
    """(FLOPs, least bytes) of the fusion layers, forward or forward and
    backward, at ``num_nodes`` node slots and ``num_edges`` valid edges."""
    V, C, h, w = fusion_input_shape(model, num_nodes)
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
