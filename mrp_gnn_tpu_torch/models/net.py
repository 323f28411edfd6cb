"""Full multi-robot perception network: encoder -> graph fusion -> decoder
(port of ``mrp_gnn_tpu/models/net.py``).

With ``fusion="attfuse"`` (the port's own, no JAX counterpart) one
parameter-free :class:`AttFuse` per encoder stage, ``fusion{i}`` on stage
i's output, fuses every scale, as OpenCOOD's ``AttBEVBackbone``: the
decoder takes the fused skips and the fused bottleneck, while the encoder
goes on with the unfused maps. It needs ``num_fusion_layers`` equal to the
number of stages.

Forward: (images [V, H, W, 3], GraphBatch) -> dict of dense predictions,
NHWC like the JAX model: "bottleneck", "fused", "decoder" [V, h, w, C],
"depth" [V, H, W] f32 and "seg_logits" [V, H, W, K] f32 (if configured).
With ``config.dtype == "bfloat16"`` the parameters stay float32 and the
layers compute in bfloat16.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from mrp_gnn_tpu_torch.config import ModelConfig
from mrp_gnn_tpu_torch.graph import GraphBatch
from mrp_gnn_tpu_torch.models.decoder import Decoder, DepthHead, SegHead
from mrp_gnn_tpu_torch.models.encoder import Encoder
from mrp_gnn_tpu_torch.models.fusion import AttFuse, GraphFusionLayer


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MultiRobotPerceptionNet(nn.Module):
    """The whole model, with flax-like seeded init from ``generator``
    (parameters are made on the CPU; move the model with ``.to(device)``).
    ``edge_fusion_fn`` goes to every fusion layer (see
    :class:`GraphFusionLayer`); None keeps the default edge block."""

    def __init__(self, config: ModelConfig, ops_impl: str = "xla",
                 generator: torch.Generator | None = None,
                 edge_fusion_fn: Callable | None = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.ops_impl = ops_impl
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        chans = cfg.encoder_channels
        self.encoder = Encoder(chans, cfg.in_channels, cfg.norm_groups, dtype)
        self.num_fusion_layers = (cfg.num_fusion_layers
                                  if cfg.fusion != "none" else 0)
        if cfg.fusion == "attfuse" and cfg.num_fusion_layers != len(chans):
            raise ValueError(
                f"fusion 'attfuse' fuses each of the {len(chans)} encoder "
                f"stages: num_fusion_layers must be {len(chans)}, not "
                f"{cfg.num_fusion_layers}")
        for i in range(self.num_fusion_layers):
            if cfg.fusion == "attfuse":
                self.add_module(f"fusion{i}", AttFuse(ops_impl))
                continue
            self.add_module(f"fusion{i}", GraphFusionLayer(
                chans[-1], aggregation=cfg.fusion,
                attention_dim=cfg.attention_dim,
                attention_heads=cfg.attention_heads,
                norm_groups=cfg.norm_groups, dtype=dtype, ops_impl=ops_impl,
                edge_fusion_fn=edge_fusion_fn))
        self.decoder = Decoder(chans, cfg.norm_groups, dtype)
        c0 = self.decoder.out_channels
        if cfg.predict_depth:
            self.depth_head = DepthHead(c0, cfg.min_depth, cfg.max_depth, dtype)
        if cfg.num_seg_classes > 0:
            self.seg_head = SegHead(c0, cfg.num_seg_classes, dtype)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, images: torch.Tensor, graph: GraphBatch,
                ops_impl: str | None = None, shard=None) -> dict:
        """``ops_impl`` overrides the backend given at construction.
        ``shard``: the model axis's context (``ParallelContext.shard``):
        under tensor parallelism every output is whole; under spatial
        sharding each holds this rank's image rows."""
        cfg = self.config
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        skips, bottleneck = self.encoder(x, shard)
        out = {"bottleneck": _nhwc(bottleneck)}
        fused = bottleneck
        if cfg.fusion == "attfuse":
            skips = [getattr(self, f"fusion{i}")(s, graph, ops_impl, shard)
                     for i, s in enumerate(skips)]
            fused = skips[-1]
        else:
            for i in range(self.num_fusion_layers):
                fused = getattr(self, f"fusion{i}")(fused, graph, ops_impl,
                                                    shard)
        out["fused"] = _nhwc(fused)
        dec = self.decoder(skips, fused, shard)
        out["decoder"] = _nhwc(dec)
        if cfg.predict_depth:
            out["depth"] = self.depth_head(dec, shard).float()
        if cfg.num_seg_classes > 0:
            out["seg_logits"] = _nhwc(self.seg_head(dec, shard)).float()
        return out
