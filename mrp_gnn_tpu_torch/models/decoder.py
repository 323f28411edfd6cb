"""Dense prediction decoder with skip connections and depth / seg heads
(port of ``mrp_gnn_tpu/models/decoder.py``). NCHW inside; ``shard`` as in
``models/encoder.py``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrp_gnn_tpu_torch.models.encoder import Conv, ConvBlock


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest resize at exactly 2x: output pixel i reads input i // 2, as
    jax.image.resize(..., "nearest") does at this scale."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Decoder(nn.Module):
    """Mirror of the encoder: per-stage upsample + skip concat.

    Returns full-resolution decoder features [V, C0, H, W].
    """

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 norm_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = len(channels)
        x_ch = channels[-1]
        for i in reversed(range(self.num_stages)):
            in_ch = x_ch + (channels[i - 1] if i > 0 else 0)
            out_ch = channels[max(i - 1, 0)]
            self.add_module(f"up{i}",
                            ConvBlock(in_ch, out_ch, 1, norm_groups, dtype))
            x_ch = out_ch
        self.out_channels = x_ch

    def forward(self, skips: list, bottleneck: torch.Tensor,
                shard=None) -> torch.Tensor:
        x = bottleneck
        # skips[i] has the resolution of stage i's output, so stage i's
        # up-block consumes skips[i-1].
        for i in reversed(range(self.num_stages)):
            x = upsample2x(x)
            if i > 0:
                x = torch.cat([x, skips[i - 1]], dim=1)
            x = getattr(self, f"up{i}")(x, shard)
        return x


class DepthHead(nn.Module):
    """1x1 conv -> scaled sigmoid depth in (min_depth, max_depth)."""

    def __init__(self, in_ch: int, min_depth: float = 0.1,
                 max_depth: float = 20.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.out = Conv(in_ch, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        raw = self.out(x, shard)
        if shard is not None:
            raw = shard.whole(raw, self.out)
        raw = raw[:, 0]
        return self.min_depth + (self.max_depth - self.min_depth) * torch.sigmoid(raw)


class SegHead(nn.Module):
    def __init__(self, in_ch: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out = Conv(in_ch, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        y = self.out(x, shard)
        return y if shard is None else shard.whole(y, self.out)
