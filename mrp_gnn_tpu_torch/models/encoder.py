"""Per-robot CNN encoder (port of ``mrp_gnn_tpu/models/encoder.py``).

The layers here run NCHW inside (PyTorch's habit); the network's public
forward takes and returns NHWC like the JAX model (``models/net.py``).
Layers keep their parameters in float32 and compute in ``dtype``, as flax
modules with ``dtype=bfloat16`` do. Submodule names mirror the flax
parameter tree (``Conv_0``, ``GroupNorm_0``, ...), so ``models/transplant``
maps weights by name.

Every layer's forward takes an optional shard context (``shard``: a
``parallel.tp.TensorParallel`` or ``parallel.spatial.SpatialSharding``,
under a mesh with a model axis), to which it hands its computation; with
none (the default) the layer computes as one process does.

Seeded init follows flax's defaults: kernels lecun-normal (truncated
normal, fan-in), biases zeros, GroupNorm scale ones.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax's lecun_normal: truncated normal on [-2, 2] standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's 'SAME' padding for a k x k, stride-s conv on NCHW: the odd pixel
    of padding goes bottom/right (asymmetric for the stride-2 convs)."""
    ih, iw = x.shape[-2:]
    ph = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pw = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding on NCHW input."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            return shard.conv(self, x)
        return self.conv(same_pad(x.to(self.dtype), self.weight.shape[-1],
                                  self.stride))

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution of input padded already."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, stride=self.stride)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W + b, weight stored torch-style [out, in]."""

    def __init__(self, in_f: int, out_f: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            return shard.dense(self, x)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: eps 1e-6 (torch's default is 1e-5), statistics
    in float32, result in ``dtype``."""

    eps = 1e-6

    def __init__(self, num_groups: int, ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(ch))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(ch))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            return shard.group_norm(self, x)
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         eps=self.eps)
        return y.to(self.dtype)


class ConvBlock(nn.Module):
    """3x3 conv (no bias) -> GroupNorm -> ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 norm_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, 3, stride, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(min(norm_groups, features), features,
                                     dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return F.relu(self.GroupNorm_0(self.Conv_0(x, shard), shard))


class ResidualBlock(nn.Module):
    def __init__(self, features: int, norm_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(features, features, 1, norm_groups, dtype)
        self.Conv_0 = Conv(features, features, 3, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(min(norm_groups, features), features,
                                     dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        h = self.GroupNorm_0(self.Conv_0(self.ConvBlock_0(x, shard), shard),
                             shard)
        return F.relu(x + h)


class Encoder(nn.Module):
    """Stem + downsampling residual stages.

    Input [V, 3, H, W]; returns (skips, bottleneck): the per-stage features
    [V, C_s, H/2^s, W/2^s] for s = 1..num_stages, and the last of them.
    """

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 in_channels: int = 3, norm_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = len(channels)
        self.stem = ConvBlock(in_channels, channels[0], 1, norm_groups, dtype)
        prev = channels[0]
        for i, ch in enumerate(channels):
            self.add_module(f"down{i}",
                            ConvBlock(prev, ch, 2, norm_groups, dtype))
            self.add_module(f"res{i}", ResidualBlock(ch, norm_groups, dtype))
            prev = ch

    def forward(self, x: torch.Tensor, shard=None):
        x = self.stem(x, shard)
        skips = []
        for i in range(self.num_stages):
            x = getattr(self, f"down{i}")(x, shard)
            x = getattr(self, f"res{i}")(x, shard)
            skips.append(x)
        return skips, x
