"""Spatial sharding: image rows over the mesh's "model" axis, parameters
replicated. The JAX package has no module for it: a batch's arrays carry a
"model" entry in their image-row dim (``mrp_gnn_tpu/parallel/context.py``)
and GSPMD inserts the halo exchanges of the convolutions. Here the layers
ask :class:`SpatialSharding` for the collectives, all over the model group
(the ranks that share a node block):

- a k x k convolution reads the rows its neighbours hold: :func:`halo_rows`
  brings the rows XLA's SAME padding reads across a shard edge (one row
  from below, and one from above for stride 1; for stride 2 the odd pad
  row goes at the bottom, so none from above), zeros at the image's top and
  bottom; the backward sends each halo row's gradient back to its owner;
- GroupNorm's statistics (:func:`group_stats`): each rank's mean and sum
  of squared deviations per view and group (float32), gathered over the
  group (:func:`model_gather`) and combined as in Chan et al.'s parallel
  variance, which does not cancel where a map's mean dwarfs its spread,
  as a mean square less the squared mean does, for the same one
  collective;
- the fusion's pooled mean is a sum over the group (:func:`model_sum`);
- the backward of both sums the ranks' gradients over the group, since
  every rank normalises or pools its own rows with the shared values;
- nearest upsampling, the 1x1 convolutions, the heads and the edge block
  (on each rank's rows of the bottleneck values) need nothing.

The loss and metric sums and the gradients run over the world
(``Mesh.batch_group``): the pixels of a node block are split over its model
group.

Rank j holds rows ``[H / m * j, H / m * (j + 1))`` of its node block's
images, depth and seg. Every shard must hold whole rows at every stage:
:func:`check_rows` refuses an image height that does not divide by the
model axis times the encoder's total stride (GSPMD pads instead).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch.parallel.mesh import Mesh


def check_rows(image_size, encoder_channels, model_axis_size: int) -> None:
    """Raise ValueError unless every encoder stage's feature map holds whole
    rows on each of ``model_axis_size`` shards (each stride-2 stage halves
    the rows)."""
    H, W = image_size
    for s in range(len(encoder_channels) + 1):
        rows = H / 2 ** s / model_axis_size
        if rows != int(rows) or rows < 1:
            stage = "the input" if s == 0 else f"encoder stage down{s - 1}"
            raise ValueError(
                f"spatial_sharding: {stage}'s feature map of {H >> s} x "
                f"{W >> s} ({H} x {W} images) leaves {rows:g} rows a shard "
                f"over a model axis of {model_axis_size}; the port needs "
                f"whole rows: an image height divisible by "
                f"{model_axis_size * 2 ** len(encoder_channels)}")


class _ModelSum(torch.autograd.Function):
    """Sum over the model group; backward, the sum of the gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g), None


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ModelSum.apply(x, mesh)


class _ModelGather(torch.autograd.Function):
    """[...] -> [m, ...]: every rank's ``x`` over the model group, in model
    order; backward, the sum of the ranks' gradients of this rank's part."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.stack(mesh.all_gather(x, group=mesh.model_group))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g)[ctx.mesh.model_index], None


def model_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ModelGather.apply(x, mesh)


def group_stats(x: torch.Tensor, mesh: Mesh) -> tuple:
    """(mean, variance) over the last dim of ``x`` [..., n] and of every
    rank's ``x`` of the model group (equal n): each rank's mean and sum of
    squared deviations, gathered and combined (Chan et al.)."""
    n = x.shape[-1]
    mean_j = x.mean(-1)
    m2_j = ((x - mean_j[..., None]) ** 2).sum(-1)
    parts = model_gather(torch.stack([mean_j, m2_j]), mesh)
    mean = parts[:, 0].mean(0)
    m2 = (parts[:, 1] + n * (parts[:, 0] - mean) ** 2).sum(0)
    return mean, m2 / (n * mesh.model)


class _HaloRows(torch.autograd.Function):
    """[N, C, h, W] -> [N, C, top + h + bottom, W]: the last ``top`` rows of
    the shard above and the first ``bottom`` rows of the shard below (zeros
    past the image's edges), by one all-gather over the model group."""

    @staticmethod
    def forward(ctx, x, mesh, top, bottom):
        ctx.mesh, ctx.top, ctx.bottom = mesh, top, bottom
        h = x.shape[2]
        edges = torch.cat([x[:, :, :bottom], x[:, :, h - top:]], dim=2)
        parts = mesh.all_gather(edges, group=mesh.model_group)
        j, m = mesh.model_index, mesh.model
        above = (parts[j - 1][:, :, bottom:] if j > 0
                 else x.new_zeros(*x.shape[:2], top, x.shape[3]))
        below = (parts[j + 1][:, :, :bottom] if j < m - 1
                 else x.new_zeros(*x.shape[:2], bottom, x.shape[3]))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        mesh, top, bottom = ctx.mesh, ctx.top, ctx.bottom
        h = g.shape[2] - top - bottom
        # this rank's halo gradients: [rows of the shard above, rows of
        # the shard below]
        parts = mesh.all_gather(torch.cat([g[:, :, :top], g[:, :, top + h:]],
                                          dim=2), group=mesh.model_group)
        dx = g[:, :, top:top + h].clone()
        j, m = mesh.model_index, mesh.model
        if j > 0 and bottom:    # the shard above read my first rows
            dx[:, :, :bottom] += parts[j - 1][:, :, top:]
        if j < m - 1 and top:   # the shard below read my last rows
            dx[:, :, h - top:] += parts[j + 1][:, :, :top]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, mesh: Mesh, top: int,
              bottom: int) -> torch.Tensor:
    return _HaloRows.apply(x, mesh, top, bottom)


class SpatialSharding:
    """The layers' view of image-row sharding over ``mesh``'s model axis
    (``models/*``: each layer with a context calls the method of its
    kind)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.m = mesh.model

    def rows(self, H: int) -> tuple:
        """This rank's [lo, hi) of H image rows."""
        if H % self.m:
            raise ValueError(f"{H} image rows do not divide over a model "
                             f"axis of {self.m}")
        n = H // self.m
        return self.mesh.model_index * n, (self.mesh.model_index + 1) * n

    def shard_state(self, state) -> None:
        """Parameters stay replicated."""

    def full_tensors(self, state):
        return None

    def conv(self, m, x):
        """``m`` (SAME padding) on this rank's rows of the whole map."""
        k, s = m.weight.shape[-1], m.stride
        if k == 1:
            return m(x)
        h, w = x.shape[2] * self.m, x.shape[3]
        ph = max((math.ceil(h / s) - 1) * s + k - h, 0)
        pw = max((math.ceil(w / s) - 1) * s + k - w, 0)
        x = halo_rows(x.to(m.dtype), self.mesh, ph // 2, ph - ph // 2)
        return m.conv(F.pad(x, (pw // 2, pw - pw // 2, 0, 0)))

    def dense(self, m, x):
        return m(x)

    def group_norm(self, m, x):
        """GroupNorm in float32 with the statistics of the whole map: each
        rank's mean and sum of squared deviations, combined over the
        group."""
        xf = x.float().reshape(x.shape[0], m.num_groups, -1)
        mean, var = group_stats(xf, self.mesh)
        y = (xf - mean[..., None]) * torch.rsqrt(var + m.eps)[..., None]
        y = (y.reshape(x.shape) * m.weight[:, None, None]
             + m.bias[:, None, None])
        return y.to(m.dtype)

    def whole(self, y, m):
        return y

    def mean_hw(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        total = model_sum(x.sum(dim=(2, 3), dtype=acc), self.mesh)
        return (total / (x.shape[2] * self.m * x.shape[3])).to(x.dtype)

    def channel_offset(self, m) -> int:
        return 0

    def attention_keys(self, layer, q, k) -> tuple:
        return q, k
