"""Tensor parallelism: output-channel shards of the parameters over the
mesh's "model" axis (port of ``mrp_gnn_tpu/parallel/tp.py``).

The JAX package annotates its parameters with a sharding and lets GSPMD
partition every convolution and matmul and insert the collectives. Here
each rank of a model group holds its shard of every sharded leaf (the
trailing-dim rule of :func:`leaf_shard_dim`, dim 0 of the port's layouts)
and the layers ask :class:`TensorParallel` for the collectives:

- a sharded layer (conv, dense) takes its input whole, the same on every
  rank of the model group, and computes its own output channels. Its
  input passes :func:`enter`: identity forward, and backward the sum of the
  ranks' gradients over the model group, since each rank's gradient of the
  input comes from its own output channels only;
- a GroupNorm after a sharded conv normalises its own channels where the
  shard holds whole groups, then the channels are gathered
  (:func:`gather`: backward, this rank's slice, since what follows is
  computed the same on every rank of the group); where groups straddle
  shards the channels, the scale and the bias are gathered first;
- so every feature map between blocks is whole on every rank: the
  decoder's and the fusion's concatenations see the global channel order,
  and a replicated layer (the depth head) or the loss needs nothing;
- the fusion runs the edge block on the rank's channel slice of the values
  (aggregation is elementwise over the features), with q and k gathered
  and entered, and gathers the message.

A rank's shard of a leaf is rows ``[j * n, (j + 1) * n)`` of dim 0 for
model index j; the parameter carries ``model_shards`` (the model axis
size) as an attribute, so any context of the same mesh knows it. The
optimizer's moments take the same shards (:meth:`TensorParallel.shard_state`,
after the seeded full model is broadcast from rank 0), and a checkpoint
holds whole tensors (:meth:`TensorParallel.full_tensors`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch.parallel.mesh import Mesh


def leaf_shard_dim(shape: tuple, model_axis_size: int) -> int | None:
    """The port's dim to shard for a parameter leaf of JAX ``shape`` (conv
    HWIO, dense (in, out), bias or scale (out,)) under the JAX package's
    rule: its trailing (output-feature) dim, when that divides by the model
    axis and is at least twice it; None (replicated) otherwise. The port
    keeps the output features in dim 0 of every layout."""
    if model_axis_size <= 1 or not shape:
        return None
    last = shape[-1]
    if last % model_axis_size or last < 2 * model_axis_size:
        return None
    return 0


def jax_shape(shape: tuple) -> tuple:
    """The JAX leaf shape of a port parameter: conv [out, in, kh, kw] ->
    (kh, kw, in, out), dense [out, in] -> (in, out), vectors as they are."""
    shape = tuple(shape)
    if len(shape) == 4:
        return shape[2:] + (shape[1], shape[0])
    if len(shape) == 2:
        return shape[::-1]
    return shape


def param_shard_dim(shape: tuple, model_axis_size: int) -> int | None:
    """:func:`leaf_shard_dim` of a parameter in the port's layout."""
    return leaf_shard_dim(jax_shape(shape), model_axis_size)


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "model_shards", 1) > 1


class _Gather(torch.autograd.Function):
    """Channel shards [N, C / m, ...] -> [N, C, ...] on every rank of the
    model group; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = (mesh.model_index * x.shape[1],
                    (mesh.model_index + 1) * x.shape[1])
        return torch.cat(mesh.all_gather(x, group=mesh.model_group), dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[:, lo:hi], None


class _Enter(torch.autograd.Function):
    """Identity forward; backward, the sum over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g), None


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Dim 1 of channel shards, whole (backward: this rank's slice)."""
    return _Gather.apply(x, mesh)


def enter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A whole tensor entering a computation split over the model group
    (backward: the sum of the ranks' gradients)."""
    return _Enter.apply(x, mesh)


class TensorParallel:
    """The layers' view of channel tensor parallelism over ``mesh``'s model
    axis (``models/*``: each layer with a context calls the method of its
    kind)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.m = mesh.model

    # --- the state --------------------------------------------------------

    def _rows(self, n: int) -> slice:
        n //= self.m
        return slice(self.mesh.model_index * n,
                     (self.mesh.model_index + 1) * n)

    def shard_state(self, state) -> None:
        """Cut every sharded leaf of ``state`` (a ``train.TrainState`` whose
        model is whole and equal on every rank) and its moments down to this
        rank's rows, in place."""
        opt = state.optimizer
        index = {id(p): i for i, p in enumerate(opt.params)}
        for p in state.model.parameters():
            if is_sharded(p) or param_shard_dim(p.shape, self.m) is None:
                continue
            rows = self._rows(p.shape[0])
            p.data = p.data[rows].clone()
            p.model_shards = self.m
            i = index[id(p)]
            opt.mu[i] = opt.mu[i][rows].clone()
            opt.nu[i] = opt.nu[i][rows].clone()

    def gather_rows(self, tensors: list) -> list:
        """Each of ``tensors`` (this rank's rows of dim 0) whole, by one
        all-gather over the model group."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        parts = self.mesh.all_gather(flat, group=self.mesh.model_group)
        out, off = [], 0
        for t in tensors:
            n = t.numel()
            out.append(torch.cat([p[off:off + n].view(t.shape)
                                  for p in parts]))
            off += n
        return out

    def full_tensors(self, state) -> tuple:
        """(model state_dict, mu, nu) of ``state`` with every sharded leaf
        whole, as one process holds them; a collective of the model group."""
        opt = state.optimizer
        sd = state.model.state_dict()
        names = [n for n, p in state.model.named_parameters() if is_sharded(p)]
        idx = [i for i, p in enumerate(opt.params) if is_sharded(p)]
        whole = iter(self.gather_rows([sd[n] for n in names]
                                      + [opt.mu[i] for i in idx]
                                      + [opt.nu[i] for i in idx]))
        sd.update({n: next(whole) for n in names})
        mu, nu = list(opt.mu), list(opt.nu)
        for i in idx:
            mu[i] = next(whole)
        for i in idx:
            nu[i] = next(whole)
        return sd, mu, nu

    # --- the layers -------------------------------------------------------

    def conv(self, m, x):
        """A conv on its whole input: its own output channels if sharded."""
        return m(enter(x, self.mesh) if is_sharded(m.weight) else x)

    dense = conv

    def group_norm(self, m, x):
        """GroupNorm of a sharded conv's channels -> the whole map."""
        if not is_sharded(m.weight):
            return m(x)
        if m.num_groups % self.m == 0:  # the shard holds whole groups
            y = F.group_norm(x.float(), m.num_groups // self.m, m.weight,
                             m.bias, eps=m.eps)
            return gather(y.to(m.dtype), self.mesh)
        y = F.group_norm(gather(x, self.mesh).float(), m.num_groups,
                         gather(m.weight[None], self.mesh)[0],
                         gather(m.bias[None], self.mesh)[0], eps=m.eps)
        return y.to(m.dtype)

    def whole(self, y, m):
        """A layer's output ``y``, whole: gathered if ``m`` is sharded."""
        return gather(y, self.mesh) if is_sharded(m.weight) else y

    def mean_hw(self, x):
        return x.mean(dim=(2, 3))

    def channel_offset(self, m) -> int:
        """First global channel of ``m``'s output on this rank."""
        return (self.mesh.model_index * m.weight.shape[0]
                if is_sharded(m.weight) else 0)

    def attention_keys(self, layer, q, k) -> tuple:
        """q and k whole; entered when the edge block runs on a channel
        slice of the values, since each rank's gradient of them then comes
        from its slice alone."""
        q, k = self.whole(q, layer.query), self.whole(k, layer.key)
        if is_sharded(layer.value.weight):
            q, k = enter(q, self.mesh), enter(k, self.mesh)
        return q, k
