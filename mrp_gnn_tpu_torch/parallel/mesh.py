"""The ("data", "graph") mesh over ``torch.distributed`` ranks (port of
``mrp_gnn_tpu/parallel/mesh.py``).

One rank holds one mesh position: rank r sits at data ``r // graph`` and
graph ``r % graph``, the row-major order of the JAX package's
``reshape(data, graph, model)``, so rank r owns node block r of the batch.
The graph axis of each data replica is a process subgroup (``graph_group``),
over which the halo exchange runs; the world group carries the sums of the
loss, the gradients and the metrics.

:class:`Mesh` also holds the collectives the port needs. Under the gloo
backend a CUDA tensor is copied to host memory around each collective, and
back to its device after it. A sum is one all-reduce, which hands every
rank the same bits under gloo and NCCL; several sums of a step (the loss
terms' sums and counts, the metric sums) are packed into one float64
vector, which keeps counts exact up to 2**53, and take one all-reduce.

Axes:
  data  — scene-batch shards (data parallelism: gradients summed);
  graph — edge partitions of one replica's robot graph (parallel/fused.py);
  model — channel or spatial sharding: not ported yet (ROADMAP.md, queue A
          item 11), :func:`make_mesh` refuses a model axis > 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mrp_gnn_tpu_torch.parallel.launch import world


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port has the data and graph axes; "
        "the model axis (parallel/tp.py, spatial_sharding) is still queued "
        "(ROADMAP.md, queue A item 11)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, graph) mesh of ``data * graph`` ranks."""
    data: int
    graph: int
    rank: int
    backend: str
    graph_group: object          # ProcessGroup of this replica's graph axis
    graph_ranks: tuple           # its global ranks, in graph order

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def data_index(self) -> int:
        return self.rank // self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the backend can read it (in host memory
        for gloo), which a collective may overwrite."""
        if self.backend == "gloo" and t.is_cuda:
            return t.detach().cpu()
        return t.detach().clone(memory_format=torch.contiguous_format)

    def all_gather(self, t: torch.Tensor, group=None) -> list:
        """Every rank's ``t`` (of the world, or of ``group``), in rank order,
        on ``t``'s device; not differentiable."""
        src = self._staged(t)
        n = dist.get_world_size(group)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return [p.to(t.device) for p in parts]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the world, one all-reduce (the same bits on
        every rank), on ``t``'s device; not differentiable."""
        buf = self._staged(t)
        dist.all_reduce(buf)
        return buf.to(t.device)

    def sum_all(self, tensors) -> list:
        """Each of ``tensors`` (one device) summed over the world, packed
        into one all-reduce; each in its own dtype and shape; not
        differentiable."""
        return _unpack(self.sum(_pack(tensors)), tensors)

    def world_sum(self, tensors) -> list:
        """:meth:`sum_all` whose backward is the identity: every rank
        computes the global values, and the gradient of its own shares is
        its own."""
        return _unpack(_WorldSum.apply(_pack(tensors), self), tensors)

    def world_max(self, t: torch.Tensor) -> torch.Tensor:
        """Max of a scalar over the world. Each rank's gradient of the max
        is its own pixels' share, so the backward sums the shares over the
        world and gives the sum to the ranks that hold the max, split evenly
        among them as ``torch.amax`` splits it among tied elements."""
        return _WorldMax.apply(t, self)

    def broadcast_(self, tensors, src: int = 0) -> None:
        """Overwrite ``tensors`` (one device, one dtype) with rank
        ``src``'s, in place."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        staged = self._staged(flat)
        dist.broadcast(staged, src)
        flat = staged.to(tensors[0].device)
        off = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].reshape(t.shape))
                off += n


def _pack(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).double() for t in tensors])


def _unpack(flat: torch.Tensor, like) -> list:
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, like)]


class _WorldSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.sum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _WorldMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        parts = torch.stack(mesh.all_gather(t.reshape(1)))
        top = parts.max()
        ctx.mesh = mesh
        ctx.save_for_backward((t == top).to(t.dtype) / (parts == top).sum())
        return top.reshape(t.shape)

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return ctx.mesh.sum(g) * share, None


def make_mesh(data_axis_size: int = 1, graph_axis_size: int = 1,
              model_axis_size: int = 1) -> Mesh:
    """This rank's :class:`Mesh` over the current process group (a world of
    one rank without one). Every rank must call it, in the same order: it
    creates one graph subgroup per data replica. Raises ValueError when the
    mesh needs more ranks than the world has, or fewer (one rank per mesh
    position), and NotImplementedError for a model axis > 1."""
    if model_axis_size > 1:
        raise _not_ported("a model axis > 1")
    rank, size = world()
    need = data_axis_size * graph_axis_size
    if need > size:
        raise ValueError(f"mesh needs {need} ranks, have {size}")
    if need < size:
        raise ValueError(f"mesh of {need} ranks in a world of {size}: the "
                         "port runs one rank per mesh position")
    groups = {}
    if size > 1:
        for d in range(data_axis_size):
            ranks = tuple(range(d * graph_axis_size,
                                (d + 1) * graph_axis_size))
            groups[ranks] = dist.new_group(list(ranks))
    lo = (rank // graph_axis_size) * graph_axis_size
    mine = tuple(range(lo, lo + graph_axis_size))
    return Mesh(data=data_axis_size, graph=graph_axis_size, rank=rank,
                backend=dist.get_backend() if size > 1 else "none",
                graph_group=groups.get(mine), graph_ranks=mine)
