"""The ("data", "graph", "model") mesh over ``torch.distributed`` ranks
(port of ``mrp_gnn_tpu/parallel/mesh.py``).

One rank holds one mesh position: rank r sits at data ``r // (graph *
model)``, graph ``(r // model) % graph`` and model ``r % model``, the
row-major order of the JAX package's ``reshape(data, graph, model)``, so
rank r works on node block ``r // model`` of the batch. Its groups:

- ``graph_group``: the ranks of its data replica with its model index, in
  graph order, over which the halo exchange runs;
- ``model_group``: the ``model`` ranks that share its node block, in model
  order (channel gathers under tensor parallelism, halo rows and statistics
  under spatial sharding);
- the **batch group**, over which the batch's sums run (loss terms, metric
  sums, gradients): the world, but under tensor parallelism the
  ``data * graph`` ranks with its model index (``replica_group``). Each
  rank of a model group then computes the same loss on the same node rows,
  so a world sum would count each node block ``model`` times. Under
  spatial sharding the model group splits a block's pixels, so the sums
  run over the world.

Sums over groups, per quantity and mode:

| quantity | no model axis | tensor parallel | spatial |
| --- | --- | --- | --- |
| loss sums, berHu max, metric sums | world | replica group | world |
| gradient of a replicated leaf | world | replica group | world |
| gradient of a sharded leaf | - | replica group | - |
| clip norm of a sharded leaf | - | model group, then as replicated | - |

:class:`Mesh` also holds the collectives the port needs. Under the gloo
backend a CUDA tensor is copied to host memory around each collective, and
back to its device after it. A sum is one all-reduce, which hands every
rank the same bits under gloo and NCCL; several sums of a step (the loss
terms' sums and counts, the metric sums) are packed into one float64
vector, which keeps counts exact up to 2**53, and take one all-reduce.

Axes:
  data  — scene-batch shards (data parallelism: gradients summed);
  graph — edge partitions of one replica's robot graph (parallel/fused.py);
  model — output-channel shards of the parameters (parallel/tp.py), or
          with ``spatial`` image-row shards of every feature map
          (parallel/spatial.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mrp_gnn_tpu_torch.parallel.launch import world


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, graph, model) mesh of ``data * graph *
    model`` ranks."""
    data: int
    graph: int
    rank: int
    backend: str
    graph_group: object          # ProcessGroup of this replica's graph axis
    graph_ranks: tuple           # its global ranks, in graph order
    model: int = 1
    spatial: bool = False        # the model axis shards image rows
    model_group: object = None   # ProcessGroup of this node block's ranks
    replica_group: object = None  # the data * graph ranks of this model index

    @property
    def size(self) -> int:
        return self.data * self.graph * self.model

    @property
    def blocks(self) -> int:
        """Node blocks of a batch: one per (data, graph) position."""
        return self.data * self.graph

    @property
    def block(self) -> int:
        return self.rank // self.model

    @property
    def data_index(self) -> int:
        return self.block // self.graph

    @property
    def graph_index(self) -> int:
        return self.block % self.graph

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def batch_group(self):
        """The group of the batch's sums (module docstring): the replica
        group under tensor parallelism, else the world (None)."""
        return (self.replica_group if self.model > 1 and not self.spatial
                else None)

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
        """Sum of ``t`` over the batch group, one all-reduce (the same bits
        on every rank), on ``t``'s device; not differentiable."""
        return self._all_reduce(t, self.batch_group)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the model group; not differentiable."""
        return self._all_reduce(t, self.model_group)

    def _all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        buf = self._staged(t)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)

    def sum_all(self, tensors) -> list:
        """Each of ``tensors`` (one device) summed over the batch group,
        packed into one all-reduce; each in its own dtype and shape; not
        differentiable."""
        return _unpack(self.sum(_pack(tensors)), tensors)

    def world_sum(self, tensors) -> list:
        """:meth:`sum_all` whose backward is the identity: every rank
        computes the global values, and the gradient of its own shares is
        its own."""
        return _unpack(_WorldSum.apply(_pack(tensors), self), tensors)

    def world_max(self, t: torch.Tensor) -> torch.Tensor:
        """Max of a scalar over the batch group. Each rank's gradient of the
        max is its own pixels' share, so the backward sums the shares over
        the group and gives the sum to the ranks that hold the max, split
        evenly among them as ``torch.amax`` splits it among tied elements."""
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
        parts = torch.stack(mesh.all_gather(t.reshape(1),
                                            group=mesh.batch_group))
        top = parts.max()
        ctx.mesh = mesh
        ctx.save_for_backward((t == top).to(t.dtype) / (parts == top).sum())
        return top.reshape(t.shape)

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return ctx.mesh.sum(g) * share, None


def make_mesh(data_axis_size: int = 1, graph_axis_size: int = 1,
              model_axis_size: int = 1, spatial: bool = False) -> Mesh:
    """This rank's :class:`Mesh` over the current process group (a world of
    one rank without one). Every rank must call it, in the same order: it
    creates every rank's graph, model and replica subgroups. ``spatial``:
    the model axis shards image rows (parameters replicated). Raises
    ValueError when the mesh needs more ranks than the world has, or fewer
    (one rank per mesh position)."""
    d, g, m = data_axis_size, graph_axis_size, model_axis_size
    rank, size = world()
    need = d * g * m
    if need > size:
        raise ValueError(f"mesh needs {need} ranks, have {size}")
    if need < size:
        raise ValueError(f"mesh of {need} ranks in a world of {size}: the "
                         "port runs one rank per mesh position")
    groups = {}

    def new(ranks):
        groups[ranks] = dist.new_group(list(ranks))

    if size > 1:
        for di in range(d):
            for mi in range(m):
                new(tuple((di * g + gi) * m + mi for gi in range(g)))
        if m > 1:
            for b in range(d * g):
                new(tuple(b * m + mi for mi in range(m)))
            for mi in range(m):
                new(tuple(b * m + mi for b in range(d * g)))
    block, mi = rank // m, rank % m
    graph_ranks = tuple((block // g * g + gi) * m + mi for gi in range(g))
    return Mesh(data=d, graph=g, rank=rank,
                backend=dist.get_backend() if size > 1 else "none",
                graph_group=groups.get(graph_ranks), graph_ranks=graph_ranks,
                model=m, spatial=spatial and m > 1,
                model_group=groups.get(tuple(block * m + i
                                             for i in range(m))),
                replica_group=groups.get(tuple(b * m + mi
                                               for b in range(d * g))))
