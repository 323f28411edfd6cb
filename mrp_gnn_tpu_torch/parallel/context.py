"""Parallel context: mesh, partition plan, the partitioned fusion and the
model axis, wired from an ExperimentConfig (port of
``mrp_gnn_tpu/parallel/context.py``).

Config 5 (``swarm_partitioned``) trains with its node axis split over the
("data", "graph") positions of a mesh of ranks and the fusion's edge block
replaced by the partitioned one (``parallel/fused.py``). Rank r holds node
block ``r // model`` of every batch
(:meth:`ParallelContext.local_node_range`, contiguous): its images, depth
and seg rows, and a graph whose ``node_mask`` is its rows' and whose
``partition_plan`` is its block of the plan. A mesh with a graph axis of 1
and more than one node block (data parallelism) partitions each replica's
graph into one shard, so the same fusion serves it with no exchange; a mesh
whose only axis is the model axis needs no plan and keeps the single-device
edge block on every rank, as the JAX package's "DP/TP-only mesh" does.

The model axis (``ParallelConfig.model_axis_size`` > 1) gives the model a
shard context (:attr:`ParallelContext.shard`, passed to its forward): a
``parallel.tp.TensorParallel`` (output channels of the parameters) or, with
``spatial_sharding``, a ``parallel.spatial.SpatialSharding`` (image rows;
each rank keeps its rows of the images, depth and seg).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mrp_gnn_tpu_torch.config import ExperimentConfig
from mrp_gnn_tpu_torch.parallel.fused import make_partitioned_edge_fusion
from mrp_gnn_tpu_torch.parallel.launch import rank_device
from mrp_gnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from mrp_gnn_tpu_torch.parallel.partition import (EdgePartitionPlan,
                                                  PlanCapacities,
                                                  partition_batch,
                                                  partition_graph)


@dataclasses.dataclass(eq=False)
class ParallelContext:
    mesh: Mesh
    plan: EdgePartitionPlan | None     # None: no node partition (model axis)
    edge_fusion_fn: Callable | None
    device: torch.device
    # Dynamic topology: the capacities pinning every per-batch plan (None
    # for a static topology, whose plan is ``plan``).
    dyn_caps: PlanCapacities | None = None
    num_replicas: int = 1
    # The model axis's context for the model's forward (tp.TensorParallel
    # or spatial.SpatialSharding); None without a model axis.
    shard: object | None = None
    # the last host graph and its local view, replaced as one tuple (the
    # training stream's producer thread and an evaluation both attach)
    _local: tuple = dataclasses.field(default=(None, None), init=False,
                                      repr=False)

    @property
    def spatial(self) -> bool:
        return self.mesh.spatial

    def local_node_range(self, V: int) -> tuple:
        """This rank's [lo, hi) of the global node axis of V slots: node
        block ``rank // model`` of ``data * graph``."""
        blocks = self.mesh.blocks
        if V % blocks:
            raise ValueError(f"{V} node slots do not divide over {blocks} "
                             "node blocks")
        n = V // blocks
        return self.mesh.block * n, (self.mesh.block + 1) * n

    def attach_plan(self, graph):
        """``graph`` with this rank's block of the partition plan (dynamic
        topology: built from the batch, :func:`partition_batch`; host
        tensors, moved with the graph) and its rows' ``node_mask``. The
        same host graph gives the same object, so a static graph is copied
        to the card once."""
        last, local = self._local
        if graph is last:
            return local
        plan = (partition_batch(graph, self.num_replicas, self.mesh.graph,
                                self.dyn_caps).shard(self.mesh.block)
                if self.dyn_caps is not None else None)
        lo, hi = self.local_node_range(graph.max_nodes)
        local = dataclasses.replace(graph, node_mask=graph.node_mask[lo:hi],
                                    partition_plan=plan)
        self._local = (graph, local)
        return local

    def local_batch(self, batch: dict) -> dict:
        """A pipeline batch as this rank's (host arrays): its node rows (the
        batch's own when it carries "node_range", else sliced here), under
        spatial sharding its image rows of them, and :meth:`attach_plan`'s
        graph."""
        graph = batch["graph"]
        lo, hi = self.local_node_range(graph.max_nodes)
        out = {"graph": self.attach_plan(graph)}
        for k in ("images", "depth", "seg"):
            v = np.asarray(batch[k])
            if batch.get("node_range") is not None:
                if tuple(batch["node_range"]) != (lo, hi):
                    raise ValueError(f"batch rows {batch['node_range']} are "
                                     f"not this rank's {(lo, hi)}")
            elif v.shape[0] == graph.max_nodes:
                v = v[lo:hi]
            if self.spatial:
                r0, r1 = self.shard.rows(v.shape[1])
                v = np.ascontiguousarray(v[:, r0:r1])
            out[k] = v
        return out

    def shard_batch(self, batch: dict) -> tuple:
        """(images, depth, seg, graph) of this rank's rows of a pipeline
        batch, on its device."""
        b = self.local_batch(batch)
        arrays = [torch.from_numpy(b[k]).to(self.device)
                  for k in ("images", "depth", "seg")]
        return (*arrays, b["graph"].to(self.device))

    def shard_state(self, state) -> None:
        """Make rank 0's parameters and optimizer moments every rank's
        (broadcast over the world group), so that all ranks start equal,
        from a whole model: the seeded one, or a restored checkpoint. Under
        tensor parallelism each rank then keeps its shard of every sharded
        leaf and of its moments (``tp.TensorParallel.shard_state``)."""
        opt = state.optimizer
        self.mesh.broadcast_([*state.model.parameters(), *opt.mu, *opt.nu])
        if self.shard is not None:
            self.shard.shard_state(state)

    def full_tensors(self, state):
        """(model state_dict, mu, nu) with every leaf whole, for a
        checkpoint, or None where the state holds them whole already; under
        tensor parallelism a collective of the model group, which every
        rank calls."""
        return None if self.shard is None else self.shard.full_tensors(state)


def replica_graph_for(cfg: ExperimentConfig):
    """Per-data-replica GraphBatch of a static topology: the scenes divide
    over data replicas and each replica's nodes over graph shards."""
    from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for
    pc, d = cfg.parallel, cfg.data
    if d.scenes_per_batch % pc.data_axis_size:
        raise ValueError(f"scenes_per_batch={d.scenes_per_batch} not divisible "
                         f"by data_axis_size={pc.data_axis_size}")
    scenes_rep = d.scenes_per_batch // pc.data_axis_size
    v_rep = scenes_rep * d.num_robots
    if v_rep % pc.graph_axis_size:
        raise ValueError(f"replica nodes {v_rep} not divisible by "
                         f"graph_axis_size={pc.graph_axis_size}")
    return batch_homogeneous(
        scenes_rep, d.num_robots,
        scene_edges_for(d.num_robots, d.connectivity, d.comm_radius))


def make_parallel_context(cfg: ExperimentConfig,
                          device=None) -> ParallelContext | None:
    """Mesh, plan and partitioned fusion for ``cfg`` on this rank; None for a
    trivial mesh. Every rank must call it (it creates process subgroups).
    ``device``: this rank's device (default ``launch.rank_device``)."""
    pc = cfg.parallel
    d, g, m = pc.data_axis_size, pc.graph_axis_size, pc.model_axis_size
    if d * g * m <= 1:
        return None
    spatial = pc.spatial_sharding and m > 1
    if spatial:
        from mrp_gnn_tpu_torch.parallel.spatial import check_rows
        check_rows(cfg.model.image_size, cfg.model.encoder_channels, m)
    mesh = make_mesh(d, g, m, spatial=spatial)
    shard = None
    if m > 1:
        from mrp_gnn_tpu_torch.parallel.spatial import SpatialSharding
        from mrp_gnn_tpu_torch.parallel.tp import TensorParallel
        shard = (SpatialSharding if spatial else TensorParallel)(mesh)
    if d * g == 1:
        # a model axis alone: the single-device edge block on every rank
        return ParallelContext(mesh=mesh, plan=None, edge_fusion_fn=None,
                               device=rank_device(device), shard=shard)
    dyn_caps = None
    if cfg.data.mobility > 0:
        # The capacity plan (shapes and rings) is the full-connectivity
        # replica graph's, a componentwise upper bound for every radius
        # topology on the same layout; per-batch plans are built under it.
        from mrp_gnn_tpu_torch.graph import batch_fully_connected
        from mrp_gnn_tpu_torch.parallel.partition import capacities_of
        d = cfg.data
        if d.scenes_per_batch % pc.data_axis_size:
            raise ValueError(
                f"scenes_per_batch={d.scenes_per_batch} not divisible by "
                f"data_axis_size={pc.data_axis_size}")
        full = batch_fully_connected(d.scenes_per_batch // pc.data_axis_size,
                                     d.num_robots)
        plan = partition_graph(full, pc.graph_axis_size)
        dyn_caps = capacities_of(plan)
        if pc.expanded_plan_pairs:
            dyn_caps = dataclasses.replace(dyn_caps,
                                           xp_pairs=pc.expanded_plan_pairs)
    else:
        plan = partition_graph(replica_graph_for(cfg), pc.graph_axis_size)
    edge_fn = make_partitioned_edge_fusion(
        mesh, plan, exchange=pc.boundary_exchange,
        overlap=pc.overlap_boundary_exchange, dynamic=dyn_caps is not None)
    return ParallelContext(mesh=mesh, plan=plan, edge_fusion_fn=edge_fn,
                           device=rank_device(device), dyn_caps=dyn_caps,
                           num_replicas=pc.data_axis_size, shard=shard)
