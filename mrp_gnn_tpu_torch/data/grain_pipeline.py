"""Multi-worker input pipeline (``DataConfig.loader = "grain"``): the port's
counterpart of ``mrp_gnn_tpu/data/grain_pipeline.py``, on
``torch.utils.data.DataLoader`` with ``loader_workers`` worker processes
in the place of grain's (the port does not import grain).

Batches are the builtin pipeline's dicts: images [V, H, W, 3], depth
[V, H, W], seg [V, H, W] and graph, a GraphBatch. The stream is grain's:
one endless stream of scene records, epoch after epoch, cut into batches
of ``scenes_per_batch`` (a batch may span two epochs; only the end of a
bounded stream drops a remainder). Batch ``g`` is a function of ``g``
alone, so its bits do not depend on the worker count, and the stream seeks
to any batch in O(1) (``get_state`` / ``set_state``).

In a worker, ``_Batches`` reads the batch's scene records (rendered, or
read from ``dataset_root``), augments them on the train split when
``augment`` is set (each scene's draws from ``(seed + 1, epoch, scene)``,
as the builtin pipeline) and ``_Collate`` flattens and pads them; dynamic
topology passes the robot positions [B, N] through. The GraphBatch is
attached in the main process, after the worker boundary, as the JAX
package does: the static graph once, a dynamic one built per batch from the
positions.

Departure from the JAX package: the shuffled order of each epoch is the
builtin pipeline's permutation (``default_rng([seed, epoch])``), not
grain's ``index_shuffle``. The unshuffled stream is the JAX package's grain
stream. Workers are started with "spawn" (a process that holds a CUDA
context and OpenMP threads cannot fork safely) and load the native
renderer themselves; a batch that takes longer than ``WORKER_TIMEOUT_S``
raises. Single process only, as in the JAX package.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from mrp_gnn_tpu_torch.config import DataConfig
from mrp_gnn_tpu_torch.data.pipeline import (DynamicGraphBuilder,
                                             _augment_rng, _pad_nodes,
                                             augment_scene, scene_dataset)
from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for

WORKER_TIMEOUT_S = 600  # the first batch of a worker includes its start-up


class _Collate:
    """Scene records -> one padded node batch (runs in the workers).

    Dynamic topology (mobility > 0): the robot positions [B, N] pass
    through un-padded, and the main process builds the radius graph from
    them (GraphBatch tensors do not cross the worker boundary)."""

    def __init__(self, max_nodes: int, dynamic: bool):
        self.max_nodes = max_nodes
        self.dynamic = dynamic

    def __call__(self, records: list) -> dict:
        out = {k: _pad_nodes(np.concatenate([r[k] for r in records]),
                             self.max_nodes)
               for k in ("images", "depth", "seg")}
        if self.dynamic:
            out["positions"] = np.stack([r["positions"] for r in records])
        return out


class _Batches(torch.utils.data.Dataset):
    """Batch ``g`` of the endless record stream: records ``g * B`` to
    ``g * B + B - 1``, record ``r`` being scene ``order(r // n)[r % n]``
    (``n`` scenes an epoch, ``order`` each epoch's permutation)."""

    def __init__(self, ds, collate: _Collate, batch_size: int, shuffle: bool,
                 augment: bool, seed: int):
        self.ds = ds
        self.collate = collate
        self.bs = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self._orders: dict = {}

    def _order(self, epoch: int) -> np.ndarray:
        order = self._orders.get(epoch)
        if order is None:
            order = np.arange(len(self.ds))
            if self.shuffle:
                np.random.default_rng([self.seed, epoch]).shuffle(order)
            self._orders = {epoch: order}  # batches walk the epochs in turn
        return order

    def __getitem__(self, g: int) -> dict:
        n = len(self.ds)
        records = []
        for r in range(g * self.bs, (g + 1) * self.bs):
            epoch = r // n
            idx = int(self._order(epoch)[r % n])
            rec = self.ds[idx]
            if self.augment:
                rec = augment_scene(rec, _augment_rng(self.seed, epoch, idx))
            records.append(rec)
        return self.collate(records)


def _identity(batch):
    return batch


def make_grain_iterator(cfg: DataConfig, split: str = "train",
                        shuffle: bool | None = None,
                        num_epochs: int | None = None,
                        workers: int | None = None) -> "GrainBatchIterator":
    """Endless (or ``num_epochs``-bounded) batch stream of ``split`` over
    ``workers`` worker processes (default ``cfg.loader_workers``; 0 reads
    in this process). Raises ValueError in a process group of more than
    one process."""
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise ValueError(
            "loader='grain' is single-process only: its records are not "
            "sharded across processes. Use the builtin loader "
            "(loader='builtin') for multi-process runs.")
    ds = scene_dataset(cfg, split)
    n = cfg.num_robots
    edges = scene_edges_for(n, cfg.connectivity, cfg.comm_radius)
    graph = batch_homogeneous(
        cfg.scenes_per_batch, n, edges,
        max_nodes=cfg.max_nodes or cfg.scenes_per_batch * n,
        max_edges=cfg.max_edges
        or max(cfg.scenes_per_batch * edges.shape[1], 1))
    collate = _Collate(graph.max_nodes, cfg.mobility > 0)
    graph_builder = None
    if collate.dynamic:
        if not hasattr(ds, "spec"):
            raise ValueError("dynamic topology needs the synthetic dataset "
                             "(scene records carry robot positions)")
        graph_builder = DynamicGraphBuilder(
            cfg, collate.max_nodes,
            spacing=ds.spec.max_baseline / max(n - 1, 1))
        graph = graph_builder.nominal_graph()
    batches = _Batches(ds, collate, cfg.scenes_per_batch,
                       (split == "train") if shuffle is None else shuffle,
                       cfg.augment and split == "train", cfg.seed)
    stop = (None if num_epochs is None
            else num_epochs * len(ds) // cfg.scenes_per_batch)
    return GrainBatchIterator(
        batches, workers if workers is not None else cfg.loader_workers,
        graph, graph_builder, stop)


class GrainBatchIterator:
    """The batch stream over a DataLoader of :class:`_Batches`, with O(1)
    checkpointing: ``get_state()`` is a JSON string of the next batch's
    position, ``{"batch": g}`` (the batches handed out so far), and
    ``set_state`` restarts the workers at it."""

    def __init__(self, batches: _Batches, workers: int, graph,
                 graph_builder=None, stop: int | None = None):
        self.graph = graph
        self._batches = batches
        self._workers = workers
        self._graph_builder = graph_builder
        self._stop = stop
        self._it = None
        self._start(0)

    def _start(self, g: int) -> None:
        self.close()
        self._next = g
        indices = (itertools.count(g) if self._stop is None
                   else range(g, self._stop))
        kw = {}
        if self._workers > 0:
            kw = dict(multiprocessing_context="spawn",
                      timeout=WORKER_TIMEOUT_S)
        self._it = iter(torch.utils.data.DataLoader(
            self._batches, batch_size=None, sampler=indices,
            num_workers=self._workers, collate_fn=_identity, **kw))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self._it)
        self._next += 1
        if self._graph_builder is not None:
            batch["graph"] = self._graph_builder(batch.pop("positions"))
        else:
            batch["graph"] = self.graph
        return batch

    def get_state(self) -> str:
        return json.dumps({"batch": self._next})

    def set_state(self, state: str) -> None:
        self._start(int(json.loads(state)["batch"]))

    def skip(self, n: int) -> None:
        """Seek ``n`` batches ahead without reading them."""
        self._start(self._next + n)

    def close(self) -> None:
        """Stop the workers (the stream cannot be read after this)."""
        it, self._it = self._it, None
        if hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
