"""Batch pipeline: synthetic scenes -> padded static-shape node batches.

Port of ``mrp_gnn_tpu/data/pipeline.py`` for serving and training. Batches
are flattened to the node axis ([V, H, W, 3], V = scenes * robots padded to
max_nodes) to match the GraphBatch layout.

Each batch dict: images [V,H,W,3] f32, depth [V,H,W] f32, seg [V,H,W] i32
(numpy arrays) and graph: a GraphBatch of CPU tensors. Static topology
builds the graph once; dynamic topology (mobility > 0) rebuilds it per batch
from the scenes' robot positions under pinned capacities.
``make_train_iterator`` gives the endless shuffled training stream, filled
ahead by a thread (``PrefetchIterator``) when ``cfg.prefetch > 0``.

Scenes are rendered by the native C++ renderer (``data/native.py``) where
it builds, as in the JAX package, or by the numpy one (``renderer``).

Not ported yet: resuming the stream at a batch (``start_batch``, with
checkpoints: ROADMAP.md, queue A item 8); augmentation, per-host
``node_range`` sharding, the grain loader and the on-disk dataset (queue A
item 9).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from mrp_gnn_tpu_torch.config import DataConfig
from mrp_gnn_tpu_torch.data import native
from mrp_gnn_tpu_torch.data.synthetic import (SceneSpec, generate_scene,
                                              scene_positions)
from mrp_gnn_tpu_torch.graph import (batch_from_positions,
                                     batch_fully_connected, batch_homogeneous,
                                     scene_edges_for)


class SceneDataset:
    """Deterministic map-style dataset of synthetic scenes."""

    def __init__(self, cfg: DataConfig, split: str = "train"):
        if cfg.renderer not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown renderer {cfg.renderer!r}")
        self.cfg = cfg
        self.split = split
        self.num_scenes = (cfg.num_train_scenes if split == "train"
                           else cfg.num_eval_scenes)
        # Disjoint seed streams per split.
        self._seed = cfg.seed * 2 + (0 if split == "train" else 1)
        self.spec = SceneSpec(
            num_robots=cfg.num_robots,
            image_size=cfg.image_size,
            num_classes=cfg.num_seg_classes,
            # constant parallax between adjacent robots regardless of team size
            max_baseline=0.25 * max(cfg.num_robots - 1, 1),
            # cfg.mobility is in robot-index units; slots sit 0.25 m apart
            mobility=cfg.mobility * 0.25,
        )
        # "auto": the native renderer wherever it builds, as in the JAX
        # package; "native" raises when it does not.
        self._use_native = False
        if cfg.renderer in ("auto", "native"):
            self._use_native = native.is_available()
            if cfg.renderer == "native" and not self._use_native:
                raise RuntimeError("native renderer requested but the shared "
                                   "library could not be built/loaded")

    def __len__(self) -> int:
        return self.num_scenes

    def __getitem__(self, idx: int) -> dict:
        if self._use_native:
            rec = native.render_scene_native(self.spec, self._seed, idx)
        else:
            rec = generate_scene(self.spec, self._seed, idx)
        if self.cfg.degraded_fraction > 0:
            rec = degrade_robots(rec, self.cfg.degraded_fraction,
                                 self._seed, idx)
        return rec

    def positions(self, idx: int) -> np.ndarray:
        """Scene camera positions without rendering the scene."""
        return scene_positions(self.spec, self._seed, idx)


def degrade_robots(rec: dict, fraction: float, seed: int, idx: int) -> dict:
    """Corrupt a random subset of robots' cameras with heavy sensor noise
    (at least one robot per scene stays clean). Deterministic per
    (seed, idx); ground truth is untouched."""
    rng = np.random.default_rng(np.random.SeedSequence([seed + 7, idx]))
    N = rec["images"].shape[0]
    bad = rng.uniform(size=N) < fraction
    if bad.all():
        bad[int(rng.integers(N))] = False
    if not bad.any():
        return rec
    images = rec["images"].copy()
    noise = rng.uniform(size=images[bad].shape).astype(np.float32)
    images[bad] = np.clip(0.15 * images[bad] + 0.85 * noise, 0.0, 1.0)
    return {**rec, "images": images}


def _pad_nodes(arr: np.ndarray, max_nodes: int) -> np.ndarray:
    pad = max_nodes - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


class DynamicGraphBuilder:
    """Per-batch GraphBatch builder for dynamic topologies (mobility > 0).

    Derives the pinned capacities from the full-connectivity batch once
    (edges can only be a subset of it, so its plan length bounds every
    dynamic plan), then builds a capacity-padded radius graph from each
    batch's robot positions. Positions arrive in metres and are normalized
    to index units by the baseline spacing.
    """

    def __init__(self, cfg: DataConfig, max_nodes: int, spacing: float,
                 scenes_per_batch: int | None = None):
        if cfg.connectivity != "radius":
            raise ValueError("mobility > 0 needs connectivity='radius' "
                             "(dynamic topology is a communication-range "
                             "property)")
        n = cfg.num_robots
        self.num_robots = n
        self.scenes_per_batch = scenes_per_batch or cfg.scenes_per_batch
        self.spacing = spacing
        self.radius = float(cfg.comm_radius)
        full = batch_fully_connected(self.scenes_per_batch, n,
                                     max_nodes=max_nodes)
        self.caps = dict(
            max_nodes=max_nodes,
            max_edges=self.scenes_per_batch * n * max(n - 1, 1),
            max_degree=max(n - 1, 1),
            max_bsp_pairs=(int(full.bsp_pair_dst.shape[0])
                           if full.bsp_pair_dst is not None else None),
            backend=cfg.graph_builder,
        )

    def nominal_graph(self):
        """Graph of nominal (un-jittered) positions, with the stream's shapes."""
        nominal = np.arange(self.num_robots, dtype=np.float64)
        return batch_from_positions([nominal] * self.scenes_per_batch,
                                    self.radius, **self.caps)

    def __call__(self, positions):
        """positions: [B, N] array or list of [N] arrays, in metres."""
        pos = [np.asarray(p, np.float64) / self.spacing for p in positions]
        return batch_from_positions(pos, self.radius, **self.caps)


class BatchIterator:
    """Yields padded node-flattened batches, static or dynamic topology."""

    def __init__(self, dataset, scenes_per_batch: int,
                 max_nodes: int | None = None, max_edges: int | None = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        self.ds = dataset
        self.bs = scenes_per_batch
        cfg = dataset.cfg
        n = cfg.num_robots
        edges = scene_edges_for(n, cfg.connectivity, cfg.comm_radius)
        self.graph = batch_homogeneous(
            scenes_per_batch, n, edges,
            max_nodes=max_nodes or scenes_per_batch * n,
            max_edges=max_edges or max(scenes_per_batch * edges.shape[1], 1),
        )
        self.max_nodes = self.graph.max_nodes
        self._scene_edges = edges
        self._dynamic = cfg.mobility > 0
        if self._dynamic:
            self._graph_builder = DynamicGraphBuilder(
                cfg, self.max_nodes,
                spacing=dataset.spec.max_baseline / max(n - 1, 1),
                scenes_per_batch=scenes_per_batch)
            self.graph = self._graph_builder.nominal_graph()
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self._epoch])
            rng.shuffle(order)
        self._epoch += 1
        starts = list(range(0, len(order) - self.bs + 1, self.bs))
        tail = len(order) - (len(order) % self.bs)
        if not self.drop_remainder and tail < len(order):
            starts.append(tail)  # partial final batch (padded + masked)
        for start in starts:
            idxs = order[start:start + self.bs]
            scenes = [self.ds[int(i)] for i in idxs]
            if self._dynamic:
                graph = self._graph_builder([s["positions"] for s in scenes])
            else:
                graph = self.graph
                if len(scenes) < self.bs:
                    # same static shapes, node_mask False on missing scenes
                    graph = batch_homogeneous(
                        len(scenes), self.ds.cfg.num_robots,
                        self._scene_edges, max_nodes=self.max_nodes,
                        max_edges=self.graph.max_edges)
            images = np.concatenate([s["images"] for s in scenes])
            depth = np.concatenate([s["depth"] for s in scenes])
            seg = np.concatenate([s["seg"] for s in scenes])
            yield {
                "images": _pad_nodes(images, self.max_nodes),
                "depth": _pad_nodes(depth, self.max_nodes),
                "seg": _pad_nodes(seg, self.max_nodes),
                "graph": graph,
            }

    def repeat(self):
        """Endless stream: one epoch after another, each in its own order."""
        while True:
            yield from self


def _bounded_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Put that gives up once ``stop`` is set, so a producer thread never
    stays blocked on a full queue after ``close()``."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if stop.is_set():
                return False


class PrefetchIterator:
    """Fills a bounded queue ``depth`` batches ahead of the consumer from a
    daemon thread, so scene rendering and graph builds overlap the training
    step. An exception in the producer is raised by the next ``next()``."""

    def __init__(self, batch_iter: BatchIterator, depth: int = 2):
        self._it = batch_iter
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for batch in self._it.repeat():
                if self._stop.is_set() or not _bounded_put(
                        self._q, self._stop, batch):
                    return
        except Exception as e:  # noqa: BLE001 (relayed to the consumer)
            _bounded_put(self._q, self._stop, e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._error is not None:
            raise self._error
        item = self._q.get()
        if isinstance(item, Exception):
            self._error = item
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()  # unblock the producer if it is waiting
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_train_iterator(cfg: DataConfig, start_batch: int = 0):
    """Endless shuffled training stream; prefetched when cfg.prefetch > 0.

    Only the builtin loader from the start of the stream is ported: the
    grain loader (ROADMAP.md, queue A item 9) and ``start_batch`` resume
    (item 8, with checkpoints) raise NotImplementedError.
    """
    if cfg.loader != "builtin":
        raise NotImplementedError(
            f"loader={cfg.loader!r} is not ported yet (ROADMAP.md, queue A "
            "item 9); use loader='builtin'")
    if start_batch:
        raise NotImplementedError(
            "resuming the stream at a batch comes with checkpoints "
            "(ROADMAP.md, queue A item 8)")
    it = make_dataset(cfg, "train")
    if cfg.prefetch > 0:
        return PrefetchIterator(it, cfg.prefetch)
    return iter(it.repeat())


def make_dataset(cfg: DataConfig, split: str = "train",
                 shuffle: bool | None = None) -> BatchIterator:
    if cfg.dataset_root:
        raise NotImplementedError(
            "the on-disk dataset is not ported yet (ROADMAP.md, queue A "
            "item 9: data/disk.py)")
    if cfg.augment and split == "train":
        raise NotImplementedError(
            "train-split augmentation is not ported yet (ROADMAP.md, queue "
            "A item 9)")
    return BatchIterator(
        SceneDataset(cfg, split), cfg.scenes_per_batch,
        max_nodes=cfg.max_nodes, max_edges=cfg.max_edges,
        shuffle=(split == "train") if shuffle is None else shuffle,
        seed=cfg.seed,
        # eval must see every scene: partial final batch padded + masked
        drop_remainder=split == "train",
    )
