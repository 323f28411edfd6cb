"""Batch pipeline: synthetic or on-disk scenes -> padded static-shape node
batches.

Port of ``mrp_gnn_tpu/data/pipeline.py`` for serving and training. Batches
are flattened to the node axis ([V, H, W, 3], V = scenes * robots padded to
max_nodes) to match the GraphBatch layout.

Each batch dict: images [V,H,W,3] f32, depth [V,H,W] f32, seg [V,H,W] i32
(numpy arrays) and graph: a GraphBatch of CPU tensors. Static topology
builds the graph once; dynamic topology (mobility > 0) rebuilds it per batch
from the scenes' robot positions under pinned capacities.
``make_train_iterator`` gives the endless shuffled training stream, filled
ahead by a thread (``PrefetchIterator``) when ``cfg.prefetch > 0``, or the
multi-worker loader of ``data/grain_pipeline.py`` (``loader="grain"``).
``TransformIterator`` applies a per-batch transform on a producer thread
(``train()`` places batches on the card with it).

Scenes are rendered by the native C++ renderer (``data/native.py``) where
it builds, as in the JAX package, or by the numpy one (``renderer``), or
read from scene folders (``dataset_root``, ``data/disk.py``). Train-split
augmentation (``augment``) draws each scene's flip and jitter from
``(seed + 1, epoch, scene)``. ``node_range`` renders only the scenes whose
node rows meet ``[lo, hi)`` (the per-host batches of the JAX package's
multi-process runs).

``make_train_iterator(start_batch=n)`` resumes the stream as if ``n``
batches had been consumed (``BatchIterator.fast_forward``), as a resumed
run needs; the worker loader seeks to a saved ``data_state``.
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
from mrp_gnn_tpu_torch.utils import profiling


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


def augment_scene(rec: dict, rng: np.random.Generator) -> dict:
    """Rig-consistent augmentation of one scene record, the JAX package's
    draws in its order: a horizontal flip (p 0.5) that mirrors every view
    and reverses the robot order (positions negated and reversed, so the
    pairwise distances and the radius graph stay), then a per-scene
    brightness and contrast jitter on the images only."""
    images, depth, seg = rec["images"], rec["depth"], rec["seg"]
    positions = rec.get("positions")
    if rng.uniform() < 0.5:
        images = images[::-1, :, ::-1]
        depth = depth[::-1, :, ::-1]
        seg = seg[::-1, :, ::-1]
        if positions is not None:
            positions = (-positions[::-1]).copy()
    brightness = rng.uniform(0.85, 1.15)
    contrast = rng.uniform(0.9, 1.1)
    mean = images.mean(axis=(1, 2, 3), keepdims=True)
    images = np.clip((images - mean) * contrast + mean * brightness, 0.0, 1.0)
    out = {"images": np.ascontiguousarray(images.astype(np.float32)),
           "depth": np.ascontiguousarray(depth),
           "seg": np.ascontiguousarray(seg)}
    if positions is not None:
        out["positions"] = positions
    return out


def _augment_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    return np.random.default_rng([seed + 1, epoch, idx])


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
                 drop_remainder: bool = True, augment: bool = False,
                 node_range: tuple | None = None):
        self.ds = dataset
        self.bs = scenes_per_batch
        self.augment = augment
        # [lo, hi) of the padded node axis: only the scenes whose rows meet
        # it are rendered, and the batch holds those rows (plus
        # "node_range"); the graph stays the whole batch's.
        self.node_range = node_range
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
            if not hasattr(dataset, "spec"):
                raise ValueError("dynamic topology needs the synthetic "
                                 "dataset (scene records carry robot "
                                 "positions)")
            self._graph_builder = DynamicGraphBuilder(
                cfg, self.max_nodes,
                spacing=dataset.spec.max_baseline / max(n - 1, 1),
                scenes_per_batch=scenes_per_batch)
            self.graph = self._graph_builder.nominal_graph()
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self._skip_batches = 0

    @property
    def batches_per_epoch(self) -> int:
        return len(self.ds) // self.bs

    def fast_forward(self, n_batches: int) -> None:
        """Position the stream as if ``n_batches`` were already consumed, so
        a resumed run continues the data order where it left off (the
        shuffle order is a function of (seed, epoch))."""
        bpe = max(self.batches_per_epoch, 1)
        self._epoch = n_batches // bpe
        self._skip_batches = n_batches % bpe

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self._epoch])
            rng.shuffle(order)
        self._epoch += 1
        skip, self._skip_batches = self._skip_batches, 0
        epoch = self._epoch - 1
        starts = list(range(skip * self.bs, len(order) - self.bs + 1, self.bs))
        tail = len(order) - (len(order) % self.bs)
        if (not self.drop_remainder and tail < len(order)
                and tail >= skip * self.bs):
            starts.append(tail)  # partial final batch (padded + masked)
        local = self.node_range is not None and tuple(self.node_range) != (
            0, self.max_nodes)
        for start in starts:
            idxs = order[start:start + self.bs]
            with profiling.span("data.batch"):
                batch = (self._local_batch(idxs, epoch) if local
                         else self._batch(idxs, epoch))
            yield batch

    def _batch(self, idxs, epoch: int) -> dict:
        scenes = [self.ds[int(i)] for i in idxs]
        if self.augment:
            scenes = [augment_scene(s, _augment_rng(self.seed, epoch, int(i)))
                      for s, i in zip(scenes, idxs)]
        if self._dynamic:
            with profiling.span("data.graph"):
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
        return {
            "images": _pad_nodes(images, self.max_nodes),
            "depth": _pad_nodes(depth, self.max_nodes),
            "seg": _pad_nodes(seg, self.max_nodes),
            "graph": graph,
        }

    def _local_batch(self, idxs, epoch: int) -> dict:
        """The rows [lo, hi) of one batch: renders only the scenes that meet
        them; the positions of the others (dynamic topology) come from
        ``SceneDataset.positions``, with the augmentation's flip replayed
        (its first draw), so the graph is the whole batch's."""
        n = self.ds.cfg.num_robots
        lo, hi = self.node_range
        H, W = self.ds.cfg.image_size
        images = np.zeros((hi - lo, H, W, 3), np.float32)
        depth = np.zeros((hi - lo, H, W), np.float32)
        seg = np.zeros((hi - lo, H, W), np.int32)
        positions = []
        for bi, idx in enumerate(idxs):
            a, b = bi * n, (bi + 1) * n
            oa, ob = max(a, lo), min(b, hi)
            rng = (_augment_rng(self.seed, epoch, int(idx)) if self.augment
                   else None)
            if ob > oa:
                s = self.ds[int(idx)]
                if rng is not None:
                    s = augment_scene(s, rng)
                images[oa - lo:ob - lo] = s["images"][oa - a:ob - a]
                depth[oa - lo:ob - lo] = s["depth"][oa - a:ob - a]
                seg[oa - lo:ob - lo] = s["seg"][oa - a:ob - a]
                if self._dynamic:
                    positions.append(s["positions"])
            elif self._dynamic:
                pos = self.ds.positions(int(idx))
                if rng is not None and rng.uniform() < 0.5:
                    pos = (-pos[::-1]).copy()
                positions.append(pos)
        if self._dynamic:
            with profiling.span("data.graph"):
                graph = self._graph_builder(positions)
        else:
            graph = self.graph
            if len(idxs) < self.bs:
                graph = batch_homogeneous(len(idxs), n, self._scene_edges,
                                          max_nodes=self.max_nodes,
                                          max_edges=self.graph.max_edges)
        return {"images": images, "depth": depth, "seg": seg,
                "graph": graph, "node_range": (lo, hi)}

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


class TransformIterator:
    """Applies ``transform`` to each batch of ``it`` on a producer thread,
    ``depth`` batches ahead of the consumer.

    ``get_state()`` gives the inner iterator's state (None where it has no
    ``get_state``) as it was right after the batch last handed to the
    consumer, so a restore resumes at the next unseen batch although the
    producer ran ahead. An exception in the producer (StopIteration
    included) is raised by that ``next()`` and every later one.
    ``close()`` stops the producer, closes the inner iterator unless
    ``close_inner`` is False (a caller's iterator), and joins the thread.
    """

    def __init__(self, it, transform, depth: int = 2,
                 close_inner: bool = True):
        self._it = it
        self._tf = transform
        self._close_inner = close_inner
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._last_state = None
        self._done: BaseException | None = None
        self._has_state = hasattr(it, "get_state")
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                batch = next(self._it)
                state = self._it.get_state() if self._has_state else None
                item = (state, self._tf(batch))
            except BaseException as e:  # noqa: BLE001 (relayed in __next__)
                _bounded_put(self._q, self._stop, e)
                return
            _bounded_put(self._q, self._stop, item)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done is None:
            with profiling.span("data.take"):
                if profiling.enabled() and self._q.empty():
                    profiling.count("data.starved")
                item = self._q.get()
            if not isinstance(item, BaseException):
                self._last_state, batch = item
                return batch
            self._done = item
        if isinstance(self._done, StopIteration):
            raise StopIteration from self._done
        raise self._done

    def get_state(self):
        return self._last_state

    def close(self):
        self._stop.set()
        if self._close_inner and hasattr(self._it, "close"):
            self._it.close()  # unblocks a producer waiting in next()
        try:
            self._q.get_nowait()  # unblocks a producer waiting to put
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self._done = self._done or StopIteration("closed")


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


def make_train_iterator(cfg: DataConfig, start_batch: int = 0,
                        data_state: str | None = None,
                        node_range: tuple | None = None):
    """Endless training stream; prefetched when cfg.prefetch > 0.

    start_batch: resume position in batches (the restored step times the
    accumulation), so the data order continues across restarts.
    data_state: a serialized stream position (``GrainBatchIterator
    .get_state()``), which the worker loader (``loader="grain"``) seeks to;
    without one it skips ``start_batch`` batches. The builtin stream seeks
    by ``start_batch`` and renders only the rows ``node_range``.
    """
    if cfg.loader == "grain":
        from mrp_gnn_tpu_torch.data.grain_pipeline import make_grain_iterator
        it = make_grain_iterator(cfg, "train")
        if data_state is not None:
            it.set_state(data_state)
        elif start_batch:
            it.skip(start_batch)
        return it
    if cfg.loader != "builtin":
        raise ValueError(f"unknown loader {cfg.loader!r}; one of 'builtin', "
                         "'grain'")
    it = make_dataset(cfg, "train", node_range=node_range)
    if start_batch:
        it.fast_forward(start_batch)
    if cfg.prefetch > 0:
        return PrefetchIterator(it, cfg.prefetch)
    return iter(it.repeat())


def scene_dataset(cfg: DataConfig, split: str = "train"):
    """The scenes of ``split``: the folders under ``cfg.dataset_root``
    (``data/disk.py``) when it is set, else the synthetic ones."""
    if cfg.dataset_root:
        from mrp_gnn_tpu_torch.data.disk import DiskSceneDataset
        return DiskSceneDataset(cfg, split)
    return SceneDataset(cfg, split)


def make_dataset(cfg: DataConfig, split: str = "train",
                 shuffle: bool | None = None,
                 node_range: tuple | None = None) -> BatchIterator:
    return BatchIterator(
        scene_dataset(cfg, split), cfg.scenes_per_batch,
        max_nodes=cfg.max_nodes, max_edges=cfg.max_edges,
        shuffle=(split == "train") if shuffle is None else shuffle,
        seed=cfg.seed,
        # eval must see every scene: partial final batch padded + masked
        drop_remainder=split == "train",
        augment=cfg.augment and split == "train",
        node_range=node_range,
    )
