"""Training: the train step, the optimizer and the loop (port of
``mrp_gnn_tpu/train.py``).

One step runs the model forward, ``total_loss`` and the backward, then the
optimizer of the JAX package: ``optax.chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))``, written out here update for update
(:class:`AdamW`). On the CUDA card, with ``ops_impl`` "auto" or "pallas",
the fusion layer's sparse aggregations (attention at any ELL width, mean,
max) and their backward run the hand-written kernels of ``ops/bsp.py`` and
``ops/ell.py``.

The loop (:func:`train`) evaluates every ``eval_every`` steps and keeps
the best depth RMSE in the state, writes a checkpoint every
``checkpoint_every`` steps and at the last (``checkpoint.py``), resumes
from the newest checkpoint in ``checkpoint_dir`` at the same place in the
data stream, and writes TensorBoard scalars to ``tensorboard_dir``.

Batches reach the step off the training thread: with one microbatch a
step, a producer thread (``data.pipeline.TransformIterator``) copies each
batch to the card (:class:`BatchPlacer`: pinned host buffers, copies on a
side stream, an event the step's stream waits on); with accumulation,
:class:`_MicrobatchStacker` stacks each group on a producer thread and the
loop copies the group. The data stream is the builtin pipeline or, with
``loader="grain"``, the multi-worker loader, whose position is saved with
each checkpoint (``data_state``).

Under a ("data", "graph", "model") mesh (``ParallelConfig``'s
``data_axis_size`` x ``graph_axis_size`` x ``model_axis_size`` ranks, one
process each, ``parallel/``), each rank renders and trains its node block's
rows through the partitioned fusion; with a model axis, under tensor
parallelism its shard of the parameters' output channels
(``parallel/tp.py``), under ``spatial_sharding`` its image rows of them
(``parallel/spatial.py``). The loss terms are global sums (``losses.py``),
the gradients are summed after the backward over the batch group
(``parallel/mesh.py``: the world, or under tensor parallelism the ranks of
this rank's model index), and every rank runs the same clip and AdamW
update on what it holds. Rank 0 alone logs, writes TensorBoard and
checkpoints (whole tensors: a tensor-parallel run gathers its shards
first); every rank restores from the same checkpoint.

CLI: python -m mrp_gnn_tpu_torch.train --config dynamic_swarm --steps 20 \
        [--checkpoint_dir /tmp/ckpt] [--eval_every 10] [--max_restarts 2] \
        [--dataset_root /data/scenes] [--augment]
     python -m mrp_gnn_tpu_torch.train --config swarm_partitioned \
        --coordinator localhost:29500 --num_processes 8 --process_id $ID \
        --dist_backend gloo     # one process per rank
     python -m mrp_gnn_tpu_torch.train --config dynamic_swarm --model_axis 2 \
        --coordinator localhost:29500 --num_processes 2 --process_id $ID \
        --dist_backend gloo     # tensor parallelism over 2 ranks

The loop runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mrp_gnn_tpu_torch.config import ExperimentConfig, get_config
from mrp_gnn_tpu_torch.losses import total_loss
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.ops import adamw as fused
from mrp_gnn_tpu_torch.utils import profiling
from mrp_gnn_tpu_torch.utils.platform import (reference_numerics,
                                              resolve_device)


def warmup_cosine_lr(cfg: ExperimentConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay) at update
    ``count`` (0-based): linear from 0, so the first update has lr 0, then
    cosine decay to 0 at ``decay_steps`` = max(steps, warmup + 1)."""
    tr = cfg.train
    peak, warmup = tr.learning_rate, tr.warmup_steps
    decay = max(tr.steps, warmup + 1) - warmup
    if count < warmup:
        return peak - peak * (1.0 - count / warmup)
    t = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package uses


class AdamW:
    """Global-norm clipping, then AdamW, as optax's
    ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay=wd))``:

    - gradients are clipped as ``g / ||g|| * max_norm`` when ||g|| >=
      max_norm (no epsilon added to the norm);
    - eps is added outside the square root of the bias-corrected second
      moment;
    - the weight decay is decoupled and applies to every parameter;
    - update k (0-based) takes the schedule's value at k, so the first
      update has lr 0 under the warmup schedule.

    Moments live beside the parameters (same device); updates are in place.
    On the card the step is two kernel launches over every leaf
    (``ops/adamw.py``: the norm, then the clip and update, with the bits of
    the loop below given the same norm); it raises on a leaf the kernels
    do not take (float32 and contiguous, each gradient of its parameter's
    shape and contiguous or channels-last). CPU leaves take the loop
    (:meth:`loop_step`), the plain version.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 max_norm: float, weight_decay: float):
        self.params = list(params)
        self.schedule = schedule
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self._ticket = None  # the norm kernel's, made at the first CUDA step

    @torch.no_grad()
    def step(self, grads, norm: torch.Tensor | None = None) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter, in order);
        returns the global norm of the gradients before clipping, which a
        caller whose parameters are shards passes as ``norm``."""
        if self.params and self.params[0].device.type == "cuda":
            return self._fused_step(grads, norm)
        return self.loop_step(grads, norm)

    @torch.no_grad()
    def loop_step(self, grads, norm: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """:meth:`step` as a loop of elementwise ops over the leaves, on any
        device: the update of CPU leaves, and the plain version that the
        card tests hold the kernels against."""
        if norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        clip = norm < self.max_norm
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clip, g, g / norm * self.max_norm)
            mu.copy_((1.0 - B1) * g + B1 * mu)
            nu.copy_((1.0 - B2) * g * g + B2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            p.add_(-lr * (update + self.weight_decay * p))
        return norm

    def _fused_step(self, grads, norm: torch.Tensor | None) -> torch.Tensor:
        dev = self.params[0].device
        if norm is None and (self._ticket is None
                             or self._ticket.device != dev):
            self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        norm = fused.adamw_update(
            self.params, list(grads), self.mu, self.nu, norm,
            ticket=self._ticket, lr=self.schedule(self.count),
            count=self.count + 1, max_norm=self.max_norm,
            weight_decay=self.weight_decay, b1=B1, b2=B2, eps=EPS)
        self.count += 1
        profiling.count("optim.fused_leaves", len(self.params))
        return norm


def make_optimizer(cfg: ExperimentConfig, params) -> AdamW:
    return AdamW(params, lambda count: warmup_cosine_lr(cfg, count),
                 max_norm=cfg.train.grad_clip_norm,
                 weight_decay=cfg.train.weight_decay)


@dataclasses.dataclass
class TrainState:
    """What a run carries from step to step (the model's parameters are
    updated in place)."""
    model: MultiRobotPerceptionNet
    optimizer: AdamW
    step: int = 0
    best_rmse: float = math.inf
    best_step: int = -1


def create_train_state(cfg: ExperimentConfig, device,
                       edge_fusion_fn: Callable | None = None) -> TrainState:
    """Model with seeded random weights (``cfg.train.seed``) on ``device``,
    and its optimizer; ``edge_fusion_fn`` goes to the model's fusion
    layers."""
    model = MultiRobotPerceptionNet(
        cfg.model, ops_impl=cfg.parallel.ops_impl,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        edge_fusion_fn=edge_fusion_fn).to(device)
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def make_grad_fn(cfg: ExperimentConfig, model: MultiRobotPerceptionNet,
                 pctx=None) -> Callable:
    """``grads(images, depth, seg, graph) -> (grads, terms)``: the loss
    terms and the gradients of one batch (microbatches, as
    :func:`make_train_step` takes them, averaged), one per parameter, summed
    over the mesh's batch group after the backward (``pctx``: this rank's
    ``parallel.context.ParallelContext``)."""
    accum = max(cfg.train.grad_accum_steps, 1)
    tr = cfg.train
    ops_impl = cfg.parallel.ops_impl
    params = list(model.parameters())
    mesh = pctx.mesh if pctx is not None else None
    shard = pctx.shard if pctx is not None else None

    def forward(images, graph):
        return model(images, graph, ops_impl=ops_impl, shard=shard)

    def grads_of(images, depth, seg, graph):
        with profiling.span("train.forward"):
            if tr.remat:
                # Recompute the forward in the backward instead of holding
                # every feature map (the JAX package's jax.checkpoint).
                out = checkpoint(forward, images, graph, use_reentrant=False)
            else:
                out = forward(images, graph)
            loss, terms = total_loss(out, {"depth": depth, "seg": seg},
                                     graph.node_mask, tr.depth_loss_weight,
                                     tr.seg_loss_weight,
                                     depth_loss=tr.depth_loss, mesh=mesh)
        with profiling.span("train.backward"):
            grads = torch.autograd.grad(loss, params)
        return grads, {k: v.detach() for k, v in terms.items()}

    def grads(images, depth, seg, graph):
        if accum == 1:
            grads, terms = grads_of(images, depth, seg, graph)
        else:
            graphs = (list(graph) if isinstance(graph, (list, tuple))
                      else [graph] * accum)
            grads, terms = grads_of(images[0], depth[0], seg[0], graphs[0])
            for i in range(1, accum):
                g, t = grads_of(images[i], depth[i], seg[i], graphs[i])
                grads = [a + b for a, b in zip(grads, g)]
                terms = {k: terms[k] + t[k] for k in terms}
            grads = [g / accum for g in grads]
            terms = {k: v / accum for k, v in terms.items()}
        if mesh is not None:
            flat = mesh.sum(torch.cat([g.reshape(-1) for g in grads]))
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        return grads, terms

    return grads


def global_norm(grads, params, mesh=None) -> torch.Tensor:
    """The norm of the whole gradient, as one process computes it: each
    leaf's norm, then the norm of those; a sharded leaf's square summed
    over the model group first (one all-reduce for them all)."""
    from mrp_gnn_tpu_torch.parallel.tp import is_sharded
    norms = [torch.linalg.vector_norm(g) for g in grads]
    sharded = [i for i, p in enumerate(params) if is_sharded(p)]
    if mesh is not None and sharded:
        sq = mesh.model_sum(torch.stack([norms[i] ** 2 for i in sharded]))
        for i, s in zip(sharded, torch.sqrt(sq)):
            norms[i] = s
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(cfg: ExperimentConfig, model: MultiRobotPerceptionNet,
                    optimizer: AdamW, pctx=None) -> Callable:
    """``step(state, images, depth, seg, graph) -> (state, terms)``.

    With ``grad_accum_steps`` > 1, images/depth/seg carry a leading
    [accum] microbatch axis and ``graph`` is one GraphBatch (static
    topology) or a sequence of one per microbatch (dynamic topology); the
    gradients and terms are averaged over the microbatches before one
    update. ``terms`` are device tensors: the loss terms, and ``grad_norm``
    before clipping. The step does not synchronise with the device.

    ``pctx`` (a ``parallel.context.ParallelContext``): the batch is this
    rank's node rows (under spatial sharding its image rows of them), the
    model runs with ``pctx.shard``, the loss terms are global
    (``losses.total_loss``), and after the backward the gradients are
    summed over the batch group (no DDP: its all-reduce averages, and would
    run beside the halo exchange's own collectives in the backward), so
    every rank applies the same update to what it holds; the clip norm is
    the whole gradient's (:func:`global_norm`).

    The step (forward, backward and update) runs under
    ``utils.platform.reference_numerics``: IEEE f32 matmuls and
    convolutions and deterministic cuDNN, whatever the caller has set.
    :func:`make_grad_fn` is the raw piece, under the caller's settings.
    """
    grad_fn = make_grad_fn(cfg, model, pctx)
    params = list(model.parameters())
    mesh = pctx.mesh if pctx is not None else None

    @reference_numerics()
    def train_step(state: TrainState, images, depth, seg, graph):
        with profiling.span("train.step"):
            model.train()
            grads, terms = grad_fn(images, depth, seg, graph)
            with profiling.span("train.update"):
                terms["grad_norm"] = (
                    optimizer.step(grads) if mesh is None
                    else optimizer.step(grads,
                                        global_norm(grads, params, mesh)))
            state.step += 1
            return state, terms

    return train_step


def make_parallel(cfg: ExperimentConfig, device=None):
    """This rank's ``ParallelContext`` for cfg, or None for a trivial mesh.

    A mesh larger than the world (``torch.distributed``'s ranks; one without
    a process group) shrinks, graph axis first, then model, then data, until
    it fits, with a printed line, as the JAX package shrinks it to its
    devices. ``device``: this rank's device (default
    ``parallel.launch.rank_device``).
    """
    from mrp_gnn_tpu_torch.parallel.context import make_parallel_context
    from mrp_gnn_tpu_torch.parallel.launch import world
    pc = cfg.parallel
    d, g, m = pc.data_axis_size, pc.graph_axis_size, pc.model_axis_size
    if d * g * m <= 1:
        return None
    size = world()[1]
    if d * g * m > size:
        while d * g * m > size:
            if g > 1:
                g = max(g // 2, 1)
            elif m > 1:
                m = max(m // 2, 1)
            else:
                d = max(d // 2, 1)
        print(f"[train] mesh {pc.data_axis_size}x{pc.graph_axis_size}"
              f"x{pc.model_axis_size} needs more than {size} rank(s); "
              f"clamped to {d}x{g}x{m}", flush=True)
        cfg = cfg.replace(parallel=dataclasses.replace(
            pc, data_axis_size=d, graph_axis_size=g, model_axis_size=m))
    return make_parallel_context(cfg, device)


def _microbatches(it: Iterator[dict], accum: int) -> Iterator[dict]:
    """Groups ``accum`` consecutive batches into one stacked step input;
    the graph stays one object when the topology is static, else becomes a
    list of one graph per microbatch."""
    while True:
        try:
            group = [next(it) for _ in range(accum)]
        except StopIteration:
            return
        out = {k: np.stack([b[k] for b in group])
               for k in ("images", "depth", "seg")}
        graphs = [b["graph"] for b in group]
        out["graph"] = (graphs[0] if all(g is graphs[0] for g in graphs)
                        else graphs)
        yield out


class _MicrobatchStacker:
    """:func:`_microbatches` on a producer thread, one group ahead.
    ``get_state()`` gives the inner iterator's state after the group last
    handed out; errors and ``close()`` behave as in ``TransformIterator``
    (``close_inner`` False: a caller's iterator stays open)."""

    def __init__(self, it: Iterator[dict], accum: int,
                 close_inner: bool = True):
        from mrp_gnn_tpu_torch.data.pipeline import TransformIterator
        self._inner = it
        self._close_inner = close_inner
        self._state = None
        self._groups = TransformIterator(self._stacked(accum), lambda x: x,
                                         depth=1, close_inner=False)

    def _stacked(self, accum: int):
        has_state = hasattr(self._inner, "get_state")
        for group in _microbatches(self._inner, accum):
            yield self._inner.get_state() if has_state else None, group

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        self._state, group = next(self._groups)
        return group

    def get_state(self):
        return self._state

    def close(self) -> None:
        if self._close_inner and hasattr(self._inner, "close"):
            self._inner.close()  # unblocks a producer waiting in next()
        self._groups.close()


class BatchPlacer:
    """Copies a pipeline batch to ``device``; runs on the producer thread.

    On the card: images, depth and seg are staged in fresh pinned host
    tensors (the caching host allocator keeps a block until its copy's
    event has completed), then they and the graph are copied with
    ``non_blocking`` on a side stream. Every device tensor is marked as
    used by the step's stream (``record_stream``), so the caching
    allocator does not hand its memory out again while a step still reads
    it, and an event recorded after the copies goes with the batch under
    "_ready", for the step's stream to wait on (:func:`batch_to_device`).
    A static graph (the same object every batch) is copied once. On the
    CPU a batch passes unchanged.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.step_stream = torch.cuda.current_stream(self.device)
            self.copy_stream = torch.cuda.Stream(self.device)
        self._graph = (None, None)  # the last host graph and its copy

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        d = t.pin_memory().to(self.device, non_blocking=True)
        d.record_stream(self.step_stream)
        return d

    def __call__(self, batch: dict) -> dict:
        with profiling.span("data.place"):
            if not self.cuda:
                return batch
            with torch.cuda.stream(self.copy_stream):
                arrays = [self._put(torch.from_numpy(np.asarray(batch[k])))
                          for k in ("images", "depth", "seg")]
                host, dev = self._graph
                if batch["graph"] is not host:
                    host, dev = batch["graph"], batch["graph"].apply(
                        self._put)
                    self._graph = (host, dev)
                ready = torch.cuda.Event()
                ready.record(self.copy_stream)
            return {**batch, "_placed": (*arrays, dev), "_ready": ready}


def batch_to_device(batch: dict, device) -> tuple:
    """(images, depth, seg, graph) of a pipeline batch on ``device``: the
    copies of :class:`BatchPlacer` when it placed the batch (the current
    stream then waits for them), else copies made here."""
    if "_placed" in batch:
        torch.cuda.current_stream(device).wait_event(batch["_ready"])
        return batch["_placed"]
    arrays = [torch.from_numpy(np.asarray(batch[k])).to(device)
              for k in ("images", "depth", "seg")]
    g = batch["graph"]
    graph = ([x.to(device) for x in g] if isinstance(g, (list, tuple))
             else g.to(device))
    return (*arrays, graph)


def _wrap_stream(base: Iterator[dict], accum: int, device,
                 own: bool, pctx=None) -> Iterator[dict]:
    """The loop's batch stream over ``base``: each batch placed on the card
    by a producer thread (one microbatch a step), or each group stacked by
    one (accumulation; the loop copies the group). Its ``get_state()`` is
    aligned with what the loop has taken. A caller's ``base`` (``own``
    False) is never closed. ``pctx``: each batch first becomes this rank's
    (``ParallelContext.local_batch``: its rows, its block of the plan), on
    the producer thread."""
    from mrp_gnn_tpu_torch.data.pipeline import TransformIterator
    if accum > 1:
        if pctx is not None:
            base = TransformIterator(base, pctx.local_batch, close_inner=own)
            own = True
        return _MicrobatchStacker(base, accum, close_inner=own)
    place = BatchPlacer(device)
    fn = place if pctx is None else (lambda b: place(pctx.local_batch(b)))
    return TransformIterator(base, fn, close_inner=own)


def _counts(graph, accum: int) -> tuple:
    """Views and valid edges per step (summed over microbatches)."""
    graphs = graph if isinstance(graph, (list, tuple)) else [graph] * accum
    return (sum(int(g.n_nodes) for g in graphs),
            sum(int(g.n_edges) for g in graphs))


def _write_config(cfg: ExperimentConfig) -> None:
    """The config that produced a run's checkpoints, beside them."""
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    with open(os.path.join(cfg.train.checkpoint_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def train(cfg: ExperimentConfig, num_steps: int | None = None,
          log_fn: Callable[[dict], None] | None = None,
          data_iter: Iterator[dict] | None = None, device=None) -> tuple:
    """Run training; returns (final TrainState, list of logged records).

    Runs on the CUDA card unless ``device`` says otherwise (no card: it
    raises). Each record carries ``step``, the loss terms, ``grad_norm``,
    ``wall_s``, ``step_time_s`` (host clock between log points, the device
    synchronised by reading the terms, the next batch's fetch included),
    ``views_per_s`` and ``edges_per_s``. A non-finite logged loss raises
    FloatingPointError when ``halt_on_nonfinite`` is set, before the step
    could be checkpointed.

    With ``checkpoint_dir``, the run writes ``config.json`` there, resumes
    from the newest checkpoint (its own stream then starts at the
    checkpoint's step times the accumulation; a caller's ``data_iter`` is
    used as it is) and saves every ``checkpoint_every`` steps and at the
    last. With ``eval_every``, each evaluation is a record of ``eval_*``
    keys and the best depth RMSE is kept in the state; a closing record
    gives ``best_eval_rmse`` and ``best_eval_step``. With
    ``tensorboard_dir``, every record's scalars go to a TensorBoard event
    file there.

    Under a mesh (:func:`make_parallel`; every rank calls ``train``), the
    device is this rank's (``device`` None: ``parallel.launch.rank_device``),
    the builtin stream renders this rank's node rows, and the records are
    the same on every rank; only rank 0 calls ``log_fn``, writes TensorBoard
    and saves checkpoints (of whole tensors). A caller's ``data_iter``
    yields whole batches, of which each rank takes its rows. The returned
    state's model holds this rank's shards under tensor parallelism.
    """
    pctx = make_parallel(cfg, device)
    device = pctx.device if pctx is not None else resolve_device(device)
    lead = pctx is None or pctx.mesh.rank == 0
    tr = cfg.train
    steps = num_steps if num_steps is not None else tr.steps
    accum = max(tr.grad_accum_steps, 1)
    state = create_train_state(
        cfg, device, edge_fusion_fn=pctx.edge_fusion_fn if pctx else None)
    ckpt_mgr = None
    if tr.checkpoint_dir:
        from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
        ckpt_mgr = CheckpointManager(tr.checkpoint_dir)
        if lead:
            _write_config(cfg)
        ckpt_mgr.restore_latest(state)
    if pctx is not None:
        pctx.shard_state(state)
    start_step = state.step
    own = data_iter is None
    if own:
        from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
        d = cfg.data
        base = make_train_iterator(
            d, start_batch=start_step * accum,
            data_state=ckpt_mgr.latest_data_state() if ckpt_mgr else None,
            node_range=pctx.local_node_range(
                d.max_nodes or d.scenes_per_batch * d.num_robots)
            if pctx else None)
    else:
        base = data_iter
    it = _wrap_stream(base, accum, device, own, pctx)
    records = []
    # best tracking lives in the state, so it survives checkpoint/resume
    best_rmse, best_step = state.best_rmse, state.best_step
    tb = None
    try:
        if tr.tensorboard_dir and lead:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(tr.tensorboard_dir)

        def emit(rec: dict) -> None:
            records.append(rec)
            if log_fn and lead:
                log_fn(rec)

        def summarize(step: int, scalars: dict) -> None:
            if tb is not None:
                for k, v in scalars.items():
                    tb.add_scalar(k, v, step)

        step_fn = make_train_step(cfg, state.model, state.optimizer, pctx)
        if start_step < steps:
            batch = next(it)
            n_nodes, n_edges = _counts(batch["graph"], accum)
        t0 = time.perf_counter()
        t_last, step_last = t0, start_step
        for i in range(start_step, steps):
            state, terms = step_fn(state, *batch_to_device(batch, device))
            if (i + 1) % tr.log_every == 0 or i == steps - 1:
                terms = {k: float(v) for k, v in terms.items()}
                now = time.perf_counter()
                dt = (now - t_last) / max(i + 1 - step_last, 1)
                t_last, step_last = now, i + 1
                rec = {"step": i + 1, **terms, "wall_s": now - t0,
                       "step_time_s": dt, "views_per_s": n_nodes / dt,
                       "edges_per_s": n_edges / dt}
                emit(rec)
                if tr.halt_on_nonfinite and not math.isfinite(rec["total"]):
                    # the last checkpoint stays the restart point
                    raise FloatingPointError(
                        f"non-finite loss {rec['total']} at step {i + 1}; "
                        "restart resumes from the last checkpoint")
                summarize(i + 1, {k: v for k, v in rec.items() if k != "step"})
            if tr.eval_every and (i + 1) % tr.eval_every == 0:
                from mrp_gnn_tpu_torch.evaluate import evaluate
                ev = evaluate(cfg, state.model, pctx=pctx)
                ev_rec = {"step": i + 1,
                          **{f"eval_{k}": v for k, v in ev.items()}}
                emit(ev_rec)
                summarize(i + 1, {k: v for k, v in ev_rec.items()
                                  if k != "step" and isinstance(v, (int, float))})
                if "rmse" in ev and ev["rmse"] < best_rmse:
                    best_rmse, best_step = ev["rmse"], i + 1
                    state.best_rmse, state.best_step = best_rmse, best_step
            if ckpt_mgr and ((i + 1) % tr.checkpoint_every == 0
                             or i == steps - 1):
                whole = pctx.full_tensors(state) if pctx else None
                if lead:
                    ckpt_mgr.save(i + 1, state, data_state=it.get_state(),
                                  tensors=whole)
            if i + 1 < steps:
                batch = next(it)
        if best_step >= 0:
            emit({"step": steps, "best_eval_rmse": best_rmse,
                  "best_eval_step": best_step})
    finally:
        it.close()  # and the pipeline below it, unless it is the caller's
        if tb is not None:
            tb.close()
    if ckpt_mgr:
        ckpt_mgr.close()
    return state, records


def add_multihost_args(p: argparse.ArgumentParser) -> None:
    """The multi-process flags of the train and eval CLIs, under the JAX
    package's names, and ``--dist_backend``. There is no
    ``--local_device_count``: one rank is one process."""
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0; enables torch.distributed")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default="nccl", choices=["nccl", "gloo"],
                   help="nccl: one card per rank; gloo: through host "
                        "memory, ranks may share a card")


def init_multihost(args) -> None:
    """``parallel.launch.initialize`` from parsed CLI flags (nothing without
    --coordinator)."""
    from mrp_gnn_tpu_torch.parallel.launch import initialize
    initialize(coordinator=args.coordinator,
               num_processes=args.num_processes,
               process_id=args.process_id, backend=args.dist_backend)


def add_axis_args(p: argparse.ArgumentParser) -> None:
    """Overrides of ParallelConfig's mesh axes, as the JAX CLI has them
    (``spatial_sharding`` comes from the config, as there)."""
    p.add_argument("--data_axis", type=int, default=None,
                   help="override ParallelConfig.data_axis_size")
    p.add_argument("--graph_axis", type=int, default=None,
                   help="override ParallelConfig.graph_axis_size")
    p.add_argument("--model_axis", type=int, default=None,
                   help="override ParallelConfig.model_axis_size")
    p.add_argument("--expanded_plan_pairs", type=int, default=None,
                   help="override ParallelConfig.expanded_plan_pairs (the "
                        "per-shard row-expanded plan opt-in for dynamic "
                        "partitioned streams past width 128)")


def apply_axis_args(cfg: ExperimentConfig, args) -> ExperimentConfig:
    kw = {f: v for f, v in (("data_axis_size", args.data_axis),
                            ("graph_axis_size", args.graph_axis),
                            ("model_axis_size", args.model_axis),
                            ("expanded_plan_pairs", args.expanded_plan_pairs))
          if v is not None}
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel, **kw))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--depth_loss", default=None, choices=["l1", "berhu", "silog"])
    p.add_argument("--train_scenes", type=int, default=None)
    p.add_argument("--grad_accum", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--max_restarts", type=int, default=0,
                   help="on non-finite loss, resume from the last checkpoint "
                        "with halved LR up to N times (needs "
                        "--checkpoint_dir)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dataset_root", default=None,
                   help="train on on-disk scene folders (data/disk.py)")
    p.add_argument("--augment", action="store_true",
                   help="rig-consistent flip and photometric jitter")
    p.add_argument("--debug", action="store_true",
                   help="autograd anomaly detection on, and host-side "
                        "validation of the first batch's graph")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; under a mesh "
                        "the card of the rank's local rank)")
    add_axis_args(p)
    add_multihost_args(p)
    args = p.parse_args(argv)
    init_multihost(args)

    cfg = apply_axis_args(get_config(args.config), args)
    tr = cfg.train
    if args.lr is not None:
        tr = dataclasses.replace(tr, learning_rate=args.lr)
    if args.checkpoint_dir is not None:
        tr = dataclasses.replace(tr, checkpoint_dir=args.checkpoint_dir)
    if args.log_every is not None:
        tr = dataclasses.replace(tr, log_every=args.log_every)
    if args.tensorboard_dir is not None:
        tr = dataclasses.replace(tr, tensorboard_dir=args.tensorboard_dir)
    if args.depth_loss is not None:
        tr = dataclasses.replace(tr, depth_loss=args.depth_loss)
    if args.steps is not None:
        tr = dataclasses.replace(tr, steps=args.steps)
    if args.grad_accum is not None:
        tr = dataclasses.replace(tr, grad_accum_steps=args.grad_accum)
    if args.eval_every is not None:
        tr = dataclasses.replace(tr, eval_every=args.eval_every)
    if args.remat:
        tr = dataclasses.replace(tr, remat=True)
    cfg = cfg.replace(train=tr)
    if args.train_scenes is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, num_train_scenes=args.train_scenes))
    if args.dataset_root is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, dataset_root=args.dataset_root))
    if args.augment:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, augment=True))
    if args.dtype is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dtype=args.dtype))
    if args.coordinator is None:
        device = resolve_device(args.device)
    else:
        from mrp_gnn_tpu_torch.parallel.launch import rank_device
        device = rank_device(args.device)
    if args.debug:
        from mrp_gnn_tpu_torch.data.pipeline import make_dataset
        from mrp_gnn_tpu_torch.utils.debug import enable_debug, validate_graph
        validate_graph(next(iter(make_dataset(cfg.data, "train")))["graph"])
        enable_debug()
        print("[train] debug mode: autograd anomaly detection on, graph "
              "validated")
    print(f"[train] config={cfg.name} steps={cfg.train.steps} "
          f"device={device}", flush=True)
    # Restart-based divergence recovery: the watchdog raises before a bad
    # state is checkpointed; the run resumes from the last good checkpoint
    # with halved LR, so the deterministic stream does not re-diverge
    # identically.
    restarts = 0
    try:
        while True:
            try:
                _, records = train(
                    cfg, log_fn=lambda r: print(json.dumps(r), flush=True),
                    device=device)
                break
            except FloatingPointError as e:
                if restarts >= args.max_restarts or not cfg.train.checkpoint_dir:
                    raise
                restarts += 1
                new_lr = cfg.train.learning_rate * 0.5
                print(f"[train] {e}; restart {restarts}/{args.max_restarts} "
                      f"with lr={new_lr:g}", flush=True)
                cfg = cfg.replace(train=dataclasses.replace(
                    cfg.train, learning_rate=new_lr))
    finally:
        if args.debug:
            from mrp_gnn_tpu_torch.utils.debug import disable_debug
            disable_debug()
    losses = [r["total"] for r in records if "total" in r]
    if losses:
        print(f"[train] final loss {losses[-1]:.4f}")
    if args.coordinator is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
