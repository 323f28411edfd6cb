"""Benchmark harness (port of ``mrp_gnn_tpu/benchmark.py``): fusion
edges/s, the edge block's training rate, the train step, per-stage
speed-of-light accounting, and over ``torch.distributed`` ranks the
partitioned fusion's weak scaling and the overlap of its value exchange.
Emits JSONL records with the JAX package's keys; ``"backend"`` is the torch
device type.

Routes: ``xla_*`` are the plain torch ops, ``pallas_*`` the port's CUDA
kernels through ``ops/dispatch.get_ops("pallas")`` (on CPU tensors their
plain versions). Dispatch routes the block-diagonal league to the plain
einsums, as the JAX package's does; ``pallas_block`` swaps the block
kernel in (``ops/edge.with_block_kernel``), so that it times a kernel. The
fusion and training-edge records also carry ``launches``: the kernel
launches of the route's timing, by wrapper (``ops/bsp.launch_counts``).

Every bench runs under ``utils.platform.reference_numerics`` (IEEE f32,
deterministic cuDNN), the numerics that the entry points give users.

Timing chains ``inner`` data-dependent applications between two CUDA
events (host clock on the CPU), best of ``reps``, after a warm call that
also builds the kernels. Numbers describe one process: steps drift
between and within long processes, so compare routes within one run.

CLI:
  python -m mrp_gnn_tpu_torch.benchmark --what fusion --nodes 8192
  python -m mrp_gnn_tpu_torch.benchmark --what train --config dynamic_swarm
  python -m mrp_gnn_tpu_torch.benchmark --what mfu --config dynamic_swarm
  python -m mrp_gnn_tpu_torch.benchmark --what scaling \
      --coordinator localhost:29500 --num_processes 8 --process_id $ID \
      --dist_backend gloo       # one process per rank; rank 0 prints
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from mrp_gnn_tpu_torch.config import ExperimentConfig, get_config
from mrp_gnn_tpu_torch.utils.platform import (reference_numerics,
                                              resolve_device)

# The probes of the machine's ceilings (_probe_ceilings): a bf16 matmul of
# PROBE_MM^3, as the JAX package's; a permuted copy of PROBE_D-wide bf16 rows
# over PROBE_L2_MULTIPLE times the card's L2 cache, so that it streams from
# HBM (the JAX package's 32 MiB buffer fits in an H100's 50 MB L2), or of
# PROBE_CPU_ROWS rows on the CPU.
PROBE_MM = 4096
PROBE_D = 2048
PROBE_L2_MULTIPLE = 4
PROBE_CPU_ROWS = 8192


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _elapsed(run, device: torch.device) -> float:
    """Seconds that ``run()`` takes: CUDA events on the card, the host
    clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_chained(fn_body, init, inner: int, reps: int = 3) -> float:
    """Steady-state seconds per application of ``fn_body``: ``inner``
    applications, each fed the last one's output, best of ``reps`` after a
    warm chain."""
    def chained():
        x = init
        for _ in range(inner):
            x = fn_body(x)
        return x

    chained()  # warm; builds the kernels
    return min(_elapsed(chained, init.device) for _ in range(reps)) / inner


def _resolve(config) -> ExperimentConfig:
    return get_config(config) if isinstance(config, str) else config


def _edge_inputs(nodes, feature_dim, attention_dim, device):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(nodes, d)).astype(np.float32)
                             ).to(device)
            for d in (attention_dim, attention_dim, feature_dim)]


def _timed_route(body, x0, inner) -> tuple:
    """(seconds per call, kernel launches of the timing by wrapper)."""
    from mrp_gnn_tpu_torch.ops import bsp
    before = bsp.launch_counts()
    sec = time_chained(body, x0, inner)
    after = bsp.launch_counts()
    return sec, {k: after[k] - before[k] for k in after if after[k] > before[k]}


@reference_numerics()
def bench_fusion(nodes=8192, feature_dim=2048, attention_dim=64,
                 robots=8, inner=50,
                 paths=("xla_scatter", "xla_ell", "pallas_ell",
                        "xla_block", "pallas_block"), device=None) -> list:
    """edges/s of the attention edge block per route, forward.

    Routes: *_block = dense block-diagonal; *_ell = padded neighbour list
    (the tile-pair plan's fused kernel on pallas); xla_scatter = the
    edge-list gather/scatter-add baseline. A route that fails raises.
    """
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
    from mrp_gnn_tpu_torch.ops import dispatch, edge
    device = resolve_device(device)
    gb_block = batch_fully_connected(nodes // robots, robots)
    gb_ell = dataclasses.replace(gb_block, scene_adj=None, scene_stride=0)
    gb_scatter = dataclasses.replace(gb_ell, ell_src=None, ell_mask=None)
    E = int(gb_block.n_edges)
    graphs = {k: g.to(device) for k, g in (("scatter", gb_scatter),
                                           ("ell", gb_ell),
                                           ("block", gb_block))}
    q, k, v = _edge_inputs(nodes, feature_dim, attention_dim, device)

    out = []
    for path in paths:
        impl, kind = path.split("_", 1)
        ops = dispatch.get_ops(impl)
        if path == "pallas_block":
            ops = edge.with_block_kernel(ops)
        gb = graphs[kind]

        @torch.no_grad()
        def body(x, ops=ops, gb=gb):
            # the attention output is a convex combination of values, so
            # feeding it straight back keeps the chain bounded and
            # data-dependent without adding memory traffic
            return default_edge_fusion(ops, "attention", q, k, x, gb).to(x.dtype)

        sec, launches = _timed_route(body, v, inner)
        rec = {"bench": "fusion", "path": path, "nodes": nodes, "edges": E,
               "feature_dim": feature_dim, "sec_per_call": sec,
               "edges_per_s": E / sec, "backend": device.type,
               "launches": launches}
        out.append(rec)
        _log(f"{path}: {E / sec:,.0f} edges/s ({sec * 1e6:.0f} us/call), "
             f"launches {launches}")
    return out


@reference_numerics()
def bench_train_edge(nodes=8192, feature_dim=2048, attention_dim=64,
                     robots=8, inner=20, paths=("xla_ell", "pallas_ell"),
                     device=None) -> list:
    """Gradient-direction (forward + backward) edges/s of the attention
    edge block: the gradient of sum(out ** 2) with respect to the bf16
    values, fed forward so the chain stays data-dependent. On pallas the
    backward runs the SDDMM, SpMM and transposed-SpMM kernels."""
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
    from mrp_gnn_tpu_torch.ops import dispatch
    device = resolve_device(device)
    gb = dataclasses.replace(batch_fully_connected(nodes // robots, robots),
                             scene_adj=None, scene_stride=0)
    E = int(gb.n_edges)
    gb = gb.to(device)
    q, k, v = _edge_inputs(nodes, feature_dim, attention_dim, device)
    v = v.to(torch.bfloat16)

    out = []
    for path in paths:
        ops = dispatch.get_ops(path.split("_", 1)[0])

        def body(vv, ops=ops):
            x = vv.detach().requires_grad_()
            loss = (default_edge_fusion(ops, "attention", q, k, x, gb)
                    .float() ** 2).sum()
            return torch.autograd.grad(loss, x)[0].to(vv.dtype)

        sec, launches = _timed_route(body, v, inner)
        rec = {"bench": "train_edge", "path": path, "nodes": nodes,
               "edges": E, "feature_dim": feature_dim, "sec_per_call": sec,
               "edges_per_s": E / sec, "backend": device.type,
               "launches": launches}
        out.append(rec)
        _log(f"train_edge {path}: {E / sec:,.0f} edges/s "
             f"({sec * 1e6:.0f} us/call), launches {launches}")
    return out


def _train_setup(cfg: ExperimentConfig, device):
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.train import (batch_to_device, create_train_state,
                                         make_train_step)
    batch = next(iter(make_dataset(cfg.data, "train", shuffle=False)))
    state = create_train_state(cfg, device)
    step_fn = make_train_step(cfg, state.model, state.optimizer)
    return batch, state, step_fn, batch_to_device(batch, device)


@reference_numerics()
def bench_train(config="five_robot_attention", inner=20, device=None) -> list:
    """Train-step time (forward, loss, backward, update) of a preset (a
    name, or an ExperimentConfig) on its first train batch, after a warm
    step."""
    device = resolve_device(device)
    cfg = _resolve(config)
    batch, state, step_fn, args = _train_setup(cfg, device)
    step_fn(state, *args)  # warm
    _sync(device)

    def run():
        for _ in range(inner):
            step_fn(state, *args)

    sec = _elapsed(run, device) / inner
    E = int(batch["graph"].n_edges)
    V = int(batch["graph"].n_nodes)
    rec = {"bench": "train_step", "config": cfg.name, "sec_per_step": sec,
           "steps_per_s": 1 / sec, "nodes_per_s": V / sec,
           "edges_per_s": E / sec, "backend": device.type}
    _log(f"train[{cfg.name}]: {sec * 1e3:.2f} ms/step")
    return [rec]


def _stream_rows(device: torch.device) -> int:
    if device.type != "cuda":
        return PROBE_CPU_ROWS
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return math.ceil(PROBE_L2_MULTIPLE * l2 / (PROBE_D * 2))


def _probe_ceilings(device, inner=30, reps=3) -> tuple:
    """In-run machine ceilings: stream bandwidth (a permuted copy: a
    data-dependent gather that cannot be fused away) over a buffer several
    times the L2 cache, and bf16 matmul FLOP rate (a square matmul
    chain, ``torch.addmm`` with the 1/M scale in the product's epilogue,
    as XLA fuses it, not a separate multiply with a pass of its own).
    Best of ``reps``."""
    N = _stream_rows(device)
    v = torch.ones((N, PROBE_D), dtype=torch.bfloat16, device=device)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(N)).to(device)
    sec = time_chained(lambda c: c[perm], v, inner, reps)
    stream = 2 * N * PROBE_D * 2 / sec
    M = PROBE_MM
    a = torch.ones((M, M), dtype=torch.bfloat16, device=device)
    sec = time_chained(lambda c: torch.addmm(c, c, c, beta=0.0, alpha=1.0 / M),
                       a, inner, reps)
    matmul = 2 * M ** 3 / sec
    _log(f"ceilings: stream {stream / 1e9:,.1f} GB/s over a "
         f"{N * PROBE_D * 2 / 2**20:,.0f} MiB bf16 buffer [{N}, {PROBE_D}], "
         f"bf16 matmul {matmul / 1e12:,.1f} TFLOP/s at {M}^3")
    return stream, matmul


def _nbytes(*trees) -> int:
    """Bytes of every tensor in nested tuples / lists / dicts / modules."""
    total = 0
    for t in trees:
        if isinstance(t, torch.nn.Module):
            total += _nbytes(list(t.parameters()))
        elif torch.is_tensor(t):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += _nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += _nbytes(*t)
    return total


def _flops(fn, *args) -> float | None:
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops()) or None


@reference_numerics()
def bench_mfu(config="five_robot_attention", inner=20,
              encoder_channels=None, device=None) -> list:
    """Train-step accounting against the machine, stage by stage (encoder,
    fusion, decoder, heads, train_step): FLOPs, the least bytes, wall time
    from data-dependent chains, and the fraction of the speed-of-light time
    that the in-run probed matmul and stream ceilings give.

    FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which
    counts only aten ops with a FLOP formula (convolutions, matmuls,
    attention): neither the port's kernel launches (ctypes) nor elementwise
    ops, which XLA's cost analysis counts. So ``flops`` is a lower count
    than the JAX package's for the same stage, and ``logical_bytes`` (XLA's
    bytes accessed) is None. An f32 model (with TF32 off, as
    ``chip_smoke.py`` sets it) is held to a bf16 matmul ceiling, as in the
    JAX package, so its ``sol_frac`` reads low.

    Chain protocol: each stage feeds ``x + 1e-20 * mean(out)`` forward, so
    the chain stays data-dependent while adding one scalar reduction of the
    stage output to the traffic.
    """
    device = resolve_device(device)
    cfg = _resolve(config)
    config_name = cfg.name
    if encoder_channels is not None:
        # compute-dense control: the same step with a wide-channel encoder
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, encoder_channels=tuple(encoder_channels)))
        config_name = f"{config_name}+ch{'-'.join(map(str, encoder_channels))}"
    mc = cfg.model
    batch, state, step_fn, args = _train_setup(cfg, device)
    model = state.model
    images, graph = args[0], args[3]
    stream_bw, matmul_fl = _probe_ceilings(device)

    x_img = images.to(model.dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        skips, bottleneck = model.encoder(x_img)
    # stage name -> (fn, x0, what else it reads, for the least bytes)
    stages = {"encoder": (lambda x: model.encoder(x)[1], x_img,
                          model.encoder)}
    fused = bottleneck
    if model.num_fusion_layers:
        stages["fusion"] = (lambda x: model.fusion0(x, graph), bottleneck,
                            model.fusion0)
        with torch.no_grad():
            fused = model.fusion0(bottleneck, graph)
    stages["decoder"] = (lambda x: model.decoder(skips, x), fused,
                         (model.decoder, skips))
    with torch.no_grad():
        dec_out = model.decoder(skips, fused)
    heads = [getattr(model, h) for h in ("depth_head", "seg_head")
             if hasattr(model, h)]
    if heads:
        stages["heads"] = (lambda x: sum(h(x).sum() for h in heads), dec_out,
                           heads)

    out = []

    def account(name, sec, flops, min_bytes):
        """The stage's speed-of-light time from the binding ceiling: FLOPs
        against the probed matmul rate, the least traffic (inputs, params
        and outputs) against the probed stream bandwidth."""
        t_mm = flops / matmul_fl if flops else 0.0
        t_st = min_bytes / stream_bw
        t_sol = max(t_mm, t_st, 1e-12)
        rec = {"bench": "mfu", "config": config_name, "stage": name,
               "sec": sec, "flops": flops, "logical_bytes": None,
               "min_bytes": min_bytes,
               "achieved_tflops": (flops / sec / 1e12) if flops else None,
               "bound": "matmul" if t_mm >= t_st else "stream",
               "sol_frac": t_sol / sec,
               "stream_ceiling_gbs": stream_bw / 1e9,
               "matmul_ceiling_tflops": matmul_fl / 1e12,
               "backend": device.type}
        out.append(rec)
        _log(f"{name:>10}: {sec*1e3:8.2f} ms  {(flops or 0)/1e9:8.2f} GFLOP"
             f" {min_bytes/1e6:8.1f} MB(min)  bound={rec['bound']}  "
             f"sol={rec['sol_frac']:.2f}")

    for name, (fn, x0, extra) in stages.items():
        @torch.no_grad()
        def body(c, fn=fn):
            dep = fn(c).float().mean()
            return c + (1e-20 * dep).to(c.dtype)

        with torch.no_grad():
            flops = _flops(fn, x0)
            out_bytes = _nbytes(fn(x0))
        sec = time_chained(body, x0, inner)
        account(name, sec, flops, _nbytes(x0, extra) + out_bytes)

    # full train step (forward, backward, optimizer), chained through the
    # state; least traffic: read and write the params and moments, read the
    # batch (activations excluded: a lower bound)
    opt = state.optimizer
    min_bytes = (2 * _nbytes(model) + 2 * _nbytes(opt.mu, opt.nu)
                 + _nbytes(args[:3]))
    flops = _flops(step_fn, state, *args)  # also the warm step
    _sync(device)

    def run():
        for _ in range(inner):
            step_fn(state, *args)

    account("train_step", _elapsed(run, device) / inner, flops, min_bytes)
    return out


def _scaling_graph(topology, scenes, robots, comm_radius=4):
    from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for
    return batch_homogeneous(
        scenes, robots, scene_edges_for(robots, topology, comm_radius))


def _weak_scaling_batch(topology, P, robots, scenes_per_shard):
    """Graph for the P-shard point of the weak-scaling sweep.

    full:   scenes_per_shard*P dense scenes of `robots` (boundary-heavy:
            scenes straddle shards whenever robots > nodes-per-shard).
    radius: ONE growing swarm of 128*P robots, comm radius 4 — per-shard
            nodes/edges constant, the swarm spans every shard, and the
            boundary set per shard is a constant halo.
    """
    if topology == "radius":
        return _scaling_graph("radius", 1, 128 * P)
    return _scaling_graph("full", scenes_per_shard * P, robots)


def _shard_inputs(V, feature_dim, rows, device):
    """This shard's rows of the seeded q, k [V, 64] and v [V, D]."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32)
                             [rows]).to(device)
            for d in (64, 64, feature_dim)]


def _graph_mesh(P: int, rank: int):
    """A (1, P) mesh of ranks 0..P-1 of the world (every rank calls it: it
    creates the subgroup), or None on a rank past P."""
    import torch.distributed as dist
    from mrp_gnn_tpu_torch.parallel.launch import world
    from mrp_gnn_tpu_torch.parallel.mesh import Mesh
    if world()[1] == 1:
        from mrp_gnn_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(1, 1)
    group = dist.new_group(list(range(P)))
    if rank >= P:
        return None
    return Mesh(data=1, graph=P, rank=rank, backend=dist.get_backend(),
                graph_group=group, graph_ranks=tuple(range(P)))


def _share(obj, rank: int):
    """Rank 0's ``obj`` on every rank (itself in a world of one rank)."""
    import torch.distributed as dist
    from mrp_gnn_tpu_torch.parallel.launch import world
    if world()[1] == 1:
        return obj
    box = [obj if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@reference_numerics()
def bench_scaling(max_devices=None, robots=8, scenes_per_shard=16,
                  feature_dim=2048, inner=30, topology="full",
                  exchange="boundary", device=None) -> list:
    """Weak-scaling efficiency of the partitioned fusion over the graph axis,
    on ranks 0..P-1 of the ``torch.distributed`` world for P = 1, 2, 4, ...
    up to the world (or ``max_devices``); the other ranks wait at a barrier.

    Per-shard work is held constant; efficiency(P) =
    edges/s(P) / (P * edges/s(1)). topology: "full" (dense swarms — most
    edges boundary) or "radius" (sparse). exchange: "boundary" |
    "all_gather". Every rank calls it and returns rank 0's records (its
    timing: the exchange keeps the ranks in step). The fusion runs on the
    plain ops (``dispatch.get_ops("xla")``), as the JAX function's does;
    the port's plain local aggregate is its gather and einsum
    (``ops/reference.ell_aggregate``) where JAX's is a segment sum, and with
    gloo each exchange goes through host memory.
    """
    import torch.distributed as dist
    from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
    from mrp_gnn_tpu_torch.ops import dispatch
    from mrp_gnn_tpu_torch.parallel.fused import make_partitioned_edge_fusion
    from mrp_gnn_tpu_torch.parallel.launch import rank_device, world
    from mrp_gnn_tpu_torch.parallel.partition import (boundary_fraction,
                                                      exchange_rows,
                                                      partition_graph)
    rank, size = world()
    device = rank_device(device) if size > 1 else resolve_device(device)
    ndev = min(max_devices or size, size)
    ops = dispatch.get_ops("xla", device)
    out, base, P = [], None, 1
    while P <= ndev:
        gb = _weak_scaling_batch(topology, P, robots, scenes_per_shard)
        V = gb.max_nodes
        E = int(gb.n_edges)
        extras, sec = {}, None
        if P == 1:
            if rank == 0:
                q, k, v = _shard_inputs(V, feature_dim, slice(None), device)
                g = gb.to(device)

                @torch.no_grad()
                def body(v, g=g, q=q, k=k):
                    return (default_edge_fusion(ops, "attention", q, k, v, g)
                            * 0.5 + v * 0.5)

                sec = time_chained(body, v, inner)
        else:
            mesh = _graph_mesh(P, rank)
            plan = partition_graph(gb, P)
            extras = {"boundary_fraction": round(boundary_fraction(plan), 4),
                      "recv_rows_per_shard": exchange_rows(plan)[
                          "boundary" if exchange == "boundary"
                          else "all_gather"]}
            if mesh is not None:
                n = plan.nodes_per_shard
                q, k, v = _shard_inputs(V, feature_dim,
                                        slice(rank * n, (rank + 1) * n),
                                        device)
                edge_fn = make_partitioned_edge_fusion(mesh, plan,
                                                       exchange=exchange)

                @torch.no_grad()
                def body(v, edge_fn=edge_fn, q=q, k=k):
                    return (edge_fn(ops, "attention", q, k, v, None) * 0.5
                            + v * 0.5)

                sec = time_chained(body, v, inner)
        if size > 1:
            dist.barrier()
        sec = _share(sec, rank)
        eps = E / sec
        if base is None:
            base = eps
        eff = eps / (base * P)
        rec = {"bench": "scaling", "devices": P, "edges": E,
               "topology": topology, "exchange": exchange,
               "edges_per_s": eps, "efficiency": eff,
               "backend": device.type, **extras}
        out.append(rec)
        if rank == 0:
            _log(f"P={P} [{topology}/{exchange}]: {eps:,.0f} edges/s, "
                 f"weak-scaling eff {eff:.2%} {extras}")
        P *= 2
    return out


def _range_ms(events, name: str, device_type) -> list:
    """[(start, end)] in ms of the profiler ranges ``name``, in time order."""
    return sorted((e.time_range.start / 1e3, e.time_range.end / 1e3)
                  for e in events if e.name == name
                  and e.device_type == device_type)


def profile_window(fn, device) -> dict:
    """A call of ``fn`` under ``torch.profiler``: the window of its value
    exchange (the last ``halo.post:values`` range's end to its
    ``halo.wait:values`` range's end, host clock) and the compute inside it
    and in all: the card's kernel time (CUDA), or the CPU's own op time (the
    CPU), in ms. The window stands in for the JAX package's count of
    scheduled HLO ops between the collective's start and its done
    (``hlo_overlap_window``), which torch has no counterpart of."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(2):  # the profiler's first trace pays its start-up
        with profile(activities=acts) as prof:
            fn()
            _sync(device)
    events = prof.events()
    posts = _range_ms(events, "halo.post:values", DeviceType.CPU)
    waits = _range_ms(events, "halo.wait:values", DeviceType.CPU)
    if not posts or not waits:
        return {"n_exchanges": 0, "overlap_window_ms": 0.0,
                "compute_in_window_ms": 0.0, "compute_ms": None}
    lo, hi = posts[-1][1], waits[-1][1]
    if cuda:
        spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("halo.", "Memcpy", "Memset"))]
        inside = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in spans)
        total = sum(b - a for a, b in spans)
    else:  # the calling thread's ops (gloo's threads run its transfers)
        thread = next(e.thread for e in events
                      if e.name == "halo.post:values")
        ops = [e for e in events if e.device_type == DeviceType.CPU
               and e.thread == thread
               and not e.name.startswith(("halo.", "gloo:"))]
        total = sum(e.self_cpu_time_total for e in ops) / 1e3
        inside = sum(e.self_cpu_time_total for e in ops
                     if e.time_range.start / 1e3 >= lo
                     and e.time_range.end / 1e3 <= hi) / 1e3
    return {"n_exchanges": len(posts) + len(_range_ms(
                events, "halo.post:keys", DeviceType.CPU)),
            "overlap_window_ms": hi - lo, "compute_in_window_ms": inside,
            "compute_ms": total}


@reference_numerics()
def bench_overlap(devices=None, feature_dim=4096, inner=30,
                  topology="radius", device=None) -> list:
    """Overlap of the boundary exchange with the local aggregate, over the
    ranks of the ``torch.distributed`` world (a (1, world) mesh; every rank
    calls it and returns rank 0's records).

    For overlap on and off, in turns (on, off, on, off; the faster turn of
    each kept): the time per call, and from a profile of one call on rank 0
    the window in which the value exchange is in flight and the compute
    inside it (:func:`profile_window`, in the place of the JAX package's
    HLO window). A summary record gives ``speedup_vs_serialized``. Plain
    ops, as in :func:`bench_scaling`.
    """
    from mrp_gnn_tpu_torch.ops import dispatch
    from mrp_gnn_tpu_torch.parallel.fused import make_partitioned_edge_fusion
    from mrp_gnn_tpu_torch.parallel.launch import rank_device, world
    from mrp_gnn_tpu_torch.parallel.partition import partition_graph
    rank, size = world()
    device = rank_device(device) if size > 1 else resolve_device(device)
    ndev = devices or size
    ops = dispatch.get_ops("xla", device)
    gb = _weak_scaling_batch(topology, ndev, 8, 2)
    E = int(gb.n_edges)
    plan = partition_graph(gb, ndev)
    mesh = _graph_mesh(ndev, rank)
    n = plan.nodes_per_shard
    q, k, v = _shard_inputs(gb.max_nodes, feature_dim,
                            slice(rank * n, (rank + 1) * n), device)
    bodies = {}
    for overlap in (True, False):
        edge_fn = make_partitioned_edge_fusion(mesh, plan, overlap=overlap)

        @torch.no_grad()
        def one(v, edge_fn=edge_fn):
            return edge_fn(ops, "attention", q, k, v, None) * 0.5 + v * 0.5

        bodies[overlap] = one
    timings, windows = {}, {}
    for overlap in (True, False, True, False):
        sec = time_chained(bodies[overlap], v, inner)
        timings[overlap] = min(timings.get(overlap, sec), sec)
        if overlap not in windows:
            win = profile_window(lambda: bodies[overlap](v), device)
            windows[overlap] = win if rank == 0 else None
    timings = _share(timings, rank)
    windows = _share(windows, rank)
    out = []
    for overlap in (True, False):
        sec = timings[overlap]
        out.append({"bench": "overlap", "overlap": overlap, "devices": ndev,
                    "topology": topology, "edges": E,
                    "feature_dim": feature_dim, "sec_per_call": sec,
                    "edges_per_s": E / sec, "backend": device.type,
                    **windows[overlap]})
        if rank == 0:
            _log(f"overlap={overlap}: {sec * 1e6:.0f} us/call, window "
                 f"{windows[overlap]['overlap_window_ms']:.3f} ms with "
                 f"{windows[overlap]['compute_in_window_ms']:.3f} ms of "
                 "compute inside")
    gain = timings[False] / timings[True] - 1.0
    if rank == 0:
        _log(f"overlap speedup vs serialized: {gain:+.2%}")
    out.append({"bench": "overlap_summary", "devices": ndev,
                "speedup_vs_serialized": gain})
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--what", default="fusion",
                   choices=["fusion", "train", "train_edge", "mfu",
                            "scaling", "overlap", "all"])
    p.add_argument("--nodes", type=int, default=8192)
    p.add_argument("--feature_dim", type=int, default=2048)
    p.add_argument("--config", default="five_robot_attention")
    p.add_argument("--encoder_channels", default=None,
                   help="comma-separated override for the encoder channel "
                        "stack (mfu compute-dense control, e.g. 128,256,512)")
    p.add_argument("--inner", type=int, default=50)
    p.add_argument("--out", default=None, help="append JSONL to this file")
    p.add_argument("--profile", default=None,
                   help="capture a torch.profiler trace into this directory")
    p.add_argument("--topology", default="full", choices=["full", "radius"])
    p.add_argument("--exchange", default="boundary",
                   choices=["boundary", "all_gather"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; over ranks "
                        "the card of the rank's local rank)")
    from mrp_gnn_tpu_torch.train import add_multihost_args, init_multihost
    add_multihost_args(p)
    args = p.parse_args(argv)
    init_multihost(args)
    if args.coordinator is None:
        device = resolve_device(args.device)
    else:
        from mrp_gnn_tpu_torch.parallel.launch import rank_device
        device = rank_device(args.device)
    lead = torch.distributed.get_rank() == 0 if args.coordinator else True

    recs = []
    if args.profile:
        from mrp_gnn_tpu_torch.utils.profiling import trace
        ctx = trace(args.profile)
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        if args.what in ("fusion", "all"):
            recs += bench_fusion(args.nodes, args.feature_dim,
                                 inner=args.inner, device=device)
        if args.what in ("train", "all"):
            recs += bench_train(args.config, device=device)
        if args.what in ("train_edge", "all"):
            recs += bench_train_edge(args.nodes, args.feature_dim,
                                     inner=max(args.inner // 2, 10),
                                     device=device)
        if args.what in ("mfu", "all"):
            ch = (tuple(int(c) for c in args.encoder_channels.split(","))
                  if args.encoder_channels else None)
            recs += bench_mfu(args.config, inner=max(args.inner // 2, 10),
                              encoder_channels=ch, device=device)
        if args.what in ("scaling", "all"):
            recs += bench_scaling(inner=args.inner, topology=args.topology,
                                  exchange=args.exchange, device=device)
        if args.what in ("overlap", "all"):
            recs += bench_overlap(inner=args.inner, topology=args.topology,
                                  device=device)
    for r in recs if lead else ():
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    if args.coordinator is not None:
        torch.distributed.destroy_process_group()
    return recs


if __name__ == "__main__":
    main()
