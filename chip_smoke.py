"""Drive the PyTorch port's serving, export, training, data and parallel
(data x graph, and the model axis) paths on one CUDA card and check them.

    python3 chip_smoke.py

(``python3 chip_smoke.py --parallel-rank R WORLD STORE OUT`` is one rank
of phase 10, ``--model-axis-rank MODE R WORLD STORE OUT`` one of phase 11;
the script starts them itself.)

Seven paths through the fusion layer, each at the full width of a preset
(64x64 images, encoder 32/64/128, one fusion layer, 6 classes, f32, random
seeded weights; numpy renderer and graph builder unless said otherwise):

- attention: ``dynamic_swarm`` itself (8 scenes x 32 drifting robots, a new
  radius graph per batch, ELL width 32 with a tile-pair plan);
- hideg attention: 2 fully connected scenes of 193 robots in 512 node
  slots (in-degree 192, a row-expanded plan of 2 rows x 96);
- mean and max: ``dynamic_swarm`` with ``model.fusion`` "mean" and "max";
- block: ``multitask_batched`` (8 fully connected scenes of 5 robots, a
  block-diagonal batch of 40 node slots), with the block attention kernel
  swapped in through the model's ``edge_fusion_fn`` as bench.py swaps it;
- ell: ``dynamic_swarm`` with the plan-free ELL attention (the ELL SDDMM,
  softmax and SpMM kernels) swapped in the same way, the plan ignored;
- bsp2: ``dynamic_swarm`` on the native C++ renderer and graph builder
  (``renderer`` and ``graph_builder`` "native": the JAX package's default
  host side, which raises rather than fall back), with the two-kernel
  attention (the weights kernel, then the SpMM) swapped in.

The fused attention's backward (attention and hideg) takes dvalues and dk
from one launch of the dual transposed SpMM; on the hideg path it runs on
the node view of the row-expanded lists, where the SDDMM and the transposed
SpMM take their tiled form (``bsp.tiled_form``: ELL width 192), as does
the hideg forward (``bsp.expanded_forward``).

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: every CUDA kernel of the paths, compiled with nvcc for sm_90a
   (one nvcc per source, all started together), and the native renderer
   and graph builder, compiled with g++;
3. each kernel against its plain torch version on the card: the fused
   attention on the first ``dynamic_swarm`` eval batch (f32 and bf16
   values); the SDDMM, SpMM and transposed SpMM on the first train batch
   at the training step's shapes (f32, bf16, and an f32 cotangent against
   bf16 values); all of them on a crafted graph with empty rows,
   duplicate edges, a degree-100 row and padded nodes at D 1030 (scalar
   path) and 4096; the transposed SpMM twice, bit for bit; the fused
   attention's gradients against autograd through its plain version; the
   parts kernel and both forms of the high-degree forward (each forced,
   reruns bit for bit) at the hideg shapes and the masked max at the
   preset's, and all of them on a crafted graph with a degree-200 row (f32
   and bf16; the max bit for bit, NaN in giving NaN out), with the
   gradients of their Functions; the block attention at the JAX
   benchmark's shape (1,024 scenes of 8, dk 64, D 2048), at the block
   path's, at scenes of 1, 9, 16, 32 and 33 and on 2 scenes of 256 with
   padded nodes (f32 and bf16, with the gradients of its Function); the ELL
   SDDMM, softmax and SpMM at the ell path's first train batch and on the
   crafted graphs of degree 100 and 200, with their attention's gradients;
   the weights kernel at the bsp2 path's first train batch and on the
   crafted graph with a tight and a padded tile-pair plan, with the
   gradients of its Function and of the two-kernel attention; the dual
   transposed SpMM bit for bit against two single launches at the
   attention backward's shapes and on the hideg path's node view; both
   forms of the SDDMM and the three of the transposed SpMM (per-edge, tiled
   and staged, ``bsp.SPMM_T_FORMS``, each forced, and the wrappers through
   their rules) at the hideg node view, on the crafted graphs of degree 100
   and 200 (V 32 and 128: not multiples of the 64-node tile), on
   rectangular lists (100 rows over 200 and 50 sources) and at the swarm's
   training batch (dvalues at D 8192, dk at 64), f32, bf16 and mixed
   operands, single = dual and reruns bit for bit, the staged transposed
   SpMM bit for bit the per-edge one; both forms of the fused forward
   (``bsp.FUSED_FORMS``, each forced) on the swarm batch and the crafted
   graph, reruns bit for bit and the wrapper bit for bit against its
   rule's form; both forms of the SpMM (``bsp.SPMM_FORMS``, each forced)
   and the masked max on the ell path's train batch, the crafted graphs of
   degree 100 and 200 and a graph whose rows draw on the whole batch
   (f32 and bf16): the forms bit for bit against each other and on rerun,
   the wrappers against their rule's form, the max bit for bit against
   its plain version with NaN propagated; both forms of the attention
   weights (``bsp.WEIGHTS_FORMS``) and of the ELL softmax
   (``ell.SOFTMAX_FORMS``), each forced, at the bsp2 and ell paths'
   train batches and at ELL width 128 (dk 200): within tolerance of the
   plain versions, masked slots and empty rows 0, rows summing to 1,
   reruns bit for bit, the weights' rows form's logits bit for bit against
   the per-edge SDDMM, the wrappers against their rule's form;
4. serving: for each path, three eval batches through ``Predictor``,
   checked for range, for the kernel launches of each request, and against
   the same Predictor with the plain ops;
5. training: for each path, three steps of ``train.make_train_step`` on the
   first three train batches, checked for finite losses and grad norms, for
   the launches of every kernel per step, for no ``bsp.source_view`` call
   (every path's transposed SpMM takes the staged or the tiled form), and
   against the same three steps with the plain ops on the card;
6. timings (medians): each kernel beside its bound, its plain version and
   a library yardstick (and, for the weights and the ELL softmax, a floor:
   one PyTorch call with the kernel's chain of dependent round trips);
   both forms of the weights and of the ELL softmax in turns at the bsp2
   and ell paths' batches (``weights_form_ab``, ``softmax_form_ab``);
   both forms of the hideg forward in turns, with the
   parts kernel and ``xp_combine`` apart; the block kernel against the
   einsum route at the benchmark's shape, forward and value gradient; the
   dual transposed SpMM against two single launches, in turns; the dual
   SDDMM at the hideg node view; both forms of the dual SDDMM and the dual
   transposed SpMM in turns at the swarm, hideg and fully connected teams
   of 9 to 129 robots (the form rule's crossover; the transposed SpMM's
   three forms); the transposed SpMM's forms in turns at the attention
   path's dual launch and the bsp2 path's single ones, with the per-edge
   form's view inside and outside the clock and ``torch.sparse.mm`` beside
   them, and the staged form against the per-edge one on teams of 8 robots
   at V 1,024 to 8,192 (``spmm_t_form_ab``, the rule's STAGED_MAX_NODES;
   form_ab's fully connected teams give its STAGED_MAX_DEG);
   both forms of the fused
   forward in turns at the attention batch (``fused_form_ab``, f32 and
   bf16) and both forms of the single SDDMM at the ell path's logits
   (``sddmm_ab``); both forms of the SpMM in turns at the ell path's
   batch (f32 and bf16), the mean and bsp2 forwards and dq's shape (D 64)
   (``spmm_form_ab``, the rule's crossover); the Predictor's device-
   side batch latency and whole-request latency; the train step's device
   time with the kernels and with the plain ops, one whole step through
   ``train()`` (host clock, data included; numpy renderer on the attention
   path, native renderer and builder on the bsp2 path's config), peak
   memory, and profiler breakdowns of device time by kernel, from which
   every path but the plain ones is checked for the kernel bodies it must
   run (``PATH_BODIES``, ``TRAIN_BODIES``);
7. lifecycle (``phase_lifecycle``), on ``dynamic_swarm`` as above (the
   entry points pin deterministic cuDNN themselves): ``train.train`` for 4
   steps with ``eval_every`` and ``checkpoint_every`` 2 (evaluations of
   the preset's 64 eval scenes, 8 batches, at steps 2 and 4, the closing
   best record, ``config.json``, checkpoints of steps 2 and 4, exact
   launches); a new ``train()`` on a
   directory that holds only the step-2 checkpoint resumes at step 3, bit
   for bit equal to the straight run (losses, best eval, parameters);
   ``evaluate()`` of the restored checkpoint with the kernels against the
   plain ops; ``Predictor.from_checkpoint`` against a Predictor on the
   model in memory; then ``benchmark.main`` with ``--what fusion``,
   ``train_edge`` (the JAX benchmark's defaults: 8,192 nodes, D 2048, dk
   64), ``train`` and ``mfu`` (``--config dynamic_swarm``), each record
   printed, every ``pallas_*`` route launching a port kernel and no
   ``xla_*`` route launching one;
8. export (``phase_export``): for the attention, hideg, mean and max
   paths, the serving phase's Predictor (its first eval batch's graph)
   exported with ``serving.export_predictor`` (the sidecar's route
   "kernels" and the path's op of ``ops/library.py``), loaded on the card
   with ``load_exported`` and served 3 requests, each launching the path's
   kernel as the Predictor does and giving its outputs (bit for bit, else
   depth within 1e-6 m and seg on 99.9% of the pixels); the attention
   artifact also in a fresh process that imports the op library and none
   of the model code and sets no numerics flag; a profile of the
   artifact's requests with the path's kernel bodies (``PATH_BODIES``);
   the artifact's device-side forward and whole request against the
   Predictor's in turns (CUDA events);
9. data (``phase_data``), on ``dynamic_swarm`` with the native renderer
   and graph builder: 3 batches placed on the card by ``train``'s
   producer thread read back equal to the host batches; the worker
   loader's first unshuffled batches (4 processes) bit for bit the builtin
   pipeline's; ``train()`` for ``LOOP_STEPS`` steps with the builtin
   loader, the worker loader, augmentation and 8 scene folders written by
   ``export_scenes`` (npy), each with finite losses, its step times and
   the device's idle share over the loop;
9b. numerics (``phase_numerics``), on ``dynamic_swarm`` at full width as
   its CLI runs it (native host side, the attention path), with this
   process in the worst caller state for the phase (TF32 on for cuBLAS and
   cuDNN, cuDNN non-deterministic and benchmarking): ``train.train`` for 4
   steps here; the train CLI in a fresh process that sets no flag for 2
   steps with a checkpoint, then resumed to 4 in another: every step's
   terms and the final parameters bit for bit the straight run's; the
   straight run's checkpoint served here by ``Predictor`` and exported, and
   a third fresh process that sets nothing serving the same requests from
   the checkpoint and from the artifact, bit for bit this process's
   Predictor (else within the export phase's tolerances, said); then,
   outside the entry points, the Predictor's device-side batch and a train
   step timed in turns under (a) the pin (TF32 off, cuDNN deterministic),
   (b) TF32 off with cuDNN non-deterministic and (c) torch's defaults (cuDNN
   TF32), with (c)'s depth and first-step loss-term deviation from (a); and
   ``utils.debug.checked`` on the card: an attention step (forward and
   backward) bit for bit the unchecked one, a NaN written into the fused
   forward's value rows and one written by the backward's dual transposed
   SpMM (unseen by the dispatcher) each raising FloatingPointError, an
   out-of-range index into a plain gather and into the plain ops' model
   raising IndexError, the card usable after, which thread dispatched the
   backward's ops, the host syncs, and the checked step's time in turns
   with the unchecked one;
10. parallel (``phase_parallel``), on ``swarm_partitioned`` at full width
   (4 scenes x 64 robots in radius 4, 256 nodes over a graph axis of 8):
   8 ranks of this script (``--parallel-rank``), all on the one card and
   joined by gloo (``--dist_backend gloo``: rows staged through pinned host
   memory), each with its own node block, plan block and kernels (the
   transposed SpMM in its staged form, no source view in the train
   steps). Held: the
   world of 8 on a graph axis of 8 with real boundary rows; every call of
   rows 3, 4 and 5 (``bsp.spmm``, ``bsp.sddmm``, ``bsp.spmm_t``) that the
   partitioned fusion makes on a rank's shard within 1e-5 of its plain
   version on the same tensors; the partitioned fusion's outputs and
   gradients (attention with the boundary exchange overlapped and
   serialised and with the all_gather one, mean, max) within 1e-5 of the
   unpartitioned plain ops on the same card; ``train.train`` for 4 steps
   with launch counts reset just before it and read just after: rows 3, 4
   and 5 once per step on every rank and no other kernel; the first
   step's loss terms within 1e-5 relative of one process training the same
   config (its mesh shrunk to one rank), later steps printed beside them;
   every rank's parameters bit for bit equal; a resume from the step-2
   checkpoint over 8 ranks bit for bit the straight run; ``evaluate`` with
   the context within 1e-4 of one process's evaluation of the same
   weights; a 2 x 4 mesh's first step as the 1 x 8 run's; rank 0's
   profile showing the three kernel bodies. Printed: the step time (CUDA
   events on rank 0's stream, median) in turns with the value exchange
   overlapped and serialised, beside one process's step; the host time in
   the exchange and in the world sums; rank 0's profile of the transport
   (host time of the gloo operations, device time of the copies); the
   rows exchanged per shard; rank 0's device idle share. Eight ranks
   sharing one card through host memory are not how a multi-card
   deployment runs: these numbers are findings, not claims;
11. model axis (``phase_model_axis``), on ``dynamic_swarm`` at full width
   (16 eval scenes): ranks of this script (``--model-axis-rank``) sharing
   the card through gloo, on a 1 x 1 x 2 mesh with channel tensor
   parallelism (2 ranks; each rank's single-device attention on its 64
   channels of the values, D 4096) and on a 2 x 1 x 4 mesh with image-row
   sharding (8 ranks; each data replica's one-shard partitioned fusion on
   a rank's 2 bottleneck rows, D 2048). Held for each: every kernel call
   on every rank's shards within 1e-5 of its plain version, at that width
   and in its form (the fused forward's and the SpMM's vector forms);
   ``train.train`` for 4 steps with launch counts reset just before it and
   read just after (rows 1, 3, 4/7 and 6 once a step under tensor
   parallelism, 3, 4 and 5 under spatial sharding, on every rank, no
   other kernel; no source view, the transposed SpMM staged); the
   replicated parameters bit for bit equal across
   ranks; the resume from step 2 bit for bit; two updates from the seeded
   state (lr 0, then above 0) against one process's (the first step's
   terms within 1e-5 relative; each leaf of its gradients and of the
   parameters after the second update, gathered whole, within 1e-5 beyond
   the most that one process's own values move when each pixel is scaled
   by 1 +- 1e-7, over 8 draws); ``train.train``'s first step within 1e-5
   relative of one process's run and its steps 2-4 within rtol 2e-4, atol
   2e-5; ``evaluate`` within 1e-4 of one process evaluating the ranks'
   final parameters. Printed: the later steps, the step over the ranks
   (CUDA events and host clock) beside one process's, the host time in
   the channel gathers, halo rows, group sums and batch sums, and over the
   8 ranks the ``benchmark.bench_scaling`` and ``bench_overlap`` records.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from mrp_gnn_tpu_torch import benchmark, train
from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data import graph_native, native
from mrp_gnn_tpu_torch.data.disk import export_scenes
from mrp_gnn_tpu_torch.data.grain_pipeline import make_grain_iterator
from mrp_gnn_tpu_torch.data.pipeline import (TransformIterator, make_dataset,
                                             make_train_iterator)
from mrp_gnn_tpu_torch.graph import batch_fully_connected, build_graph_batch
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
from mrp_gnn_tpu_torch.ops import _build, bsp, edge, ell
from mrp_gnn_tpu_torch.ops import reference as R
from mrp_gnn_tpu_torch.evaluate import evaluate
from mrp_gnn_tpu_torch.serving import (Predictor, export_predictor,
                                       load_exported)
from mrp_gnn_tpu_torch.utils.debug import checked
from mrp_gnn_tpu_torch.utils.platform import reference_numerics

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
TOL_F32 = 2e-5               # kernel vs plain, f32: sums in another order
TOL_BF16_REL = 2.0 ** -7     # bf16 outputs: one bf16 ulp, relative
TOL_SERVE_DEPTH_M = 1e-3     # kernel vs plain ops through the whole net, metres
TOL_TRAIN_REL = 1e-5         # train loss terms and grad norms, kernels vs plain
# evaluate() with the kernels against the plain ops: rmse and abs_rel
# relative; the deltas and mIoU absolute (100 flipped pixels of 1M)
TOL_EVAL_REL, TOL_EVAL_ABS = 1e-4, 1e-4
TOL_CKPT_SERVE_M = 1e-6      # Predictor.from_checkpoint vs the model in memory
# Function gradients vs autograd through the plain version, relative to the
# largest gradient: f32 sums in another order; with bf16 values the plain
# autograd rounds each slot's value gradient to bf16 before summing them.
TOL_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
PORT_KERNEL_BODIES = ("fused_attention_kernel", "fused_vec_kernel",
                      "sddmm_rows_kernel", "sddmm_wide_kernel", "spmm_kernel",
                      "spmm_t_kernel", "spmm_t2_kernel", "fused_parts_kernel",
                      "weights_kernel", "ell_max_kernel", "ell_softmax_kernel",
                      "block_attention_kernel", "tile_flags_kernel",
                      "sddmm_tiled_kernel", "sddmm_finish_kernel",
                      "densify_kernel", "spmm_t_tiled_kernel",
                      "spmm_t_staged_kernel",
                      "fused_parts_weights_kernel", "fused_parts_tiled_kernel",
                      "block_attention_f32_kernel",
                      "block_attention_bf16_kernel", "spmm_vec_kernel",
                      "weights_rows_kernel", "ell_softmax_register_kernel")
HIDEG_ROBOTS, HIDEG_SCENES, HIDEG_SLOTS = 193, 2, 512
# The edge block of the JAX package's benchmark (bench.py: V 8192 in
# fully connected 8-robot scenes, D 2048, dk 64).
BENCH_SCENES, BENCH_ROBOTS, BENCH_D, BENCH_DK = 1024, 8, 2048, 64
LOOP_STEPS = 12  # steps of each train() loop timing
# The export phase: each path's forward op (ops/library.py), and the
# tolerance of the loaded program against the Predictor where it is not bit
# for bit (depth in metres, seg the share of equal pixels).
EXPORT_OPS = {"attention": "fused_attention", "hideg": "expanded_forward",
              "mean": "spmm", "max": "masked_max"}
TOL_EXPORT_DEPTH_M, TOL_EXPORT_SEG = 1e-6, 0.999
DATA_WORKERS = 4   # the data phase's worker loader
DISK_SCENES = 8    # scene folders the data phase writes and trains from
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")


def cuda_ms(fn, reps: int = 15, inner: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events (milliseconds)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profiled(fn, n: int, tries: int = 10):
    """(device activity by kernel, host-clock window in microseconds) of
    ``n`` calls of ``fn`` under the profiler (CUPTI).

    Each trace takes ``n`` warm-up calls before the ``n`` it keeps: on an
    H100, traces without that warm-up lost the device activity of their
    first calls (a kernel recorded 4 times in 30 calls, a first copy missing
    in every breakdown, once no activity at all). A trace must see each
    kernel and copy a whole number of times per call; one that does not is
    repeated, at most ``tries`` times in all, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()  # the warm-up ends, the kept calls start
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        kern = [e for e in prof.key_averages()  # less the step's own span
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]
        if kern and all(e.count % n == 0 for e in kern):
            return kern, wall_us
        log(f"[timing] profiler trace {attempt + 1} missed device activity: "
            f"{[(e.key[:40], e.count) for e in kern]} in {n} calls")
        time.sleep(1.0)  # let the tracer settle before the next trace
    raise AssertionError(f"the profiler missed device activity in {tries} "
                         "traces")


def device_ms(fn, n: int = 30) -> float:
    """Device time per call of ``fn``: the device time of every kernel and
    copy it launches, from the profiler, over ``n`` calls (:func:`profiled`).
    Unlike back-to-back CUDA events it leaves out the gaps in which the
    device waits for the host, which dominate a call whose kernel takes
    microseconds."""
    kern, _ = profiled(fn, n)
    return sum(e.self_device_time_total for e in kern) / n / 1e3


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return {"gpu": name, "nvidia_smi": smi.splitlines()[0]}


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    _build.build(kernels)
    for name in kernels:
        _build.load(name)
        log(f"[build] {name}: nvcc output:\n{_build.build_logs.get(name, '(cached)').strip()}")
    log(f"[build] {len(kernels)} kernel(s) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for name, mod in (("renderer", native), ("graph builder", graph_native)):
        if not mod.is_available():
            raise RuntimeError(f"the native {name} did not build or failed "
                               "its smoke call")
    log(f"[build] native renderer and graph builder built (g++) and "
        f"smoke-checked in {time.perf_counter() - t0:.2f} s")


def swarm_config(fusion: str = "attention"):
    cfg = get_config("dynamic_swarm")
    return cfg.replace(data=dataclasses.replace(cfg.data, renderer="numpy",
                                                graph_builder="numpy"),
                       model=dataclasses.replace(cfg.model, fusion=fusion))


def native_swarm_config():
    """dynamic_swarm on the native C++ renderer and graph builder, as the
    JAX package runs its default "auto"; "native" raises where they do not
    build, so this path never falls back to numpy."""
    cfg = get_config("dynamic_swarm")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, renderer="native", graph_builder="native"))


def hideg_config():
    """The dense swarm: 2 fully connected scenes of 193 robots, padded to
    512 node slots, so the batch graph has no scene stride, an ELL width of
    192 and a row-expanded plan (2 rows of 96, tile 128)."""
    cfg = swarm_config()
    return cfg.replace(data=dataclasses.replace(
        cfg.data, num_robots=HIDEG_ROBOTS, scenes_per_batch=HIDEG_SCENES,
        connectivity="full", comm_radius=0, mobility=0.0,
        max_nodes=HIDEG_SLOTS))


def hideg_graph(dev):
    cfg = hideg_config()
    g = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))["graph"]
    edges = HIDEG_SCENES * HIDEG_ROBOTS * (HIDEG_ROBOTS - 1)
    if (g.scene_stride or bsp.supports(g) or not bsp.supports_expanded(g)
            or g.max_nodes != HIDEG_SLOTS or int(g.ell_mask.sum()) != edges):
        raise AssertionError("the dense-swarm batch graph is not the "
                             "row-expanded one")
    return g.to(dev)


def attention_inputs(V: int, dk: int, D: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(V, dk)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(size=(V, dk)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dev)
    return q, k, v


def crafted_graph(max_bsp_pairs: int | None = None):
    """Empty rows, duplicate edges, a wide row (deg 100) and padded nodes;
    ``max_bsp_pairs`` pads the tile-pair plan with inert pairs."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5],    # src (1->0 twice, 5->4 x3)
                  [0, 0, 0, 1, 2, 4, 4, 4]])   # dst; node 3 has no in-edge
    wide_src = np.arange(100) % 12             # node 0 of scene 1: deg 100
    b = np.stack([wide_src, np.zeros(100, np.int64)])
    return build_graph_batch([a, b], [6, 12], max_nodes=32, max_edges=128,
                             max_bsp_pairs=max_bsp_pairs)


def check_kernel_vs_plain(name, got, want, bf16: bool, scale: float = 1.0,
                          of_largest: bool = False) -> float:
    """f32: max abs err <= TOL_F32 * scale, where ``scale`` is the size of
    the summed values (1 for weighted sums of O(1) values; sqrt(D) for a
    D-long dot of O(1) products); bf16 outputs: one bf16 ulp of each
    element, or with ``of_largest`` of the largest element."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"plain {want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if bf16 and of_largest:
        limit = TOL_BF16_REL * float(want.float().abs().max())
        ok = err <= limit
        tol = f"atol {limit:.3g} (one bf16 ulp of the largest element)"
    elif bf16:
        ok = torch.allclose(got.float(), want.float(), rtol=TOL_BF16_REL,
                            atol=1e-6)
        tol = f"rtol {TOL_BF16_REL} (one bf16 ulp)"
    else:
        ok = err <= TOL_F32 * scale
        tol = f"atol {TOL_F32 * scale:.3g}"
    log(f"[kernel] {name}: max abs err {err:.3e} against {tol}")
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels(dev) -> dict:
    cfg = swarm_config()
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    g = batch["graph"].to(dev)
    V, deg = g.ell_src.shape
    c = cfg.model.encoder_channels[-1]
    hw = cfg.model.image_size[0] // cfg.model.bottleneck_stride
    D = hw * hw * c
    dk = cfg.model.attention_dim
    log(f"[kernel] dynamic_swarm batch 0: V {V}, deg {deg}, valid edges "
        f"{int(g.ell_mask.sum())}, dk {dk}, D {D}, bsp_tile {g.bsp_tile}")
    q, k, v = attention_inputs(V, dk, D, 0, dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        got = bsp.bsp_attention_fused(q, k, vv, g)
        want = bsp.bsp_attention_fused_reference(q, k, vv, g)
        torch.cuda.synchronize()
        errs[str(dt)] = check_kernel_vs_plain(
            f"swarm {dt}", got, want, dt == torch.bfloat16)
    cg = crafted_graph().to(dev)
    empty = ~cg.ell_mask.any(dim=1)
    for D_c in (1030, 4096):
        qc, kc, vc = attention_inputs(cg.max_nodes, dk, D_c, 1, dev)
        for dt in (torch.float32, torch.bfloat16):
            vv = vc.to(dt)
            got = bsp.bsp_attention_fused(qc, kc, vv, cg)
            want = bsp.bsp_attention_fused_reference(qc, kc, vv, cg)
            torch.cuda.synchronize()
            check_kernel_vs_plain(f"crafted D {D_c} {dt}", got, want,
                                  dt == torch.bfloat16)
            if not bool((got[empty] == 0).all()):
                raise AssertionError("rows without a valid slot must be 0")
    q_s, kf = bsp._scaled(q, k)
    check_fused_forms(q_s, kf, v, g, "swarm")
    for D_c in (1030, 4096):
        qc, kc, vc = attention_inputs(cg.max_nodes, dk, D_c, 1, dev)
        check_fused_forms(*bsp._scaled(qc, kc), vc, cg, f"crafted D {D_c}")
    return {"graph": g, "q": q, "k": k, "v": v, "errs": errs}


def fused_form(form: str, *args):
    """bsp_fused_attention.cu in the form given, whatever bsp.fused_form
    says."""
    return bsp.run_fused_attention(_Uncounted, *args, form=form)


def check_fused_forms(q_s, k, v, g, tag: str) -> None:
    """Both forms of the fused forward, each forced, against the plain
    version (f32 and bf16 values), a second launch bit for bit, rows without
    a valid slot exactly 0; the wrapper's launch bit for bit against its
    rule's form; at vec 1 the "vec" form raises."""
    src, mask = g.ell_src, g.ell_mask
    empty = ~mask.any(dim=1)
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        want = bsp.fused_attention_reference(q_s, k, vv, src, mask)
        vec = bsp._fused_vec(vv, vv)
        rule = bsp.FUSED_FORMS[bsp.fused_form(vec, dt == torch.bfloat16)]
        for form in bsp.FUSED_FORMS:
            if vec == 1 and form != "row":
                try:
                    fused_form(form, q_s, k, vv, src, mask)
                except ValueError:
                    continue
                raise AssertionError(f"the {form} form took 4-byte rows")
            got = fused_form(form, q_s, k, vv, src, mask)
            again = fused_form(form, q_s, k, vv, src, mask)
            torch.cuda.synchronize()
            check_kernel_vs_plain(f"bsp_fused_attention {form}, {tag} {dt}",
                                  got, want, dt == torch.bfloat16)
            if not (torch.equal(got, again) and bool((got[empty] == 0).all())):
                raise AssertionError(f"bsp_fused_attention {form}, {tag} {dt}: "
                                     "two launches differ, or an empty row "
                                     "is not 0")
            if form == rule and not torch.equal(
                    got, bsp.fused_attention(q_s, k, vv, src, mask)):
                raise AssertionError("the wrapper does not give its rule's "
                                     "form's bits")
    log(f"[kernel] bsp_fused_attention, {tag}: both forms agree with the "
        "plain version and rerun bit for bit")


def backward_inputs(g, dk: int, D: int, seed: int, dev) -> dict:
    """The operands of the fused attention's backward on graph ``g``:
    q_s, k, values, an output cotangent, and the alpha and dlog the plain
    version derives from them."""
    q, k, v = attention_inputs(g.max_nodes, dk, D, seed, dev)
    (ct,) = attention_inputs(g.max_nodes, 1, D, seed + 1, dev)[2:]
    q_s, kf = bsp._scaled(q, k)
    alpha = bsp.masked_softmax(
        bsp.sddmm_reference(q_s, kf, g.ell_src, g.ell_mask), g.ell_mask)
    dalpha = bsp.sddmm_reference(ct, v, g.ell_src, g.ell_mask)
    dlog = alpha * (dalpha - (alpha * dalpha).sum(-1, keepdim=True))
    dlog = torch.where(g.ell_mask, dlog, 0.0)
    return {"graph": g, "q": q, "k": k, "q_s": q_s, "kf": kf, "v": v,
            "ct": ct, "alpha": alpha, "dlog": dlog}


def check_backward_kernels(x: dict, tag: str, errs: dict | None = None) -> None:
    """Each backward kernel against its plain version on the operands of
    ``backward_inputs``, with f32 and bf16 values."""
    g = x["graph"]
    src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
    D = x["v"].shape[1]
    for vdt, gdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        v, ct = x["v"].to(vdt), x["ct"].to(gdt)
        name = f"{tag} values {vdt} cotangent {gdt}"
        lo, da = bsp.sddmm(x["q_s"], x["kf"], src, mask, ct, v)
        want_lo = bsp.sddmm_reference(x["q_s"], x["kf"], src, mask)
        want_da = bsp.sddmm_reference(ct, v, src, mask)
        e1 = check_kernel_vs_plain(f"bsp_sddmm logits, {name}", lo, want_lo, False)
        e2 = check_kernel_vs_plain(f"bsp_sddmm dalpha, {name}", da, want_da,
                                   False, scale=D ** 0.5)
        dv = bsp.spmm_t(x["alpha"], ct, src, mask, V, vdt)
        again = bsp.spmm_t(x["alpha"], ct, src, mask, V, vdt)
        torch.cuda.synchronize()
        if not torch.equal(dv, again):
            raise AssertionError(f"bsp_spmm_t, {name}: two runs differ")
        e3 = check_kernel_vs_plain(
            f"bsp_spmm_t dvalues (bit-identical rerun), {name}", dv,
            bsp.spmm_t_reference(x["alpha"], ct, src, mask, V, vdt),
            vdt == torch.bfloat16)
        sv = bsp.spmm(x["alpha"], v, src, mask)
        e4 = check_kernel_vs_plain(f"bsp_spmm alpha x values, {name}", sv,
                                   bsp.spmm_reference(x["alpha"], v, src, mask),
                                   vdt == torch.bfloat16)
        if errs is not None and vdt == gdt == torch.float32:
            errs.update(bsp_sddmm=max(e1, e2), bsp_spmm_t=e3, bsp_spmm=e4)
    dq = bsp.spmm(x["dlog"], x["kf"], src, mask)
    err = check_kernel_vs_plain(f"bsp_spmm dq, {tag}", dq,
                                bsp.spmm_reference(x["dlog"], x["kf"], src, mask),
                                False)
    dk = bsp.spmm_t(x["dlog"], x["q_s"], src, mask, V)
    err_t = check_kernel_vs_plain(
        f"bsp_spmm_t dk, {tag}", dk,
        bsp.spmm_t_reference(x["dlog"], x["q_s"], src, mask, V), False)
    if errs is not None:
        errs["bsp_spmm"] = max(errs["bsp_spmm"], err)
        errs["bsp_spmm_t"] = max(errs["bsp_spmm_t"], err_t)
    named = torch.zeros(V, dtype=torch.bool, device=src.device)
    named[src[mask].long()] = True
    if not (bool((dk[~named] == 0).all()) and bool((dq[~mask.any(1)] == 0).all())):
        raise AssertionError(f"{tag}: rows without a valid slot must be 0")


def _plain_f32_values(q, k, v, g):
    """The plain attention on values upcast to f32: its value gradient is
    summed in f32 and rounded to v's dtype once."""
    return bsp.bsp_attention_fused_reference(q, k, v.float(), g)


def check_function_grads(x: dict, tag: str, fn=bsp.bsp_attention_fused,
                         name: str = "FusedAttention",
                         plain=bsp.bsp_attention_fused_reference) -> None:
    """The gradients of ``fn`` (kernels) against autograd through ``plain``,
    on the card."""
    g = x["graph"]
    for dt in (torch.float32, torch.bfloat16):
        grads = []
        for f in (fn, plain):
            q = x["q"].detach().clone().requires_grad_()
            k = x["k"].detach().clone().requires_grad_()
            v = x["v"].detach().to(dt).requires_grad_()
            (f(q, k, v, g).float() * x["ct"]).sum().backward()
            grads.append((q.grad, k.grad, v.grad))
        torch.cuda.synchronize()
        for gname, got, want in zip(("dq", "dk", "dvalues"), *grads):
            rel = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max().clamp(min=1e-30))
            log(f"[kernel] {name} {gname}, {tag}, values {dt}: max err "
                f"{rel:.3e} of the largest gradient (tol {TOL_GRAD_REL[dt]:.3g})")
            if got.dtype != want.dtype or not rel <= TOL_GRAD_REL[dt]:
                raise AssertionError(f"{name} {gname}: kernel backward "
                                     "disagrees with autograd of the plain version")


def phase_train_kernels(dev) -> dict:
    cfg = swarm_config()
    batch = next(iter(make_dataset(cfg.data, "train")))
    g = batch["graph"].to(dev)
    m = cfg.model
    hw = m.image_size[0] // m.bottleneck_stride
    D = hw * hw * m.encoder_channels[-1]
    log(f"[kernel] dynamic_swarm train batch 0: V {g.max_nodes}, deg "
        f"{g.ell_src.shape[1]}, valid edges {int(g.ell_mask.sum())}, dk "
        f"{m.attention_dim}, D {D}")
    x = backward_inputs(g, m.attention_dim, D, 3, dev)
    errs = {}
    check_backward_kernels(x, "swarm train", errs)
    check_function_grads(x, "swarm train")
    cg = crafted_graph().to(dev)
    for D_c in (1030, 4096):
        xc = backward_inputs(cg, m.attention_dim, D_c, 5, dev)
        check_backward_kernels(xc, f"crafted D {D_c}")
        check_function_grads(xc, f"crafted D {D_c}")
    return {"inputs": x, "errs": errs}


def crafted_wide_graph():
    """Empty rows, duplicate edges, a degree-200 row and padded nodes: ELL
    width 200, so a row-expanded plan of 2 rows x 104."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5], [0, 0, 0, 1, 2, 4, 4, 4]])
    wide = np.stack([np.arange(200) % 12, np.zeros(200, np.int64)])
    return build_graph_batch([a, wide], [6, 12], max_nodes=128, max_edges=256)


class _Uncounted:
    """The launch counter of the forced-form calls below: launches that
    compare a form with its plain version are not the main path's."""
    launches = 0


FORMS = ((False, "per-edge"), (True, "tiled"))


@contextlib.contextmanager
def counted_views():
    """While open, counts the calls of bsp.source_view (the per-edge
    transposed SpMM's device sort, which the staged and tiled forms do not
    build); yields a one-element list of the count."""
    real = bsp.source_view
    calls = [0]

    def counting(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    bsp.source_view = counting
    try:
        yield calls
    finally:
        bsp.source_view = real


def forward_form(tiled: bool, *args):
    """bsp_fused_parts.cu's high-degree forward in the form given, whatever
    bsp.tiled_form says."""
    return bsp.run_expanded_forward(_Uncounted, *args, tiled=tiled)


def check_parts(x: dict, tag: str, errs: dict | None = None) -> None:
    """The parts kernel against its plain version on the expanded view of
    ``x["graph"]`` (f32 and bf16 values); both forms of the high-degree
    forward, each forced, against the plain attention, each twice bit for
    bit, nodes without a valid slot exactly 0; the whole expanded attention
    (the rule's form) against the plain attention, and its Function's
    gradients."""
    g = x["graph"]
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q_s, kf = bsp._scaled(x["q"], x["k"])
    q_x = q_s.repeat_interleave(xp.rows, dim=0)
    empty = ~mask_x.any(dim=1)
    no_edge = ~g.ell_mask.any(dim=1)
    V = g.max_nodes
    rule = bsp.tiled_form(V, V, xp.rows * xp.width)
    log(f"[kernel] {tag}: node view [{V}, {xp.rows * xp.width}]; the rule "
        f"takes the {'tiled' if rule else 'per-edge'} form of the forward")
    for dt in (torch.float32, torch.bfloat16):
        v = x["v"].to(dt)
        acc, m, l = bsp.fused_attention_parts(q_x, kf, v, src_x, mask_x)
        want = bsp.fused_attention_parts_reference(q_x, kf, v, src_x, mask_x)
        torch.cuda.synchronize()
        name = f"{tag} values {dt}"
        # acc and l sum up to W weights <= 1: f32 error grows with sqrt(W)
        check_kernel_vs_plain(f"bsp_fused_parts acc, {name}", acc, want[0],
                              False, scale=xp.width ** 0.5)
        check_kernel_vs_plain(f"bsp_fused_parts m, {name}", m, want[1], False)
        check_kernel_vs_plain(f"bsp_fused_parts l, {name}", l, want[2], False,
                              scale=xp.width ** 0.5)
        if not (bool((m[empty] == bsp._NEG).all()) and bool((l[empty] == 0).all())
                and bool((acc[empty] == 0).all())):
            raise AssertionError("expanded rows without a valid slot must "
                                 "give m = -1e30, l = 0 and acc = 0")
        plain = bsp.bsp_attention_fused_reference(x["q"], x["k"], v, g)
        for tiled, form in FORMS:
            args = (q_s, kf, v, src_x, mask_x, xp.rows)
            got, again = forward_form(tiled, *args), forward_form(tiled, *args)
            torch.cuda.synchronize()
            err = check_kernel_vs_plain(
                f"bsp_fused_parts forward, {form} (rerun bit for bit), {name}",
                got, plain, dt == torch.bfloat16)
            if not torch.equal(got, again) or not bool((got[no_edge] == 0).all()):
                raise AssertionError(f"bsp_fused_parts forward, {form}, {name}: "
                                     "two runs differ, or a node without a "
                                     "valid slot is not 0")
            if errs is not None and dt == torch.float32 and tiled == rule:
                errs["bsp_fused_parts"] = err
        out = bsp.expanded_attention_fused(x["q"], x["k"], v, g)
        check_kernel_vs_plain(f"expanded_attention_fused, {name}", out, plain,
                              dt == torch.bfloat16)
    # With bf16 values, autograd through the plain version would round each
    # slot's value gradient to bf16 and sum up to 192 of them in bf16; the
    # kernels sum in f32 and round once, so the plain side runs on f32 values.
    check_function_grads(x, tag, bsp.expanded_attention_fused,
                         "ExpandedFusedAttention", _plain_f32_values)


def check_max(g, v: torch.Tensor, tag: str, errs: dict | None = None) -> None:
    """The masked max against its plain version bit for bit (f32 and bf16),
    NaN in giving NaN out, and the Function's gradient with ties against
    autograd through the plain version."""
    empty = ~g.ell_mask.any(dim=1)
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        got = ell.masked_max(vv, g.ell_src, g.ell_mask)
        want = ell.masked_max_reference(vv, g.ell_src, g.ell_mask)
        torch.cuda.synchronize()
        err = check_kernel_vs_plain(f"ell_max, {tag} values {dt}", got, want,
                                    dt == torch.bfloat16)
        if not torch.equal(got, want) or not bool((got[empty] == 0).all()):
            raise AssertionError(f"ell_max, {tag}: not bit-equal to the plain "
                                 "version, or an empty row is not 0")
        if errs is not None and dt == torch.float32:
            errs["ell_max"] = err
    r = int(g.ell_mask.any(dim=1).nonzero()[0])
    j = int(g.ell_mask[r].nonzero()[0])
    poisoned = v.clone()
    poisoned[g.ell_src[r, j].long(), 5] = float("nan")
    if not bool(torch.isnan(ell.masked_max(poisoned, g.ell_src, g.ell_mask)[r, 5])):
        raise AssertionError("ell_max must propagate NaN as jnp.maximum does")
    ct = torch.randn(v.shape, generator=torch.Generator().manual_seed(7)).to(v.device)
    ties = (v * 2).round()  # many equal maxima among a row's valid slots
    grads = []
    for fn in (ell.ell_max, ell.masked_max_reference):
        leaf = ties.clone().requires_grad_()
        (fn(leaf, g.ell_src, g.ell_mask) * ct).sum().backward()
        grads.append(leaf.grad)
    torch.cuda.synchronize()
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    log(f"[kernel] EllMax dvalues with ties, {tag}: max err {rel:.3e} of the "
        f"largest gradient (tol {TOL_GRAD_REL[torch.float32]:.3g})")
    if not rel <= TOL_GRAD_REL[torch.float32]:
        raise AssertionError("EllMax's gradient disagrees with autograd of "
                             "the plain version")


def phase_new_kernels(dev) -> dict:
    """The parts kernel at the hideg path's shapes and the masked max at the
    max path's, then both on the crafted wide graph."""
    m = swarm_config().model
    hw = m.image_size[0] // m.bottleneck_stride
    D, dk = hw * hw * m.encoder_channels[-1], m.attention_dim
    g = hideg_graph(dev)
    log(f"[kernel] dense swarm: V {g.max_nodes}, deg {g.ell_src.shape[1]}, "
        f"expanded {g.bsp_expanded.rows} x {g.bsp_expanded.width}, valid "
        f"edges {int(g.ell_mask.sum())}, dk {dk}, D {D}")
    x = backward_inputs(g, dk, D, 11, dev)
    errs = {}
    check_parts(x, "dense swarm", errs)
    gm = next(iter(make_dataset(swarm_config("max").data, "eval",
                                shuffle=False)))["graph"].to(dev)
    (v,) = attention_inputs(gm.max_nodes, 1, D, 13, dev)[2:]
    check_max(gm, v, "dynamic_swarm", errs)
    cg = crafted_wide_graph().to(dev)
    for D_c in (1030, 4096):
        xc = backward_inputs(cg, dk, D_c, 15, dev)
        check_parts(xc, f"crafted wide D {D_c}")
        check_max(cg, xc["v"], f"crafted wide D {D_c}")
    return {"inputs": x, "max_graph": gm, "max_values": v, "errs": errs}


def kernel_swap(swap):
    """An ``edge_fusion_fn``: ``default_edge_fusion`` over ``swap(ops)`` on
    the kernel backend and over the ops as they are otherwise, as bench.py
    swaps the block kernel in for ``ops_impl`` "pallas" only; so a path's
    plain-ops runs stay plain."""
    def edge_fusion(ops, aggregation, q, k, values, graph):
        if ops.impl == "pallas":
            ops = swap(ops)
        return default_edge_fusion(ops, aggregation, q, k, values, graph)
    return edge_fusion


def block_config():
    """multitask_batched at full width: 8 fully connected scenes of 5 robots
    (a block-diagonal batch of 40 node slots), D 8192, 6 classes."""
    cfg = get_config("multitask_batched")
    return cfg.replace(data=dataclasses.replace(cfg.data, renderer="numpy"))


def check_block_batches(cfg) -> None:
    """The block path's eval and train batches are block-diagonal, of one
    scene stride: the number of robots."""
    n = cfg.data.num_robots
    for split in ("eval", "train"):
        g = next(iter(make_dataset(cfg.data, split, shuffle=False)))["graph"]
        if g.scene_stride != n or g.max_nodes != n * cfg.data.scenes_per_batch:
            raise AssertionError(f"{split} batch: scene_stride "
                                 f"{g.scene_stride}, {g.max_nodes} slots")
    log(f"[kernel] {cfg.name} batches: scene_stride {n}, V {g.max_nodes}")


def check_block(g, D: int, dk: int, seed: int, dev, tag: str,
                errs: dict | None = None) -> dict:
    """The block attention against its plain version on graph ``g`` (f32
    and bf16 values; padded nodes give exactly 0), and its Function's
    gradients. With bf16 values the kernel rounds its weights to bf16, and
    a weight that the two round apart moves an output by one bf16 ulp of
    that term: bf16 outputs are held to one bf16 ulp of the largest."""
    q, k, v = attention_inputs(g.max_nodes, dk, D, seed, dev)
    (ct,) = attention_inputs(g.max_nodes, 1, D, seed + 1, dev)[2:]
    pad = ~g.node_mask
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        got = edge.block_fused_attention(q, k, vv, g)
        want = edge.block_fused_attention_reference(q, k, vv, g)
        torch.cuda.synchronize()
        err = check_kernel_vs_plain(f"block_attention, {tag} values {dt}", got,
                                    want, dt == torch.bfloat16, of_largest=True)
        if not bool((got[pad] == 0).all()):
            raise AssertionError("padded nodes must give exactly 0")
        if errs is not None and dt == torch.float32:
            errs["block_attention"] = err
    x = {"graph": g, "q": q, "k": k, "v": v, "ct": ct}
    check_function_grads(x, tag, edge.block_fused_attention, "BlockAttention",
                         edge.block_fused_attention_reference)
    return x


def phase_block_kernels(dev) -> dict:
    """The block attention at the benchmark's shape, at the block path's
    (8 scenes of 5, D 8192), at scenes of 1, 9, 16, 32 and 33 nodes (each
    bucket of the small-scene kernel and the general one past 32; padded
    scenes) and on 2 scenes of 256 nodes with padded nodes (D 1030: the
    scalar path; several passes of 8 destinations); a scene past 256 nodes
    raises."""
    errs = {}
    g = batch_fully_connected(BENCH_SCENES, BENCH_ROBOTS).to(dev)
    log(f"[kernel] benchmark edge block: V {g.max_nodes}, scene "
        f"{g.scene_stride}, dk {BENCH_DK}, D {BENCH_D}")
    x = check_block(g, BENCH_D, BENCH_DK, 21, dev, "benchmark", errs)
    cfg = block_config()
    m = cfg.model
    hw = m.image_size[0] // m.bottleneck_stride
    gb = batch_fully_connected(cfg.data.scenes_per_batch,
                               cfg.data.num_robots).to(dev)
    check_block(gb, hw * hw * m.encoder_channels[-1], m.attention_dim, 23,
                dev, cfg.name)
    for n in (1, 9, 16, 32, 33):
        team = batch_fully_connected(3, n, max_nodes=4 * n).to(dev)
        check_block(team, 1024, 64, 24, dev, f"3 scenes of {n} in {4 * n} slots")
    big = batch_fully_connected(2, 256, max_nodes=768).to(dev)
    check_block(big, 1030, 64, 25, dev, "2 scenes of 256 in 768 slots")
    q = torch.zeros(514, 8, device=dev)
    try:
        edge.block_attention(q, q, q, torch.ones(514, dtype=torch.bool,
                                                 device=dev),
                             torch.ones(257, 257, device=dev))
    except ValueError as e:
        log(f"[kernel] block_attention, a scene of 257 nodes: raises ({e})")
    else:
        raise AssertionError("a scene past 256 nodes must raise")
    return {"inputs": x, "errs": errs}


def check_ell(g, D: int, dk: int, seed: int, dev, tag: str,
              errs: dict | None = None) -> dict:
    """The ELL SDDMM, softmax and SpMM against their plain versions on
    graph ``g`` (f32 and bf16 values for the SpMM), and the gradients of
    their attention against autograd through its plain version."""
    x = backward_inputs(g, dk, D, seed, dev)
    src, mask = g.ell_src, g.ell_mask
    empty = ~mask.any(dim=1)
    want_lo = bsp.sddmm_reference(x["q_s"], x["kf"], src, mask)
    e1 = check_kernel_vs_plain(f"ell_sddmm, {tag}",
                               ell.sddmm(x["q_s"], x["kf"], src, mask),
                               want_lo, False)
    alpha = ell.softmax(want_lo, mask)
    e2 = check_kernel_vs_plain(f"ell_softmax, {tag}", alpha,
                               bsp.masked_softmax(want_lo, mask), False)
    if not bool((alpha[empty] == 0).all()):
        raise AssertionError("ell_softmax: rows without a valid slot must be 0")
    for dt in (torch.float32, torch.bfloat16):
        v = x["v"].to(dt)
        out = ell.spmm(x["alpha"], v, src, mask)
        e3 = check_kernel_vs_plain(f"ell_spmm, {tag} values {dt}", out,
                                   bsp.spmm_reference(x["alpha"], v, src, mask),
                                   dt == torch.bfloat16)
        if not bool((out[empty] == 0).all()):
            raise AssertionError("ell_spmm: rows without a valid slot must be 0")
        if errs is not None and dt == torch.float32:
            errs.update(ell_sddmm=e1, ell_softmax=e2, ell_spmm=e3)
    check_function_grads(x, tag, ell.ell_attention, "EllAttention",
                         ell.ell_attention_reference)
    return x


def phase_ell_kernels(dev) -> dict:
    """The ELL kernels at the ell path's first train batch, then on the
    crafted graphs of degree 100 and 200 (two passes of 128 slots)."""
    cfg = swarm_config()
    m = cfg.model
    hw = m.image_size[0] // m.bottleneck_stride
    D, dk = hw * hw * m.encoder_channels[-1], m.attention_dim
    g = next(iter(make_dataset(cfg.data, "train")))["graph"].to(dev)
    errs = {}
    x = check_ell(g, D, dk, 31, dev, "swarm train", errs)
    for name, cg in (("crafted", crafted_graph()),
                     ("crafted wide", crafted_wide_graph())):
        for D_c in (1030, 4096):
            check_ell(cg.to(dev), D_c, dk, 33, dev, f"{name} D {D_c}")
    return {"inputs": x, "errs": errs}


def spread_graph(dev):
    """One scene of 256 nodes whose destinations draw 12 sources each
    uniformly from every node (duplicates kept; every 7th destination has
    no in-edge): every row's sources span the batch."""
    rng = np.random.default_rng(61)
    dst = np.repeat(np.arange(256), 12)
    src = rng.integers(0, 256, size=dst.shape)
    keep = dst % 7 != 3
    e = np.stack([src[keep], dst[keep]])
    return build_graph_batch([e], [256], 256, e.shape[1]).to(dev)


def spmm_form(form: str, *args):
    """bsp_spmm.cu in the form given, whatever bsp.spmm_form says."""
    return bsp.run_spmm(_Uncounted, *args, form=form)


def check_gathers(g, w, v, tag: str) -> None:
    """Both forms of the SpMM (bsp.SPMM_FORMS), each forced, on graph ``g``
    (f32 and bf16 values): bit-equal to each other and to a second launch,
    within tolerance of the plain version, rows without a valid slot
    exactly 0; with 4-byte rows the vector form raises; the wrappers
    (bsp.spmm, ell.spmm) bit for bit against their rule's form. The masked
    max on the same graph: bit-equal to the plain version, and a NaN among
    a row's valid values NaN out."""
    src, mask = g.ell_src, g.ell_mask
    empty = ~mask.any(dim=1)
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        vec = 8 if bsp._vec8(vv) else 1
        bf16 = dt == torch.bfloat16
        rule = bsp.SPMM_FORMS[bsp.spmm_form(vec, vv.shape[1], bf16)]
        want = bsp.spmm_reference(w, vv, src, mask)
        outs = {}
        for form in bsp.SPMM_FORMS:
            name = f"bsp_spmm {form}, {tag} {dt}"
            if vec == 1 and form != "row":
                try:
                    spmm_form(form, w, vv, src, mask)
                except ValueError:
                    continue
                raise AssertionError(f"{name}: took 4-byte rows")
            got = spmm_form(form, w, vv, src, mask)
            again = spmm_form(form, w, vv, src, mask)
            torch.cuda.synchronize()
            check_kernel_vs_plain(name, got, want, bf16)
            if not (torch.equal(got, again) and bool((got[empty] == 0).all())):
                raise AssertionError(f"{name}: two launches differ, or an "
                                     "empty row is not 0")
            outs[form] = got
        if not all(torch.equal(o, outs["row"]) for o in outs.values()):
            raise AssertionError(f"bsp_spmm, {tag} {dt}: the forms differ")
        if not (torch.equal(bsp.spmm(w, vv, src, mask), outs[rule])
                and torch.equal(ell.spmm(w, vv, src, mask), outs[rule])):
            raise AssertionError(f"bsp_spmm, {tag} {dt}: a wrapper does not "
                                 f"give its rule's form's ({rule}) bits")
    check_max(g, v, tag)
    log(f"[kernel] bsp_spmm, {tag}: both forms agree with the plain version, "
        "with each other and on rerun, bit for bit")


def phase_gather_kernels(dev, ek: dict, bk2: dict) -> dict:
    """Both forms of the SpMM, and the masked max, on the ell path's first
    train batch (D 8192), on the crafted graphs of degree 100 and 200 (D
    1030, the scalar loads, and 4096) and on a graph whose rows draw on the
    whole batch (D 4096); returns the operands of the SpMM's A/B: the ell
    path's batch (f32 and bf16), the mean and bsp2 forwards and dq's shape
    (D = dk)."""
    x = ek["inputs"]
    g = x["graph"]
    check_gathers(g, x["alpha"], x["v"], "swarm train")
    for name, cg in (("crafted", crafted_graph()),
                     ("crafted wide", crafted_wide_graph())):
        for D_c in (1030, 4096):
            xc = backward_inputs(cg.to(dev), 64, D_c, 63, dev)
            check_gathers(xc["graph"], xc["alpha"], xc["v"], f"{name} D {D_c}")
    sg = spread_graph(dev)
    xs = backward_inputs(sg, 64, 4096, 65, dev)
    check_gathers(sg, xs["alpha"], xs["v"], "sources over the whole batch")
    gm = next(iter(make_dataset(swarm_config("mean").data, "train")))[
        "graph"].to(dev)
    (vm,) = attention_inputs(gm.max_nodes, 1, x["v"].shape[1], 67, dev)[2:]
    b2 = bk2["inputs"]
    return {"ab": [
        ("ell", g, x["alpha"], x["v"]),
        ("ell bf16", g, x["alpha"], x["v"].to(torch.bfloat16)),
        ("mean", gm, bsp._mean_weights(gm.ell_mask), vm),
        ("bsp2", b2["graph"], b2["alpha"], b2["v"]),
        ("dq", g, x["dlog"], x["kf"])]}


def phase_spmm_form_timings(gk: dict, tag: dict) -> None:
    """Device time per call of both forms of the SpMM in turns (the forms in
    order, then in reverse) at the shapes phase_gather_kernels returns:
    spmm_form_ab, the rule's crossover."""
    rows = []
    for name, g, w, v in gk["ab"]:
        src, mask = g.ell_src, g.ell_mask
        turns = {f: [] for f in bsp.SPMM_FORMS}
        for form in bsp.SPMM_FORMS + bsp.SPMM_FORMS[::-1]:
            turns[form].append(device_ms(
                lambda: spmm_form(form, w, v, src, mask)))
        rows.append({"shape": name, "V": int(src.shape[0]),
                     "deg": int(src.shape[1]), "edges": int(mask.sum()),
                     "D": int(v.shape[1]), "dtype": str(v.dtype),
                     "rule": bsp.SPMM_FORMS[bsp.spmm_form(
                         8, v.shape[1], v.dtype == torch.bfloat16)],
                     "device_ms": turns})
    log(json.dumps({"metric": "spmm_form_ab", "rows": rows,
                    "timing": "device time per call (profiler); turns: the "
                              "forms in order, then in reverse", **tag}))


def weights_form(form: str, *args, logits: bool = False):
    """bsp_weights.cu in the form given, whatever bsp.weights_form says."""
    return bsp.run_attention_weights(_Uncounted, *args, form=form,
                                     logits=logits)


def softmax_form(form: str, *args):
    """ell_softmax.cu in the form given, whatever ell.softmax_form says."""
    return ell.run_softmax(_Uncounted, *args, form=form)


def check_softmax_rows(name: str, got, want, mask) -> float:
    """A softmax kernel's output against its plain version (f32, TOL_F32),
    masked slots and rows without a valid slot exactly 0, each valid row
    summing to 1 within 1e-5. Returns the max abs err."""
    err = check_kernel_vs_plain(name, got, want, False)
    rows = mask.any(dim=1)
    sums = float((got[rows].sum(-1) - 1).abs().max()) if bool(rows.any()) else 0.0
    if not (bool((got[~mask] == 0).all()) and bool((got[~rows] == 0).all())
            and sums <= 1e-5):
        raise AssertionError(f"{name}: a masked slot or an empty row is not "
                             f"0, or a row sums to 1 only within {sums:.3g}")
    return err


def check_weights_forms(q_s, kf, g, tag: str) -> None:
    """Both forms of the attention weights (bsp.WEIGHTS_FORMS), each
    forced, on graph ``g``: within tolerance of the plain version
    (check_softmax_rows), bit for bit on rerun; the rows form's logits bit
    for bit against the per-edge SDDMM on the same (q_s, k); the wrapper
    bit for bit against its rule's form."""
    src, mask = g.ell_src, g.ell_mask
    want = bsp.attention_weights_reference(q_s, kf, src, mask)
    rule = bsp.WEIGHTS_FORMS[bsp.weights_form(q_s.shape[1],
                                              bsp._vec8(q_s, kf))]
    outs = {}
    for form in bsp.WEIGHTS_FORMS:
        name = f"bsp_weights {form}, {tag}"
        got = weights_form(form, q_s, kf, src, mask)
        again = weights_form(form, q_s, kf, src, mask)
        torch.cuda.synchronize()
        check_softmax_rows(name, got, want, mask)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        outs[form] = got
    alpha, lo = weights_form("rows", q_s, kf, src, mask, logits=True)
    if not (torch.equal(alpha, outs["rows"]) and torch.equal(
            lo, sddmm_form(False, q_s, kf, src, mask))):
        raise AssertionError(f"bsp_weights rows, {tag}: its logits are not "
                             "the per-edge SDDMM's bits")
    if not torch.equal(bsp.attention_weights(q_s, kf, src, mask), outs[rule]):
        raise AssertionError(f"bsp_weights, {tag}: the wrapper does not give "
                             f"its rule's form's ({rule}) bits")
    log(f"[kernel] bsp_weights, {tag}: both forms agree with the plain "
        "version and on rerun; the rows form's logits are bsp_sddmm's bits")


def check_softmax_forms(logits, mask, tag: str) -> None:
    """Both forms of the ELL softmax (ell.SOFTMAX_FORMS), each forced, on
    ``logits``: within tolerance of the plain version (check_softmax_rows),
    bit for bit on rerun; the wrapper bit for bit against its rule's
    form."""
    want = bsp.masked_softmax(logits, mask)
    rule = ell.SOFTMAX_FORMS[ell.softmax_form(logits.shape[1])]
    outs = {}
    for form in ell.SOFTMAX_FORMS:
        name = f"ell_softmax {form}, {tag}"
        got = softmax_form(form, logits, mask)
        again = softmax_form(form, logits, mask)
        torch.cuda.synchronize()
        check_softmax_rows(name, got, want, mask)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        outs[form] = got
    if not torch.equal(ell.softmax(logits, mask), outs[rule]):
        raise AssertionError(f"ell_softmax, {tag}: the wrapper does not give "
                             f"its rule's form's ({rule}) bits")


def wide_softmax_graph(dev):
    """One scene of 200 nodes where node 0 has 128 in-edges cycling over
    the others, nodes 1 .. 9 one each and the rest none: an ELL width of
    128, the most both softmax kernels' fast forms take."""
    src0 = 1 + np.arange(128) % 199
    e = np.concatenate([np.stack([src0, np.zeros(128, np.int64)]),
                        np.stack([np.arange(2, 11), np.arange(1, 10)])], axis=1)
    return build_graph_batch([e], [200], 208, e.shape[1]).to(dev)


def phase_softmax_form_kernels(dev, ek: dict, bk2: dict) -> dict:
    """Both forms of the attention weights at the bsp2 path's first train
    batch (dk 64) and of the ELL softmax at the ell path's logits, and both
    kernels at one wide shape (ELL width 128, dk 200; the softmax on logits
    spread 8 wide); returns the A/B's operands."""
    b = bk2["inputs"]
    check_weights_forms(b["q_s"], b["kf"], b["graph"], "bsp2 train")
    x = ek["inputs"]
    g = x["graph"]
    logits = bsp.sddmm_reference(x["q_s"], x["kf"], g.ell_src, g.ell_mask)
    check_softmax_forms(logits, g.ell_mask, "ell train logits")
    gw = wide_softmax_graph(dev)
    xw = backward_inputs(gw, 200, 64, 71, dev)
    check_weights_forms(xw["q_s"], xw["kf"], gw, "deg 128, dk 200")
    spread = torch.from_numpy(np.random.default_rng(72).normal(
        size=tuple(gw.ell_src.shape)).astype(np.float32) * 8).to(dev)
    check_softmax_forms(spread, gw.ell_mask, "deg 128, logits spread 8 wide")
    return {"weights": b, "softmax": (logits, g.ell_mask)}


def phase_softmax_form_timings(sk: dict, tag: dict) -> None:
    """Device time per call of both forms of the attention weights at the
    bsp2 path's batch (weights_form_ab, with the per-edge SDDMM of the same
    logits beside them) and of the ELL softmax at the ell path's logits
    (softmax_form_ab), in turns: the forms in order, then in reverse."""
    b = sk["weights"]
    g = b["graph"]
    src, mask = g.ell_src, g.ell_mask
    args = (b["q_s"], b["kf"], src, mask)
    turns = {f: [] for f in bsp.WEIGHTS_FORMS}
    for form in bsp.WEIGHTS_FORMS + bsp.WEIGHTS_FORMS[::-1]:
        turns[form].append(device_ms(lambda: weights_form(form, *args)))
    log(json.dumps({"metric": "weights_form_ab", "V": int(src.shape[0]),
                    "deg": int(src.shape[1]), "edges": int(mask.sum()),
                    "dk": int(b["q_s"].shape[1]),
                    "rule": bsp.WEIGHTS_FORMS[bsp.weights_form(
                        b["q_s"].shape[1], bsp._vec8(b["q_s"], b["kf"]))],
                    "device_ms": turns,
                    "ell_sddmm_ms": device_ms(lambda: ell.sddmm(*args)),
                    "timing": "device time per call (profiler), f32; turns: "
                              "the forms in order, then in reverse; "
                              "ell_sddmm_ms: the per-edge SDDMM of the same "
                              "logits, after the turns", **tag}))
    logits, lmask = sk["softmax"]
    turns = {f: [] for f in ell.SOFTMAX_FORMS}
    for form in ell.SOFTMAX_FORMS + ell.SOFTMAX_FORMS[::-1]:
        turns[form].append(device_ms(lambda: softmax_form(form, logits,
                                                          lmask)))
    log(json.dumps({"metric": "softmax_form_ab", "V": int(lmask.shape[0]),
                    "deg": int(lmask.shape[1]), "edges": int(lmask.sum()),
                    "rule": ell.SOFTMAX_FORMS[ell.softmax_form(
                        lmask.shape[1])],
                    "device_ms": turns,
                    "timing": "device time per call (profiler), f32; turns: "
                              "the forms in order, then in reverse", **tag}))


def check_weights(x: dict, tag: str) -> tuple:
    """The weights kernel against its plain version on the operands of
    ``backward_inputs`` (f32; masked slots and rows without a valid slot
    exactly 0), and the gradients of its Function (the ``_bsp_weights`` vjp)
    against autograd through the plain version. Returns (alpha, max abs
    err)."""
    g = x["graph"]
    src, mask = g.ell_src, g.ell_mask
    got = bsp.attention_weights(x["q_s"], x["kf"], src, mask)
    want = bsp.attention_weights_reference(x["q_s"], x["kf"], src, mask)
    torch.cuda.synchronize()
    err = check_kernel_vs_plain(f"bsp_weights, {tag}", got, want, False)
    if not (bool((got[~mask] == 0).all())
            and bool((got[~mask.any(dim=1)] == 0).all())):
        raise AssertionError("bsp_weights: masked slots and rows without a "
                             "valid slot must be exactly 0")
    ct = torch.randn(src.shape, generator=torch.Generator().manual_seed(3))
    grads = []
    for fn in (bsp.BspWeights.apply, bsp.attention_weights_reference):
        q = x["q_s"].detach().clone().requires_grad_()
        k = x["kf"].detach().clone().requires_grad_()
        (fn(q, k, src, mask) * ct.to(src.device)).sum().backward()
        grads.append((q.grad, k.grad))
    torch.cuda.synchronize()
    for gname, a, b in zip(("dq_s", "dk"), *grads):
        rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        log(f"[kernel] BspWeights {gname}, {tag}: max err {rel:.3e} of the "
            f"largest gradient (tol {TOL_GRAD_REL[torch.float32]:.3g})")
        if not rel <= TOL_GRAD_REL[torch.float32]:
            raise AssertionError("BspWeights' backward disagrees with "
                                 "autograd of the plain version")
    return got, err


def backward_view(x: dict) -> dict:
    """The transposed SpMMs' operands of the attention backward on
    ``x["graph"]``'s ELL lists (on the hideg graph, the node view that its
    backward passes)."""
    g = x["graph"]
    return {"src": g.ell_src, "mask": g.ell_mask, "q_s": x["q_s"],
            "ct": x["ct"], "alpha": x["alpha"], "dlog": x["dlog"],
            "V": g.max_nodes}


def check_spmm_t2(x: dict, tag: str) -> float:
    """The dual transposed SpMM as the attention backward calls it, (alpha,
    cotangent) -> dvalues and (dlog, q_s) -> dk, in the form the rule
    takes, bit for bit against two single launches and within tolerance of
    its plain version, with f32 and bf16 values. Returns the f32 max abs
    err."""
    b = backward_view(x)
    src, mask, V = b["src"], b["mask"], b["V"]
    err = 0.0
    for vdt in (torch.float32, torch.bfloat16):
        ct = b["ct"].to(vdt)
        dv, dk = bsp.spmm_t2(b["alpha"], ct, b["dlog"], b["q_s"], src, mask,
                             V, vdt, torch.float32)
        one = bsp.spmm_t(b["alpha"], ct, src, mask, V, vdt)
        two = bsp.spmm_t(b["dlog"], b["q_s"], src, mask, V, torch.float32)
        torch.cuda.synchronize()
        name = f"{tag}, values {vdt}"
        if not (torch.equal(dv, one) and torch.equal(dk, two)):
            raise AssertionError(f"bsp_spmm_t2, {name}: not bit-equal to two "
                                 "bsp_spmm_t launches")
        want_dv, want_dk = bsp.spmm_t2_reference(
            b["alpha"], ct, b["dlog"], b["q_s"], src, mask, V, vdt,
            torch.float32)
        e1 = check_kernel_vs_plain(
            f"bsp_spmm_t2 dvalues (bit-equal to bsp_spmm_t), {name}", dv,
            want_dv, vdt == torch.bfloat16)
        e2 = check_kernel_vs_plain(
            f"bsp_spmm_t2 dk (bit-equal to bsp_spmm_t), {name}", dk, want_dk,
            False)
        if vdt == torch.float32:
            err = max(e1, e2)
    return err


def phase_bsp2_kernels(dev) -> dict:
    """The weights kernel at the bsp2 path's first train batch (built by the
    native graph builder) and on the crafted graph, with a tight and a
    padded tile-pair plan; the two-kernel attention's gradients; the dual
    transposed SpMM at the attention backward's shapes and on the hideg
    path's node view."""
    cfg = native_swarm_config()
    m = cfg.model
    hw = m.image_size[0] // m.bottleneck_stride
    D, dk = hw * hw * m.encoder_channels[-1], m.attention_dim
    g = next(iter(make_dataset(cfg.data, "train")))["graph"].to(dev)
    log(f"[kernel] bsp2 train batch 0 (native builder): V {g.max_nodes}, deg "
        f"{g.ell_src.shape[1]}, valid edges {int(g.ell_mask.sum())}, pairs "
        f"{g.bsp_pair_dst.shape[0]}, dk {dk}, D {D}")
    x = backward_inputs(g, dk, D, 41, dev)
    errs = {}
    _, errs["bsp_weights"] = check_weights(x, "bsp2 train")
    # bf16 values: the plain side on f32 values, as in check_parts
    check_function_grads(x, "bsp2 train", bsp.bsp_attention, "bsp_attention",
                         _plain_f32_values)
    tight = crafted_graph()
    padded = crafted_graph(max_bsp_pairs=4 * tight.bsp_pair_dst.shape[0])
    alphas = []
    for name, cg in (("crafted", tight), ("crafted, padded plan", padded)):
        xc = backward_inputs(cg.to(dev), dk, 1030, 43, dev)
        alphas.append(check_weights(xc, name)[0])
        check_function_grads(xc, name, bsp.bsp_attention, "bsp_attention",
                             _plain_f32_values)
    if not torch.equal(*alphas):
        raise AssertionError("bsp_weights: inert pairs of a padded plan "
                             "changed alpha")
    log(f"[kernel] bsp_weights: the plan padded from "
        f"{tight.bsp_pair_dst.shape[0]} to {padded.bsp_pair_dst.shape[0]} "
        "pairs gives the same alpha, bit for bit")
    errs["bsp_spmm_t2"] = check_spmm_t2(x, "bsp2 train")
    xh = backward_inputs(hideg_graph(dev), dk, D, 45, dev)
    errs["bsp_spmm_t2"] = max(errs["bsp_spmm_t2"],
                              check_spmm_t2(xh, "hideg node view"))
    return {"inputs": x, "hideg": xh, "errs": errs}


def sddmm_form(tiled: bool, *args):
    """bsp_sddmm.cu in the form given, whatever bsp.tiled_form says."""
    return bsp.run_sddmm(_Uncounted, *args, tiled=tiled)


def spmm_t_form(form: str, pairs, src, mask, Vs: int, view=None):
    """bsp_spmm_t.cu in the form given (a name of bsp.SPMM_T_FORMS), over
    (w, x, out dtype) pairs; the per-edge form over ``view``, or over a
    view it builds."""
    return bsp._run_spmm_t(_Uncounted, pairs, src, mask, Vs, view, form=form)


def rule_form(g) -> str:
    """The form bsp.tiled_form gives graph ``g``'s ELL lists (the SDDMM's
    rule)."""
    V, deg = g.ell_src.shape
    return "tiled" if bsp.tiled_form(V, g.max_nodes, deg) else "per-edge"


def spmm_t_rule(src, mask, Vs: int) -> str:
    """The form bsp.spmm_t_form gives a transposed SpMM over ``src`` /
    ``mask`` into Vs rows."""
    V, deg = src.shape
    return bsp.SPMM_T_FORMS[bsp.spmm_t_form(V, Vs, deg,
                                            bsp._aligned16(src, mask))]


# The widest ELL lists whose windows fit the staged form's shared memory
# with f32 x (csrc/bsp_spmm_t.cu staged_smem_bytes, 227 KB a block).
STAGED_WIDEST = 280


def spmm_t_forms(deg: int) -> tuple:
    """The forms of bsp_spmm_t.cu that take ELL width ``deg``."""
    return tuple(f for f in bsp.SPMM_T_FORMS
                 if f != "staged" or deg <= STAGED_WIDEST)


def check_spmm_t_forms(pairs, src, mask, Vs: int, name: str,
                       errs: dict | None = None) -> dict:
    """Each form of the transposed SpMM that takes the width (forced), over
    the dual pairs ``pairs`` (w, x, out dtype) into Vs rows, against the
    plain version: a single launch of the first pair twice (bit for bit)
    and of the second, the dual bit for bit against the singles, unnamed
    sources 0; the staged form bit for bit against the per-edge form; the
    wrappers (``bsp.spmm_t2``, ``bsp.spmm_t``) bit for bit against the
    form of the rule. Returns each form's dual outputs."""
    (w1, x1, o1), (w2, x2, o2) = pairs
    want1 = bsp.spmm_t_reference(w1, x1, src, mask, Vs, o1)
    want2 = bsp.spmm_t_reference(w2, x2, src, mask, Vs, o2)
    named = torch.zeros(Vs, dtype=torch.bool, device=src.device)
    named[src[mask].long()] = True
    got = {}
    for form in spmm_t_forms(src.shape[1]):
        dv, dk = spmm_t_form(form, pairs, src, mask, Vs)
        one = spmm_t_form(form, pairs[:1], src, mask, Vs)[0]
        again = spmm_t_form(form, pairs[:1], src, mask, Vs)[0]
        two = spmm_t_form(form, pairs[1:], src, mask, Vs)[0]
        torch.cuda.synchronize()
        tag = f"{form}, {name}"
        e1 = check_kernel_vs_plain(f"bsp_spmm_t2 first, {tag}", dv, want1,
                                   o1 == torch.bfloat16)
        e2 = check_kernel_vs_plain(f"bsp_spmm_t2 second, {tag}", dk, want2,
                                   o2 == torch.bfloat16)
        if not (torch.equal(one, again) and torch.equal(dv, one)
                and torch.equal(dk, two)):
            raise AssertionError(f"bsp_spmm_t, {tag}: two runs differ, or "
                                 "the dual is not bit-equal to two single "
                                 "launches")
        if not (bool((dv[~named] == 0).all())
                and bool((dk[~named] == 0).all())):
            raise AssertionError(f"bsp_spmm_t, {tag}: unnamed sources must "
                                 "give 0")
        if errs is not None and x1.dtype == o1 == torch.float32:
            errs[form] = max(errs.get(form, 0.0), e1, e2)
        got[form] = (dv, dk)
    if "staged" in got and not all(
            torch.equal(a, b) for a, b in zip(got["staged"], got["per-edge"])):
        raise AssertionError(f"bsp_spmm_t, {name}: the staged form is not "
                             "bit for bit the per-edge form")
    rule = spmm_t_rule(src, mask, Vs)
    dual = bsp.spmm_t2(w1, x1, w2, x2, src, mask, Vs, o1, o2)
    single = bsp.spmm_t(w1, x1, src, mask, Vs, o1)
    if not (torch.equal(dual[0], got[rule][0]) and torch.equal(
            dual[1], got[rule][1]) and torch.equal(single, got[rule][0])):
        raise AssertionError(f"bsp_spmm_t, {name}: the wrappers do not give "
                             f"the bits of their rule's {rule} form")
    return got


def check_forms(x: dict, tag: str, errs: dict | None = None) -> None:
    """Both forms of the SDDMM and every form of the transposed SpMM, each
    forced, against their plain versions on the operands of
    ``backward_inputs`` (f32, bf16 and mixed operands): the dual SDDMM and a
    single launch of each of its pairs, bit for bit against the dual's
    outputs, the second single twice (bit for bit); the transposed SpMM as
    :func:`check_spmm_t_forms` holds it, at dvalues (width D) and dk (width
    dk) as the attention backward pairs them."""
    g = x["graph"]
    src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
    D = x["v"].shape[1]
    log(f"[kernel] {tag}: V {V}, deg {src.shape[1]}, edges "
        f"{int(mask.sum())}, D {D}; the SDDMM's rule takes the "
        f"{rule_form(g)} form, the transposed SpMM's the "
        f"{spmm_t_rule(src, mask, V)} form")
    want_lo = bsp.sddmm_reference(x["q_s"], x["kf"], src, mask)
    for vdt, gdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        v, ct = x["v"].to(vdt), x["ct"].to(gdt)
        want_da = bsp.sddmm_reference(ct, v, src, mask)
        name = f"{tag}, values {vdt} cotangent {gdt}"
        for tiled, form in FORMS:
            lo, da = sddmm_form(tiled, x["q_s"], x["kf"], src, mask, ct, v)
            single = sddmm_form(tiled, ct, v, src, mask)
            single_again = sddmm_form(tiled, ct, v, src, mask)
            single_lo = sddmm_form(tiled, x["q_s"], x["kf"], src, mask)
            torch.cuda.synchronize()
            e1 = check_kernel_vs_plain(f"bsp_sddmm logits, {form}, {name}",
                                       lo, want_lo, False)
            e2 = check_kernel_vs_plain(f"bsp_sddmm dalpha, {form}, {name}",
                                       da, want_da, False, scale=D ** 0.5)
            if not (torch.equal(single, da) and torch.equal(single_lo, lo)
                    and torch.equal(single, single_again)):
                raise AssertionError(f"bsp_sddmm, {form}, {name}: a single "
                                     "launch differs from the dual's output, "
                                     "or two runs differ")
            if not bool((da[~mask] == 0).all()):
                raise AssertionError(f"bsp_sddmm, {form}, {name}: masked "
                                     "slots must give 0")
            if errs is not None and vdt == gdt == torch.float32:
                errs[form] = max(errs.get(form, 0.0), e1, e2)
        check_spmm_t_forms(((x["alpha"], ct, vdt),
                            (x["dlog"], x["q_s"], torch.float32)),
                           src, mask, V, name,
                           errs if vdt == gdt == torch.float32 else None)
    log(f"[kernel] {tag}: every form agrees with the plain versions; single "
        "= dual bit for bit; the staged transposed SpMM bit for bit the "
        "per-edge one; reruns bit for bit")


def check_rectangular(dev, errs: dict) -> None:
    """Every form of the transposed SpMM on ELL lists whose sources are not
    their rows (V 100 destination rows, not a multiple of the 64-node tile;
    Vs 200 and 50 sources, the partitioned shard's halo and a narrower
    source set; width 12 with duplicates and masked slots), at D 1030 and
    4096 into dk's width 64, f32, bf16 and mixed, as
    :func:`check_spmm_t_forms` holds them."""
    rng = np.random.default_rng(61)
    V, deg = 100, 12
    for Vs in (200, 50):
        src = torch.from_numpy(rng.integers(0, Vs, size=(V, deg)).astype(
            np.int32)).to(dev)
        src[:, 1] = src[:, 0]  # a duplicate slot in every row
        mask = torch.from_numpy(rng.random((V, deg)) < 0.7).to(dev)
        mask[::7] = False      # rows with no valid slot
        w1 = torch.where(mask, torch.from_numpy(rng.random((V, deg)).astype(
            np.float32)).to(dev), 0.0)
        w2 = torch.where(mask, torch.from_numpy(rng.normal(
            size=(V, deg)).astype(np.float32)).to(dev), 0.0)
        x2 = torch.from_numpy(rng.normal(size=(V, 64)).astype(
            np.float32)).to(dev)
        for D in (1030, 4096):
            x1 = torch.from_numpy(rng.normal(size=(V, D)).astype(
                np.float32)).to(dev)
            for xdt, odt in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
                check_spmm_t_forms(((w1, x1.to(xdt), odt),
                                    (w2, x2, torch.float32)), src, mask, Vs,
                                   f"rectangular V {V} Vs {Vs} D {D} x "
                                   f"{xdt} out {odt}", errs)
    log("[kernel] bsp_spmm_t, rectangular lists (Vs 200 and 50 over V 100): "
        "every form agrees with the plain version, the staged form bit for "
        "bit the per-edge one, single = dual and reruns bit for bit")


def phase_form_kernels(dev) -> dict:
    """Both forms of bsp_sddmm.cu and every form of bsp_spmm_t.cu against
    their plain versions at the hideg backward's node view, on the crafted
    graphs of degree 100 and 200 (D 1030, the scalar loads, and 4096; V 32
    and 128), on rectangular lists and at the swarm's training shape."""
    m = swarm_config().model
    hw = m.image_size[0] // m.bottleneck_stride
    D, dk = hw * hw * m.encoder_channels[-1], m.attention_dim
    errs = {}
    xh = backward_inputs(hideg_graph(dev), dk, D, 51, dev)
    check_forms(xh, "hideg node view", errs)
    for name, cg in (("crafted", crafted_graph()),
                     ("crafted wide", crafted_wide_graph())):
        for D_c in (1030, 4096):
            check_forms(backward_inputs(cg.to(dev), dk, D_c, 53, dev),
                        f"{name} D {D_c}", errs)
    check_rectangular(dev, errs)
    g = next(iter(make_dataset(swarm_config().data, "train")))["graph"].to(dev)
    xs = backward_inputs(g, dk, D, 55, dev)
    check_forms(xs, "swarm train", errs)
    return {"hideg": xh, "swarm": xs, "errs": errs, "dk": dk, "D": D}


def phase_form_timings(fk: dict, tag: dict) -> None:
    """Device time per call of each form of the dual SDDMM and the dual
    transposed SpMM (f32), as the attention backward calls them, in turns
    (per-edge, tiled, tiled, per-edge): at the swarm's training batch, at
    the hideg node view, and on fully connected teams of n robots packed
    into 512 node slots (ELL width n - 1): the crossover of the form rule."""
    D, dk = fk["D"], fk["dk"]
    x = fk["hideg"]
    g = x["graph"]
    src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
    edges = int(mask.sum())
    rows_ = torch.arange(V, device=src.device)[:, None].expand_as(src)[mask]
    pattern = _csr(rows_, src[mask].long(),
                   torch.ones(edges, device=src.device), (V, V))
    kT, vT = x["kf"].t().contiguous(), x["v"].t().contiguous()
    time_kernel(
        "bsp_sddmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_sddmm.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:905",
        {"V": V, "deg": int(src.shape[1]), "d1": dk, "d2": D, "edges": edges,
         "form": f"dual, {rule_form(g)}", "dtype": "float32",
         "use": "logits and dalpha of the hideg backward, node view"},
        lambda: bsp.sddmm(x["q_s"], x["kf"], src, mask, x["ct"], x["v"]),
        lambda: (bsp.sddmm_reference(x["q_s"], x["kf"], src, mask),
                 bsp.sddmm_reference(x["ct"], x["v"], src, mask)),
        lambda: (torch.sparse.sampled_addmm(pattern, x["q_s"], kT, beta=0.0),
                 torch.sparse.sampled_addmm(pattern, x["ct"], vT, beta=0.0)),
        "torch.sparse.sampled_addmm x2 on the [V, V] pattern",
        bound_ms((x["q_s"], x["kf"], x["ct"], x["v"], src, mask),
                 (x["alpha"], x["dlog"]), 2 * edges * (dk + D)),
        fk["errs"]["tiled"], tag)
    graphs = [("swarm train", fk["swarm"]["graph"]),
              ("hideg node view", fk["hideg"]["graph"])]
    dev = fk["hideg"]["graph"].ell_src.device
    for n in (9, 17, 33, 49, 65, 97, 129):
        team = batch_fully_connected(512 // n, n, max_nodes=512)
        graphs.append((f"{512 // n} x {n} fully connected", team.to(dev)))
    rows = []
    for seed, (name, g) in enumerate(graphs):
        x = {"swarm train": fk["swarm"], "hideg node view": fk["hideg"]}.get(
            name) or backward_inputs(g, dk, D, 57 + seed, dev)
        src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
        edges, pairs = int(mask.sum()), len(bsp.tile_pairs(src, mask))
        t_forms = spmm_t_forms(int(src.shape[1]))
        ms = {"sddmm": {"per-edge": [], "tiled": []},
              "spmm_t2": {f: [] for f in t_forms}}
        for form in ("per-edge", "tiled", "tiled", "per-edge"):
            tiled = form == "tiled"
            ms["sddmm"][form].append(device_ms(lambda: sddmm_form(
                tiled, x["q_s"], x["kf"], src, mask, x["ct"], x["v"])))
        for form in t_forms + t_forms[::-1]:
            ms["spmm_t2"][form].append(device_ms(lambda: spmm_t_form(
                form, ((x["alpha"], x["ct"], torch.float32),
                       (x["dlog"], x["q_s"], torch.float32)), src, mask, V)))
        rows.append({"graph": name, "V": V, "deg": int(src.shape[1]),
                     "edges": edges, "tile_pairs": pairs,
                     "fill": edges / (pairs * bsp.TILE ** 2),
                     "rule": rule_form(g),
                     "spmm_t_rule": spmm_t_rule(src, mask, V),
                     "device_ms": ms})
    log(json.dumps({"metric": "form_ab", "D1": D, "D2": dk, "rows": rows,
                    "timing": "device time per call (profiler), f32, the "
                              "dual SDDMM (q_s, k) + (g, values) and the dual "
                              "transposed SpMM (alpha, g) + (dlog, q_s), the "
                              "per-edge form including its source view; "
                              "turns per-edge, tiled, tiled, per-edge (the "
                              "SDDMM) and the transposed SpMM's forms in "
                              "order, then reversed",
                    **tag}))


# Teams of SPMM_T_TEAM robots packed into V node slots, at the widths the
# staged form's rule is timed on (bsp.STAGED_MAX_NODES).
SPMM_T_TEAM, SPMM_T_RULE_V, SPMM_T_RULE_D = 8, (1024, 2048, 4096, 8192), (2048, 8192)


def phase_spmm_t_form_timings(tk: dict, bk2: dict, tag: dict) -> None:
    """Device time per call of the transposed SpMM's forms in turns (in
    order, then reversed; f32): at the attention path's dual launch (alpha
    and the cotangent, dvalues at D 8192; dlog and q_s, dk at 64) and the
    bsp2 path's two single launches (dvalues, dk), each of: the staged form,
    the per-edge kernel alone (its source view built outside the clock),
    the per-edge kernel with its view built inside the clock (the form as
    the paths ran it before the staged form), the tiled form and
    torch.sparse.mm of the CSR of w transposed (one call a pair), beside the
    bound and the rule's form; then the staged form against the per-edge
    form with its view, in turns, on fully connected teams of SPMM_T_TEAM
    robots at V 1,024 to 8,192 (width 7, D 2048 and 8192): the crossover
    behind bsp.STAGED_MAX_NODES."""
    rows = []
    a, b = tk["inputs"], bk2["inputs"]
    cases = (("attention dual", a, ((a["alpha"], a["ct"], torch.float32),
                                    (a["dlog"], a["q_s"], torch.float32))),
             ("bsp2 dvalues", b, ((b["alpha"], b["ct"], torch.float32),)),
             ("bsp2 dk", b, ((b["dlog"], b["q_s"], torch.float32),)))
    for name, x, pairs in cases:
        g = x["graph"]
        src, mask, V = g.ell_src, g.ell_mask, g.max_nodes
        deg = src.shape[1]
        edges = int(mask.sum())
        r = torch.arange(V, device=src.device)[:, None].expand(V, deg)[mask]
        c = src[mask].long()
        csrs = [_csr(c, r, w[mask], (V, V)) for w, _, _ in pairs]
        view = bsp.source_view(src, mask, V)
        fns = {
            "staged": lambda: spmm_t_form("staged", pairs, src, mask, V),
            "per-edge": lambda: spmm_t_form("per-edge", pairs, src, mask, V,
                                            view),
            "per-edge + view": lambda: spmm_t_form("per-edge", pairs, src,
                                                   mask, V),
            "tiled": lambda: spmm_t_form("tiled", pairs, src, mask, V),
            "torch.sparse.mm": lambda: [torch.sparse.mm(m, xx) for m, (
                _, xx, _) in zip(csrs, pairs)]}
        times = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            times[n].append(device_ms(fns[n]))
        outs = spmm_t_form("staged", pairs, src, mask, V)
        bound = bound_ms((*(t for w, xx, _ in pairs for t in (w, xx)), src,
                          mask), outs,
                         sum(2 * edges * xx.shape[1] for _, xx, _ in pairs))
        rows.append({"case": name, "V": V, "deg": deg, "edges": edges,
                     "D": [xx.shape[1] for _, xx, _ in pairs],
                     "rule": spmm_t_rule(src, mask, V), "device_ms": times,
                     "bound_ms": bound[0], "bound_by": bound[1]})
    dev = a["graph"].ell_src.device
    rng = np.random.default_rng(71)
    rule_rows = []
    for V in SPMM_T_RULE_V:
        team = batch_fully_connected(V // SPMM_T_TEAM, SPMM_T_TEAM,
                                     max_nodes=V).to(dev)
        src, mask = team.ell_src, team.ell_mask
        w = torch.where(mask, torch.from_numpy(rng.random(
            tuple(src.shape)).astype(np.float32)).to(dev), 0.0)
        for D in SPMM_T_RULE_D:
            xx = torch.from_numpy(rng.normal(size=(V, D)).astype(
                np.float32)).to(dev)
            pairs = ((w, xx, torch.float32),)
            times = {"staged": [], "per-edge + view": []}
            for n in ("staged", "per-edge + view", "per-edge + view",
                      "staged"):
                times[n].append(device_ms(lambda: spmm_t_form(
                    n.split()[0], pairs, src, mask, V)))
            rule_rows.append({"V": V, "deg": int(src.shape[1]), "D": D,
                              "rule": spmm_t_rule(src, mask, V),
                              "device_ms": times})
            del xx
    log(json.dumps({"metric": "spmm_t_form_ab", "rows": rows,
                    "rule_rows": rule_rows,
                    "timing": "device time per call (profiler), f32; turns "
                              "in the order given, then reversed; per-edge "
                              "walks a view built outside the clock, per-edge "
                              "+ view builds it inside (bsp.source_view: a "
                              "sort and a search)", **tag}))


def _expected(per: dict) -> dict:
    """A launch count for every kernel: ``per``'s, 0 for the others."""
    unknown = set(per) - set(bsp.KERNELS)
    if unknown:
        raise AssertionError(f"unknown kernels {unknown}")
    return {k: per.get(k, 0) for k in bsp.KERNELS}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _plain(cfg):
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                    ops_impl="xla"))


def phase_serving(dev, cfg, per_request: dict, path: str,
                  edge_fusion_fn=None) -> dict:
    """Three eval batches through ``Predictor`` with the kernels, each
    request checked for its kernel launches, then against the plain ops."""
    cfg_plain = _plain(cfg)
    m = cfg.model
    want = _expected(per_request)
    model = MultiRobotPerceptionNet(
        m, ops_impl=cfg.parallel.ops_impl,
        generator=torch.Generator().manual_seed(0),
        edge_fusion_fn=edge_fusion_fn).to(dev)
    batches = []
    it = iter(make_dataset(cfg.data, "eval", shuffle=False))
    for _ in range(3):
        batches.append(next(it))
    bsp.reset_launches()  # the serving path starts here
    outs = []
    for i, b in enumerate(batches):
        pred = Predictor(cfg, model, graph=b["graph"])
        before = bsp.launch_counts()
        out = pred(b["images"])
        got = _delta(before, bsp.launch_counts())
        if got != want:
            raise AssertionError(f"{path} request {i}: kernel launches {got}, "
                                 f"expected {want}")
        outs.append(out)
    launches = bsp.launch_counts()  # the serving path ends here
    if any(launches[k] == 0 for k in per_request):
        raise AssertionError(f"the {path} serving path never launched one of "
                             f"{sorted(per_request)}")
    max_err = 0.0
    for i, (b, out) in enumerate(zip(batches, outs)):
        d, s = out["depth"], out["seg"]
        V = b["graph"].max_nodes
        valid = b["graph"].node_mask.numpy()
        if d.shape != (V,) + cfg.data.image_size or s.shape != d.shape:
            raise AssertionError(f"request {i}: bad shapes {d.shape} {s.shape}")
        dv = d[valid]
        if not np.isfinite(d).all() or not ((dv > m.min_depth) & (dv < m.max_depth)).all():
            raise AssertionError(f"request {i}: depth out of range "
                                 f"[{dv.min()}, {dv.max()}]")
        if s.min() < 0 or s.max() >= m.num_seg_classes:
            raise AssertionError(f"request {i}: seg out of range")
        plain = Predictor(cfg_plain, model, graph=b["graph"])(b["images"])
        err = float(np.abs(plain["depth"] - d).max())
        agree = float((plain["seg"] == s).mean())
        max_err = max(max_err, err)
        log(f"[serve {path}] request {i}: {int(valid.sum())} of {V} views, "
            f"depth [{dv.min():.4f}, {dv.max():.4f}] m, vs plain ops max abs "
            f"err {err:.3e} m (tol {TOL_SERVE_DEPTH_M}), seg agreement "
            f"{agree:.6f}")
        if err > TOL_SERVE_DEPTH_M:
            raise AssertionError(f"{path} request {i}: kernel path disagrees "
                                 "with the plain ops")
    log(f"[serve {path}] 3 requests served, kernel launches {launches} "
        f"({want} per request)")
    return {"model": model, "cfg": cfg, "batches": batches,
            "launches": launches, "depth_err": max_err}


def phase_train(dev, cfg, per_step: dict, path: str,
                edge_fusion_fn=None) -> dict:
    """Three full-width train steps through the kernels, then the same three
    steps from the same weights through the plain ops, on the card."""
    cfg_plain = _plain(cfg)
    want = _expected(per_step)
    it = iter(make_dataset(cfg.data, "train"))
    inputs = [train.batch_to_device(next(it), dev) for _ in range(3)]
    state = train.create_train_state(cfg, dev, edge_fusion_fn)
    plain_model = copy.deepcopy(state.model)
    step = train.make_train_step(cfg, state.model, state.optimizer)
    torch.cuda.synchronize()
    bsp.reset_launches()  # the training path starts here
    terms, views = [], []
    for i, x in enumerate(inputs):
        before = bsp.launch_counts()
        with counted_views() as calls:
            state, t = step(state, *x)
        got = _delta(before, bsp.launch_counts())
        if got != want:
            raise AssertionError(f"{path} train step {i}: launches {got}, "
                                 f"expected {want}")
        terms.append(t)
        views.append(calls[0])
    launches = bsp.launch_counts()  # the training path ends here
    # Every path's transposed SpMM takes the staged or the tiled form
    # (bsp.spmm_t_form at V 256 and 512), so no step sorts a source view.
    if any(views):
        raise AssertionError(f"{path}: bsp.source_view ran {views} times in "
                             "the 3 steps; the rule takes no per-edge form")
    log(f"[train {path}] bsp.source_view calls per step: {views}")
    terms = [{k: float(v) for k, v in t.items()} for t in terms]
    plain_opt = train.make_optimizer(cfg_plain, plain_model.parameters())
    plain_state = train.TrainState(plain_model, plain_opt)
    plain_step = train.make_train_step(cfg_plain, plain_model, plain_opt)
    plain_terms = []
    for x in inputs:
        plain_state, t = plain_step(plain_state, *x)
        plain_terms.append({k: float(v) for k, v in t.items()})
    for i, (t, p) in enumerate(zip(terms, plain_terms)):
        if not all(np.isfinite(list(t.values()))):
            raise AssertionError(f"{path} train step {i}: non-finite terms {t}")
        rel = {k: abs(t[k] - p[k]) / max(abs(p[k]), 1e-30) for k in p}
        log(f"[train {path}] step {i}: {json.dumps(t)}; relative difference "
            f"to the plain ops {json.dumps(rel)} (tol {TOL_TRAIN_REL})")
        if sorted(t) != sorted(p) or max(rel.values()) > TOL_TRAIN_REL:
            raise AssertionError(f"{path} train step {i}: kernels and plain "
                                 "ops disagree")
    # Both runs start from the same weights; an Adam step moves an element by
    # at most about its lr (|m_hat| / sqrt(v_hat) <= 1 in the first steps)
    # whatever the gradient's size, so where the true gradient is 0 (the
    # attention's key bias) rounding noise may send the two runs apart by up
    # to 2 x (sum of the lrs). Measured alongside.
    lrs = [train.warmup_cosine_lr(cfg, c) for c in range(3)]
    atol = 2 * sum(lrs)
    with torch.no_grad():
        diffs = sorted(((float((a - b).abs().max()), n) for (n, a), (_, b) in
                        zip(state.model.named_parameters(),
                            plain_model.named_parameters())), reverse=True)
    log(f"[train {path}] parameters after 3 steps, kernels vs plain ops: "
        f"largest differences {[(n, f'{d:.3e}') for d, n in diffs[:3]]} "
        f"(atol {atol:.3e}, lrs {lrs})")
    if diffs[0][0] > atol:
        raise AssertionError(f"parameter {diffs[0][1]} differs by "
                             f"{diffs[0][0]} > {atol}")
    log(f"[train {path}] 3 steps, kernel launches {launches} ({want} per "
        "step)")
    return {"cfg": cfg, "cfg_plain": cfg_plain, "state": state, "step": step,
            "plain_state": plain_state, "plain_step": plain_step,
            "inputs": inputs, "launches": launches, "terms": terms,
            "path": path}


def bound_ms(tensors_read, tensors_written, flops: float) -> tuple:
    """Least time for a function on an H100: each input read once and each
    output written once at the HBM rate, against its f32 work."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (*tensors_read, *tensors_written))
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def fused_attention_bound_ms(q, k, v, ell_src, ell_mask) -> tuple:
    """The fused attention's bound from this run's inputs: the valid edges'
    f32 work is the logits, the exp and the weighted sum."""
    edges = int(ell_mask.sum())
    flops = edges * (2 * q.shape[1] + 1 + 2 * v.shape[1])
    return bound_ms((q, k, v, ell_src, ell_mask), (v,), flops)


def phase_timings(kin: dict, serve: dict, tag: dict) -> dict:
    g, q, k, v = kin["graph"], kin["q"], kin["k"], kin["v"]
    q_s, kf = bsp._scaled(q, k)
    args = (q_s, kf, v, g.ell_src, g.ell_mask)
    kernel = lambda: bsp.fused_attention(*args)  # noqa: E731
    plain = lambda: bsp.fused_attention_reference(*args)  # noqa: E731
    # Yardstick: dense masked SDPA over [V, V] (same function when the
    # graph has no duplicate edges); timed here, never called by the port.
    V = q.shape[0]
    allowed = dense_mask(g)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None, None], k[None, None], v[None, None],
        attn_mask=allowed[None, None])[0, 0]
    ms, plain_ms, library_ms = (device_ms(f) for f in (kernel, plain, sdpa))
    call_ms = {n: cuda_ms(f) for n, f in (("kernel", kernel), ("plain", plain),
                                          ("library", sdpa))}
    has = allowed.any(dim=1)
    sdpa_err = float((sdpa()[has] - bsp.fused_attention(*args)[has]).abs().max())
    bound, bound_by, n_bytes, flops = fused_attention_bound_ms(*args)
    line = {"metric": "kernel_time", "kernel": "bsp_fused_attention",
            "shape": {"V": V, "deg": int(g.ell_src.shape[1]),
                      "dk": int(q.shape[1]), "D": int(v.shape[1]),
                      "values": "float32", "edges": int(g.ell_mask.sum())},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention, dense [V, V] mask",
            "library_max_abs_err_vs_kernel": sdpa_err,
            "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes,
            "flops": flops, "l2": "warm (back-to-back launches)",
            "timing": "ms, plain_ms, library_ms: device time per call "
                      "(profiler); call_ms: back-to-back calls (CUDA events)",
            "call_ms": call_ms, **tag}
    log(json.dumps(line))

    check_path_bodies("attention", predictor_timings(serve, tag, "attention"),
                      "serving profile")
    return {"name": "bsp_fused_attention", "route": "cuda",
            "source": "mrp_gnn_tpu_torch/ops/csrc/bsp_fused_attention.cu",
            "replaces": "mrp_gnn_tpu/ops/pallas_bsp.py:707",
            "max_abs_err": kin["errs"]["torch.float32"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_variant_timings(kin: dict, ek: dict, tag: dict) -> None:
    """The variants of the two kernels redesigned last, in turns: both
    forms of the fused forward at the attention batch (f32 and bf16
    values); both forms of the single SDDMM at the ell path's logits (each
    in order, then in reverse)."""
    g, q, k, v = kin["graph"], kin["q"], kin["k"], kin["v"]
    q_s, kf = bsp._scaled(q, k)
    src, mask = g.ell_src, g.ell_mask
    order = list(bsp.FUSED_FORMS) + list(reversed(bsp.FUSED_FORMS))
    ms = {}
    for dt in (torch.float32, torch.bfloat16):
        vv = v.to(dt)
        turns = {f: [] for f in bsp.FUSED_FORMS}
        for form in order:
            turns[form].append(device_ms(
                lambda: fused_form(form, q_s, kf, vv, src, mask)))
        ms[str(dt)] = turns
    rule = {str(dt): bsp.FUSED_FORMS[bsp.fused_form(4 if dt == torch.float32
                                                    else 8,
                                                    dt == torch.bfloat16)]
            for dt in (torch.float32, torch.bfloat16)}
    log(json.dumps({"metric": "fused_form_ab", "shape": {
        "V": int(src.shape[0]), "deg": int(src.shape[1]),
        "edges": int(mask.sum()), "dk": int(q.shape[1]), "D": int(v.shape[1])},
        "rule": rule, "device_ms": ms,
        "timing": "device time per call (profiler); turns: the forms in "
                  "order, then in reverse", **tag}))
    x = ek["inputs"]
    xs, xm = x["graph"].ell_src, x["graph"].ell_mask
    turns = {form: [] for _, form in FORMS}
    for tiled, form in FORMS + FORMS[::-1]:
        turns[form].append(device_ms(lambda: sddmm_form(tiled, x["q_s"],
                                                        x["kf"], xs, xm)))
    log(json.dumps({"metric": "sddmm_ab", "use": "ell logits, single",
                    "V": int(xs.shape[0]), "deg": int(xs.shape[1]),
                    "edges": int(xm.sum()), "d": int(x["q_s"].shape[1]),
                    "rule": rule_form(x["graph"]), "device_ms": turns,
                    "timing": "device time per call (profiler), f32; turns: "
                              "the forms in order, then in reverse", **tag}))


def predictor_timings(serve: dict, tag: dict, path: str) -> dict:
    """Device-side batch latency (CUDA events), whole-request latency (host
    clock) and a profiler breakdown of the Predictor on one eval batch;
    returns the device ms of each port kernel body in that breakdown."""
    batch = serve["batches"][0]
    pred = Predictor(serve["cfg"], serve["model"], graph=batch["graph"])
    runs = [pred.throughput(iters=20) for _ in range(5)]
    lat = statistics.median(r["batch_latency_s"] for r in runs)
    # A whole request as a user sends it: numpy images in, numpy out (the
    # host-to-device copy and the copy back included), host clock.
    req = []
    for _ in range(20):
        t0 = time.perf_counter()
        pred(batch["images"])
        req.append((time.perf_counter() - t0) * 1e3)
    req.sort()
    views = int(batch["graph"].n_nodes)
    log(json.dumps({"metric": "predictor_batch", "config": serve["cfg"].name,
                    "path": path, "views_per_batch": views,
                    "node_slots": pred.batch_nodes,
                    "batch_latency_ms": lat * 1e3,
                    "views_per_s": views / lat,
                    "runs_latency_ms": [r["batch_latency_s"] * 1e3 for r in runs],
                    "request_ms_median": statistics.median(req),
                    "request_ms_max": req[-1], "requests": len(req), **tag}))
    return profile_device(lambda: pred(batch["images"]), 5,
                          "predictor_profile", "requests", {"path": path, **tag})


def time_kernel(name, src_file, replaces, shape, fn, plain, library,
                lib_name, bound, err, tag, floor=None) -> dict:
    """One kernel at one shape: device time per call (profiler) of the
    kernel, its plain version and the library yardstick, back-to-back CUDA
    events beside them, and its bound. ``floor`` (fn, name): one PyTorch
    call with the kernel's chain of dependent round trips on the same
    tensors, set up outside the clock, whose device time is the kernel's
    floor_ms. Returns its entry of the kernels line."""
    ms, plain_ms, library_ms = (device_ms(f) for f in (fn, plain, library))
    call_ms = {"kernel": cuda_ms(fn), "plain": cuda_ms(plain, reps=7),
               "library": cuda_ms(library)}
    b_ms, b_by, n_bytes, flops = bound
    extra = ({} if floor is None else
             {"floor_ms": device_ms(floor[0]), "floor": floor[1]})
    log(json.dumps({"metric": "kernel_time", "kernel": name,
                    "shape": shape, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library": lib_name,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                    "flops": flops, **extra,
                    "l2": "warm (back-to-back launches)",
                    "timing": "ms, plain_ms, library_ms, floor_ms: device "
                              "time per call (profiler); call_ms: "
                              "back-to-back calls (CUDA events)",
                    "call_ms": call_ms, **tag}))
    return {"name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, **extra}


def dense_mask(g) -> torch.Tensor:
    """The graph's edges as a dense [V, V] mask, for the SDPA yardstick."""
    V = g.max_nodes
    allowed = torch.zeros(V, V, dtype=torch.bool, device=g.ell_src.device)
    rows = torch.arange(V, device=g.ell_src.device)[:, None].expand_as(g.ell_src)
    allowed[rows[g.ell_mask], g.ell_src.long()[g.ell_mask]] = True
    return allowed


def phase_new_kernel_timings(nk: dict, tag: dict) -> list:
    """The high-degree forward at the hideg path's shapes in the rule's form
    and the masked max at the max path's (f32), beside their bounds, plain
    versions and yardsticks; then both forms of the forward in turns, with
    the per-edge form's parts kernel and combine apart and the tiled form's
    kernels by name."""
    x = nk["inputs"]
    g = x["graph"]
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q, k, v = x["q"], x["k"], x["v"]
    q_s, kf = bsp._scaled(q, k)
    V = g.max_nodes
    src_n, mask_n = src_x.reshape(V, -1), mask_x.reshape(V, -1)
    edges = int(mask_x.sum())
    D, dk = v.shape[1], q.shape[1]
    allowed = dense_mask(g)
    args = (q_s, kf, v, src_x, mask_x, xp.rows)
    form = "tiled" if bsp.tiled_form(V, V, src_n.shape[1]) else "per-edge"
    out = [time_kernel(
        "bsp_fused_parts", "mrp_gnn_tpu_torch/ops/csrc/bsp_fused_parts.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:1187",
        {"V": V, "rows": xp.rows, "width": xp.width, "dk": dk, "D": D,
         "edges": edges, "dtype": "float32", "form": form,
         "use": "the hideg forward (bsp.expanded_forward)"},
        lambda: bsp.expanded_forward(*args),
        lambda: bsp.expanded_forward_reference(*args),
        lambda: F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None],
            attn_mask=allowed[None, None])[0, 0],
        "F.scaled_dot_product_attention, dense [V, V] mask (the whole "
        "normalised attention)",
        bound_ms((q_s, kf, v, src_n, mask_n), (torch.empty_like(v),),
                 edges * (2 * dk + 1 + 2 * D)),
        nk["errs"]["bsp_fused_parts"], tag)]
    q_x = q_s.repeat_interleave(xp.rows, dim=0)
    parts = bsp.fused_attention_parts(q_x, kf, v, src_x, mask_x)
    turns = {"per-edge": [], "tiled": []}
    for name in ("per-edge", "tiled", "tiled", "per-edge"):
        turns[name].append(device_ms(
            lambda: forward_form(name == "tiled", *args)))
    kern, _ = profiled(lambda: forward_form(True, *args), 30)
    log(json.dumps({
        "metric": "forward_form_ab", "shape": {
            "V": V, "rows": xp.rows, "width": xp.width, "dk": dk, "D": D,
            "edges": edges, "tile_pairs": len(bsp.tile_pairs(src_n, mask_n)),
            "dtype": "float32"},
        "rule": form, "device_ms": turns,
        "parts_kernel_ms": device_ms(
            lambda: bsp.fused_attention_parts(q_x, kf, v, src_x, mask_x)),
        "xp_combine_ms": device_ms(
            lambda: bsp.xp_combine(*parts, V, xp.rows, v.dtype)),
        "tiled_by_kernel_ms": {e.key[:60]: e.self_device_time_total / 30 / 1e3
                               for e in kern},
        "timing": "device time per call (profiler); per-edge = the parts "
                  "kernel, its q repeat and xp_combine; turns per-edge, "
                  "tiled, tiled, per-edge", **tag}))
    gm, vm = nk["max_graph"], nk["max_values"]
    src, mask = gm.ell_src, gm.ell_mask
    V, deg = src.shape
    edges = int(mask.sum())
    rows = torch.arange(V, device=src.device)[:, None].expand(V, deg)[mask]
    msgs = vm[src[mask].long()]  # gathered outside the timed call
    index = rows[:, None].expand(-1, vm.shape[1]).contiguous()
    base = torch.zeros_like(vm)
    out.append(time_kernel(
        "ell_max", "mrp_gnn_tpu_torch/ops/csrc/ell_max.cu",
        "mrp_gnn_tpu/ops/pallas_ell.py:162",
        {"V": V, "deg": deg, "D": vm.shape[1], "edges": edges,
         "dtype": "float32"},
        lambda: ell.masked_max(vm, src, mask),
        lambda: ell.masked_max_reference(vm, src, mask),
        lambda: base.scatter_reduce(0, index, msgs, "amax",
                                    include_self=False),
        "Tensor.scatter_reduce(amax, include_self=False) of the gathered "
        "[E, D] messages",
        bound_ms((vm, src, mask), (vm,), edges * vm.shape[1]),
        nk["errs"]["ell_max"], tag))
    return out


def phase_block_timings(bk: dict, tag: dict) -> list:
    """The block kernel at the benchmark's shape (bf16, the benchmark's
    type, in the kernels line; f32 logged beside it) against its bound, its
    plain version and SDPA over [S, 1, n, .] with the scene mask; then the
    A/B of the JAX benchmark's block league: the block path with the kernel
    against the einsum route (``reference.block_fused_attention``, where
    dispatch sends the block league), forward and value gradient."""
    x = bk["inputs"]
    g, q, k = x["graph"], x["q"], x["k"]
    n = g.scene_stride
    V = g.max_nodes
    S = V // n
    dk = q.shape[1]
    # SDPA's additive mask of the same function: the scene adjacency and
    # the valid sources, per scene; it scales q by 1/sqrt(dk) itself.
    allowed = ((g.scene_adj > 0)[None] & g.node_mask.reshape(S, 1, n))[:, None]
    out, ab = [], {}
    for dt in (torch.bfloat16, torch.float32):
        v = x["v"].to(dt)
        D = v.shape[1]
        q_s, kk = edge._kernel_inputs(q, k, v)
        args = (q_s, kk, v, g.node_mask, g.scene_adj)
        qb, kb, vb = (t.reshape(S, 1, n, -1) for t in (q.to(dt), kk, v))
        entry = time_kernel(
            "block_attention", "mrp_gnn_tpu_torch/ops/csrc/block_attention.cu",
            "mrp_gnn_tpu/ops/pallas_edge.py:63",
            {"V": V, "scene": n, "dk": dk, "D": D, "dtype": str(dt)},
            lambda: edge.block_attention(*args),
            lambda: edge.block_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                   attn_mask=allowed),
            "F.scaled_dot_product_attention on [S, 1, n, .], scene mask",
            bound_ms((q_s, kk, v), (v,), 2 * V * n * (dk + D)),
            bk["errs"]["block_attention"], tag)
        if dt == torch.bfloat16:
            out.append(entry)

        def grad_of(fn, v=v):
            leaf = v.detach().requires_grad_()
            y = fn(q, k, leaf, g).float()
            return torch.autograd.grad((y * y).sum(), leaf)

        ab[str(dt)] = {
            "forward_kernel_ms": device_ms(
                lambda: edge.block_fused_attention(q, k, v, g)),
            "forward_einsum_ms": device_ms(
                lambda: R.block_fused_attention(q, k, v, g)),
            "value_grad_kernel_ms": device_ms(
                lambda: grad_of(edge.block_fused_attention)),
            "value_grad_einsum_ms": device_ms(
                lambda: grad_of(R.block_fused_attention))}
    log(json.dumps({"metric": "block_league_ab", "shape": {
        "V": V, "scene": n, "dk": dk, "D": x["v"].shape[1]}, "ab": ab,
        "timing": "device time per call (profiler); value_grad: the "
                  "gradient of sum(out ** 2) for the values, as bench.py's "
                  "train chain", **tag}))
    return out


def phase_ell_timings(ek: dict, tag: dict) -> list:
    """The three ELL kernels at the ell path's first train batch (f32)
    beside their bounds, plain versions and library yardsticks."""
    x = ek["inputs"]
    g = x["graph"]
    src, mask = g.ell_src, g.ell_mask
    V, deg = src.shape
    edges = int(mask.sum())
    rows = torch.arange(V, device=src.device)[:, None].expand(V, deg)[mask]
    cols = src[mask].long()
    q_s, kf, v, alpha = (x[n] for n in ("q_s", "kf", "v", "alpha"))
    D, dk = v.shape[1], q_s.shape[1]
    logits = bsp.sddmm_reference(q_s, kf, src, mask)
    shape = {"V": V, "deg": deg, "edges": edges, "dtype": "float32"}
    pattern = _csr(rows, cols, torch.ones(edges, device=src.device), (V, V))
    kT = kf.t().contiguous()
    a_csr = _csr(rows, cols, alpha[mask], (V, V))
    copied = torch.empty_like(logits)
    out = []
    for (name, src_file, replaces, shp, fn, plain, lib, lib_name, bound,
         floor) in (
            ("ell_sddmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_sddmm.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:268",
             {"d": dk, "form": rule_form(g)},
             lambda: ell.sddmm(q_s, kf, src, mask),
             lambda: bsp.sddmm_reference(q_s, kf, src, mask),
             lambda: torch.sparse.sampled_addmm(pattern, q_s, kT, beta=0.0),
             "torch.sparse.sampled_addmm on the deduplicated [V, V] pattern",
             bound_ms((q_s, kf, src, mask), (logits,), 2 * edges * dk),
             None),
            ("ell_softmax", "mrp_gnn_tpu_torch/ops/csrc/ell_softmax.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:355", {},
             lambda: ell.softmax(logits, mask),
             lambda: bsp.masked_softmax(logits, mask),
             lambda: torch.where(mask.any(-1, keepdim=True), torch.softmax(
                 logits.masked_fill(~mask, bsp._NEG), dim=-1), 0.0),
             "Tensor.masked_fill(-1e30), torch.softmax, Tensor.any and "
             "torch.where (0 on a row without a valid slot): four calls; no "
             "single call computes the kernel's function",
             bound_ms((logits, mask), (logits,), 5 * V * deg),
             (lambda: copied.copy_(logits),
              "Tensor.copy_ of the [V, deg] f32 logits (one read, one "
              "write)")),
            ("ell_spmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:47", {"D": D},
             lambda: ell.spmm(alpha, v, src, mask),
             lambda: bsp.spmm_reference(alpha, v, src, mask),
             lambda: torch.sparse.mm(a_csr, v),
             "torch.sparse.mm(CSR of the weights, values)",
             bound_ms((alpha, v, src, mask), (v,), 2 * edges * D), None)):
        out.append(time_kernel(name, src_file, replaces, {**shape, **shp}, fn,
                               plain, lib, lib_name, bound, ek["errs"][name],
                               tag, floor))
    return out


def phase_bsp2_timings(bk2: dict, tag: dict) -> list:
    """The weights kernel at the bsp2 path's first train batch and the dual
    transposed SpMM at the hideg path's node view (f32), beside their
    bounds, plain versions and library yardsticks; then the A/B of the dual
    against two single launches at the hideg and the swarm shapes, in
    turns."""
    x = bk2["inputs"]
    g = x["graph"]
    src, mask = g.ell_src, g.ell_mask
    V, deg = src.shape
    edges = int(mask.sum())
    rows = torch.arange(V, device=src.device)[:, None].expand(V, deg)[mask]
    q_s, kf = x["q_s"], x["kf"]
    dk = q_s.shape[1]
    alpha = bsp.attention_weights(q_s, kf, src, mask)
    pattern = _csr(rows, src[mask].long(), torch.ones(edges, device=src.device),
                   (V, V))
    kT = kf.t().contiguous()
    filled = bsp.sddmm_reference(q_s, kf, src, mask).masked_fill(~mask,
                                                                 bsp._NEG)
    first = src.long() * dk  # each slot's key row start, for the floor
    out = [time_kernel(
        "bsp_weights", "mrp_gnn_tpu_torch/ops/csrc/bsp_weights.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:118",
        {"V": V, "deg": deg, "dk": dk, "edges": edges, "dtype": "float32"},
        lambda: bsp.attention_weights(q_s, kf, src, mask),
        lambda: bsp.attention_weights_reference(q_s, kf, src, mask),
        lambda: (torch.sparse.sampled_addmm(pattern, q_s, kT, beta=0.0),
                 torch.softmax(filled, dim=-1)),
        "torch.sparse.sampled_addmm on the deduplicated [V, V] pattern, then "
        "torch.softmax of the [V, deg] logits filled with -1e30 (two calls)",
        bound_ms((q_s, kf, src, mask), (alpha,), edges * (2 * dk + 1)),
        bk2["errs"]["bsp_weights"], tag,
        (lambda: torch.take(kf, first),
         "torch.take(k, ell_src * dk) (an index read, a dependent gather of "
         "each slot's key row, a [V, deg] write)"))]

    def operands(xx):
        b = backward_view(xx)
        srcb, maskb = b["src"], b["mask"]
        Vx, degx = srcb.shape
        r = torch.arange(Vx, device=srcb.device)[:, None].expand(Vx, degx)[maskb]
        c = srcb[maskb].long()
        b["csr"] = [_csr(c, r, w[maskb], (b["V"], Vx))
                    for w in (b["alpha"], b["dlog"])]
        b["edges"] = int(maskb.sum())
        return b

    def dual(b):
        return lambda: bsp.spmm_t2(b["alpha"], b["ct"], b["dlog"], b["q_s"],
                                   b["src"], b["mask"], b["V"])

    def separate(b):
        return lambda: (
            bsp.spmm_t(b["alpha"], b["ct"], b["src"], b["mask"], b["V"]),
            bsp.spmm_t(b["dlog"], b["q_s"], b["src"], b["mask"], b["V"]))

    h = operands(bk2["hideg"])
    D = h["ct"].shape[1]
    dv_out = torch.empty(h["V"], D, device=src.device)
    dk_out = torch.empty(h["V"], dk, device=src.device)
    out.append(time_kernel(
        "bsp_spmm_t2", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm_t.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:537",
        {"V": h["V"], "deg": h["src"].shape[1], "D1": D, "D2": dk,
         "edges": h["edges"], "dtype": "float32", "form": spmm_t_rule(
             h["src"], h["mask"], h["V"]),
         "use": "dvalues and dk of the hideg backward, node view"},
        dual(h),
        lambda: bsp.spmm_t2_reference(h["alpha"], h["ct"], h["dlog"],
                                      h["q_s"], h["src"], h["mask"], h["V"]),
        lambda: (torch.sparse.mm(h["csr"][0], h["ct"]),
                 torch.sparse.mm(h["csr"][1], h["q_s"])),
        "torch.sparse.mm(CSR of alpha transposed, cotangent) and "
        "torch.sparse.mm(CSR of dlog transposed, q_s) (two calls)",
        bound_ms((h["alpha"], h["ct"], h["dlog"], h["q_s"], h["src"],
                  h["mask"]), (dv_out, dk_out), 2 * h["edges"] * (D + dk)),
        bk2["errs"]["bsp_spmm_t2"], tag))

    ab = {}
    for label, b in (("hideg", h), ("bsp2", operands(x))):
        times = {"dual": [], "separate": []}
        for name in ("separate", "dual", "dual", "separate"):
            fn = dual(b) if name == "dual" else separate(b)
            times[name].append(device_ms(fn))
        ab[label] = {"V": b["V"], "rows": b["src"].shape[0],
                     "width": b["src"].shape[1], "D1": b["ct"].shape[1],
                     "D2": dk, "edges": b["edges"], "device_ms": times}
    log(json.dumps({"metric": "spmm_t2_ab", "kernels": ab,
                    "timing": "device time per call (profiler), f32, dual = "
                              "one bsp_spmm_t2 launch, separate = two "
                              "bsp_spmm_t launches; turns "
                              "separate, dual, dual, separate", **tag}))
    return out


def _csr(rows, cols, vals, shape):
    """A CSR matrix for the library yardsticks (duplicate entries summed)."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def phase_train_kernel_timings(tk: dict, tag: dict) -> list:
    """Each backward kernel at the training step's shapes (f32), beside its
    bound, its plain version and a one-call library yardstick."""
    x = tk["inputs"]
    g = x["graph"]
    src, mask = g.ell_src, g.ell_mask
    V, deg = src.shape
    edges = int(mask.sum())
    rows = torch.arange(V, device=src.device)[:, None].expand(V, deg)[mask]
    cols = src[mask].long()
    q_s, kf, v, ct, alpha, dlog = (x[n] for n in ("q_s", "kf", "v", "ct",
                                                  "alpha", "dlog"))
    D, dk = v.shape[1], q_s.shape[1]
    out = []

    def record(*args):
        out.append(time_kernel(*args, tk["errs"][args[0]], tag))

    # SDDMM, dual form: (q_s, k) and (g, values), as the backward calls it.
    pattern = _csr(rows, cols, torch.ones(edges, device=src.device), (V, V))
    kT, vT = kf.t().contiguous(), v.t().contiguous()
    record("bsp_sddmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_sddmm.cu",
           "mrp_gnn_tpu/ops/pallas_bsp.py:377",
           {"V": V, "deg": deg, "d1": dk, "d2": D, "edges": edges,
            "form": f"dual, {rule_form(g)}", "dtype": "float32"},
           lambda: bsp.sddmm(q_s, kf, src, mask, ct, v),
           lambda: (bsp.sddmm_reference(q_s, kf, src, mask),
                    bsp.sddmm_reference(ct, v, src, mask)),
           lambda: (torch.sparse.sampled_addmm(pattern, q_s, kT, beta=0.0),
                    torch.sparse.sampled_addmm(pattern, ct, vT, beta=0.0)),
           "torch.sparse.sampled_addmm x2 on the deduplicated [V, V] pattern",
           bound_ms((q_s, kf, ct, v, src, mask),
                    (alpha, dlog), 2 * edges * (dk + D)))  # 2 x [V, deg] f32 out
    # SpMM as dq = SpMM(dlog, k).
    w_csr = _csr(rows, cols, dlog[mask], (V, V))
    record("bsp_spmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm.cu",
           "mrp_gnn_tpu/ops/pallas_bsp.py:237",
           {"V": V, "deg": deg, "D": dk, "edges": edges, "use": "dq",
            "dtype": "float32"},
           lambda: bsp.spmm(dlog, kf, src, mask),
           lambda: bsp.spmm_reference(dlog, kf, src, mask),
           lambda: torch.sparse.mm(w_csr, kf), "torch.sparse.mm(CSR of w, x)",
           bound_ms((dlog, kf, src, mask), (kf,), 2 * edges * dk))
    # Transposed SpMM as dvalues = SpMM_T(alpha, g), as the two-kernel
    # attention's SpMM backward (the bsp2 path) calls it at these shapes;
    # the dk call and the view build are logged beside it.
    wt_csr = _csr(cols, rows, alpha[mask], (V, V))
    record("bsp_spmm_t", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm_t.cu",
           "mrp_gnn_tpu/ops/pallas_bsp.py:459",
           {"V": V, "deg": deg, "D": D, "edges": edges, "use": "dvalues",
            "form": spmm_t_rule(src, mask, V), "dtype": "float32"},
           lambda: bsp.spmm_t(alpha, ct, src, mask, V),
           lambda: bsp.spmm_t_reference(alpha, ct, src, mask, V),
           lambda: torch.sparse.mm(wt_csr, ct),
           "torch.sparse.mm(CSR of w transposed, x)",
           bound_ms((alpha, ct, src, mask), (ct,), 2 * edges * D))
    leaves = [t.detach().requires_grad_() for t in (q_s, kf, v)]
    parts = {
        "spmm_t_dk": lambda: bsp.spmm_t(dlog, q_s, src, mask, V),
        "source_view": lambda: bsp.source_view(src, mask, V),
        "backward": lambda: bsp.fused_attention_backward(q_s, kf, v, src,
                                                         mask, ct),
        "backward_plain_autograd": lambda: torch.autograd.grad(
            bsp.fused_attention_reference(*leaves, src, mask), leaves, ct)}
    log(json.dumps({"metric": "attention_backward",
                    "device_ms": {n: device_ms(f) for n, f in parts.items()},
                    "call_ms": {n: cuda_ms(f, reps=7) for n, f in parts.items()},
                    "shape": {"V": V, "deg": deg, "dk": dk, "D": D,
                              "edges": edges}, **tag}))
    return out


def phase_train_timings(tr: dict, tag: dict, loop: bool = True,
                        inner: int = 20) -> dict:
    """Device-side train step (one fixed batch on the card, CUDA events),
    kernels and plain ops in turns; peak memory; with ``loop``, one whole
    step through ``train()`` by host clock; a profiler breakdown over 5
    steps, whose device ms of each port kernel body it returns."""
    x = tr["inputs"][0]
    path = tr["path"]
    kernels = lambda: tr["step"](tr["state"], *x)  # noqa: E731
    plain = lambda: tr["plain_step"](tr["plain_state"], *x)  # noqa: E731
    times = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "plain", "kernels"):
        fn = kernels if name == "kernels" else plain
        times[name].append(cuda_ms(fn, reps=3, inner=inner, warmup=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        kernels()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    V = int(x[3].n_nodes)
    step_ms = statistics.mean(times["kernels"])
    log(json.dumps({"metric": "train_step", "config": tr["cfg"].name,
                    "path": path, "views_per_step": V,
                    "node_slots": x[3].max_nodes,
                    "device_step_ms_kernels": times["kernels"],
                    "device_step_ms_plain": times["plain"],
                    "views_per_s_kernels": V / step_ms * 1e3,
                    "views_per_s_plain": V / statistics.mean(times["plain"]) * 1e3,
                    "peak_memory_bytes_kernels": peak,
                    "timing": f"CUDA events, median of 3 x {inner} steps per "
                              "turn; turns kernels, plain, plain, kernels",
                    **tag}))
    if loop:
        cfg = tr["cfg"].replace(train=dataclasses.replace(tr["cfg"].train,
                                                          log_every=1))
        _, records = train.train(cfg, num_steps=LOOP_STEPS,
                                 device=x[0].device)
        log(json.dumps({"metric": "train_loop", "config": cfg.name,
                        "path": path, "renderer": cfg.data.renderer,
                        "graph_builder": cfg.data.graph_builder,
                        "step_time_s": [r["step_time_s"] for r in records],
                        "views_per_s": [r["views_per_s"] for r in records],
                        "edges_per_s": [r["edges_per_s"] for r in records],
                        "timing": "host clock between steps of train(), the "
                                  "device synchronised by reading the terms, "
                                  "the next batch's render and copy included; "
                                  "step 1 includes first-call costs", **tag}))
    return profile_device(kernels, 5, "train_profile", "steps",
                          {"path": path, **tag})


def profile_device(fn, n: int, metric: str, unit: str, tag: dict) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (:func:`profiled`),
    and the share of the window with no device work (host clock, profiler
    on); returns the device ms of each port kernel body."""
    events, wall_us = profiled(fn, n)
    kern = sorted(((e.key, e.self_device_time_total, e.count) for e in events),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    ours = {}
    for key, t, _ in kern:
        for body in PORT_KERNEL_BODIES:
            if f"::{body}<" in key or f"::{body}(" in key:
                ours[body] = ours.get(body, 0.0) + t / 1e3
    log(json.dumps({"metric": metric, unit: n,
                    "window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1 - busy / wall_us,
                    "port_kernels_ms": ours,
                    "top_kernels": [{"name": k[:90], "ms": t / 1e3,
                                     "share": t / busy, "calls": c}
                                    for k, t, c in kern[:16]], **tag}))
    return ours


# The kernel bodies that a path's profiles must show, and those they must not:
# the fused forward's vector form on the attention path, the per-edge
# SDDMM's narrow kernel on the ell path, the rule's tiled form of the
# high-degree forward, the block kernel's bucket for the robot teams of the
# block path, the SpMM's vector form for the D 8192 sums of the ell, mean
# and bsp2 paths, the masked max's kernel on the max path, the softmax's
# register form on the ell path and the weights' rows form on bsp2.
# TRAIN_BODIES: what a path's train profile must show besides (bsp2: dq's
# SpMM at D 64 in the row form; the staged transposed SpMM wherever a
# transposed SpMM runs at the swarm's ELL width); no train profile may show
# the per-edge transposed SpMM's bodies (TRAIN_NOT_RUN), which the rule
# takes on no path.
PATH_BODIES = {
    "attention": (("fused_vec_kernel",), ("fused_attention_kernel",)),
    "ell": (("sddmm_rows_kernel", "ell_softmax_register_kernel",
             "spmm_vec_kernel"),
            ("sddmm_wide_kernel", "ell_softmax_kernel", "spmm_kernel")),
    "hideg": (("fused_parts_weights_kernel", "fused_parts_tiled_kernel"),
              ("fused_parts_kernel",)),
    "mean": (("spmm_vec_kernel",), ("spmm_kernel",)),
    "max": (("ell_max_kernel",), ()),
    "block": (("block_attention_f32_kernel",), ("block_attention_kernel",)),
    "bsp2": (("weights_rows_kernel", "spmm_vec_kernel"), ("weights_kernel",)),
}


TRAIN_BODIES = {"attention": ("sddmm_wide_kernel", "spmm_t_staged_kernel"),
                "mean": ("spmm_t_staged_kernel",),
                "bsp2": ("spmm_kernel", "spmm_t_staged_kernel")}
TRAIN_NOT_RUN = ("spmm_t_kernel", "spmm_t2_kernel")


def check_path_bodies(path: str, ours: dict, where: str) -> None:
    """The path ran the kernel bodies of PATH_BODIES (and of TRAIN_BODIES
    in its train profile, and none of TRAIN_NOT_RUN)."""
    run, not_run = PATH_BODIES[path]
    if where == "train profile":
        run = run + TRAIN_BODIES.get(path, ())
        not_run = not_run + TRAIN_NOT_RUN
    if not (all(b in ours for b in run) and not any(b in ours for b in not_run)):
        raise AssertionError(f"the {path} path's {where} ran {sorted(ours)}, "
                             f"expected {run} and none of {not_run}")
    log(f"[timing] the {path} path's {where} ran {run}")


LIFECYCLE_STEPS = 4  # the lifecycle phase's run: eval and checkpoint every 2


def _train_terms(records, steps) -> list:
    """The loss terms and grad norms of the train records at ``steps``."""
    timing = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")
    return [{k: v for k, v in r.items() if k not in timing} for r in records
            if "total" in r and r["step"] in steps]


def phase_lifecycle(dev, tag: dict) -> dict:
    """A user's path around a run on ``dynamic_swarm``: train with periodic
    eval and checkpoints, resume, evaluate a checkpoint, serve from it,
    benchmark. The entry points pin deterministic cuDNN and IEEE f32
    (``utils.platform.reference_numerics``; the port's kernels sum in a
    fixed order), so the resumed run is held to the straight run bit for
    bit with no setting made here."""
    t_phase = time.perf_counter()
    cfg0 = swarm_config()
    m = cfg0.model
    h = m.num_fusion_layers * m.attention_heads
    eval_batches = cfg0.data.num_eval_scenes // cfg0.data.scenes_per_batch
    n_evals = LIFECYCLE_STEPS // 2
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("straight", "resumed",
                                                  "saved")}

        def run_cfg(d):
            return cfg0.replace(train=dataclasses.replace(
                cfg0.train, log_every=1, eval_every=2, checkpoint_every=2,
                checkpoint_dir=d))

        cfg = run_cfg(dirs["straight"])
        # 1. train with eval and checkpoints
        torch.cuda.synchronize()
        bsp.reset_launches()  # the lifecycle's training path starts here
        t0 = time.perf_counter()
        straight, recs = train.train(cfg, num_steps=LIFECYCLE_STEPS,
                                     device=dev)
        times["train_s"] = time.perf_counter() - t0
        launches = bsp.launch_counts()  # ... and ends here
        per_step = {"bsp_fused_attention": h, "bsp_sddmm": h, "bsp_spmm": h,
                    "bsp_spmm_t2": h}
        want = _expected({k: v * LIFECYCLE_STEPS for k, v in per_step.items()})
        want["bsp_fused_attention"] += h * eval_batches * n_evals
        if launches != want:
            raise AssertionError(f"train with eval: launches {launches}, "
                                 f"expected {want}")
        evals = [r for r in recs if "eval_rmse" in r]
        best = [r for r in recs if "best_eval_rmse" in r]
        if ([e["step"] for e in evals] != [2, 4]
                or any(e["eval_eval_batches"] != eval_batches for e in evals)
                or len(best) != 1 or best[0]["best_eval_rmse"] != min(
                    e["eval_rmse"] for e in evals)):
            raise AssertionError(f"eval records {evals}, best {best}")
        listed = sorted(os.listdir(dirs["straight"]))
        if listed != ["ckpt_2.pt", "ckpt_4.pt", "config.json"]:
            raise AssertionError(f"checkpoint directory holds {listed}")
        log(f"[lifecycle] trained {LIFECYCLE_STEPS} steps in "
            f"{times['train_s']:.2f} s: evals {json.dumps(evals)}, "
            f"{json.dumps(best[0])}, {listed}, launches {launches}")

        # 2. resume from the step-2 checkpoint alone
        os.makedirs(dirs["resumed"])
        shutil.copy(os.path.join(dirs["straight"], "ckpt_2.pt"),
                    dirs["resumed"])
        t0 = time.perf_counter()
        resumed, rest = train.train(run_cfg(dirs["resumed"]),
                                    num_steps=LIFECYCLE_STEPS, device=dev)
        times["resume_s"] = time.perf_counter() - t0
        if rest[0]["step"] != 3:
            raise AssertionError(f"resumed at step {rest[0]['step']}, not 3")
        steps = (3, 4)
        got, ref = _train_terms(rest, steps), _train_terms(recs, steps)
        if got != ref or rest[-1] != best[0]:
            raise AssertionError(f"resumed run {got}, {rest[-1]}; straight "
                                 f"run {ref}, {best[0]}")
        diffs = [n for (n, a), (_, b) in zip(straight.model.named_parameters(),
                                             resumed.model.named_parameters())
                 if not torch.equal(a, b)]
        if diffs:
            raise AssertionError(f"resumed parameters differ: {diffs[:5]}")
        log(f"[lifecycle] resumed at step 3 in {times['resume_s']:.2f} s: "
            f"losses at steps 3 and 4, the best eval and every parameter "
            "bit for bit equal to the straight run (the entry points' pin)")

        # 3. evaluate the checkpoint, kernels against the plain ops
        state = train.create_train_state(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(dirs["straight"]).restore_latest(state)
        torch.cuda.synchronize()
        times["restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        CheckpointManager(dirs["saved"]).save(state.step, state)
        times["save_s"] = time.perf_counter() - t0
        results = {}
        for name, c in (("kernels", cfg), ("plain", _plain(cfg))):
            before = bsp.launch_counts()
            t0 = time.perf_counter()
            results[name] = evaluate(c, state.model)
            times[f"eval_s_per_batch_{name}"] = (
                (time.perf_counter() - t0) / results[name]["eval_batches"])
            got = _delta(before, bsp.launch_counts())
            want = _expected({"bsp_fused_attention": h * eval_batches}
                             if name == "kernels" else {})
            if got != want:
                raise AssertionError(f"evaluate ({name}): launches {got}, "
                                     f"expected {want}")
        k, p = results["kernels"], results["plain"]
        errs = {x: abs(k[x] - p[x]) / abs(p[x]) for x in ("rmse", "abs_rel")}
        errs.update({x: abs(k[x] - p[x]) for x in
                     ("delta1", "delta2", "delta3", "miou")})
        log(f"[lifecycle] evaluate, step {state.step}: kernels "
            f"{json.dumps(k)}; plain ops {json.dumps(p)}; differences "
            f"{json.dumps(errs)} (rmse, abs_rel relative, tol {TOL_EVAL_REL}; "
            f"the others absolute, tol {TOL_EVAL_ABS})")
        if (k["eval_batches"] != eval_batches
                or max(errs["rmse"], errs["abs_rel"]) > TOL_EVAL_REL
                or max(errs[x] for x in ("delta1", "delta2", "delta3",
                                         "miou")) > TOL_EVAL_ABS):
            raise AssertionError("evaluate: the kernels and the plain ops "
                                 "disagree")

        # 4. serve from the checkpoint
        b = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(cfg, dirs["straight"],
                                         graph=b["graph"])
        times["from_checkpoint_s"] = time.perf_counter() - t0
        before = bsp.launch_counts()
        out = pred(b["images"])
        got = _delta(before, bsp.launch_counts())
        if got != _expected({"bsp_fused_attention": h}):
            raise AssertionError(f"from_checkpoint request: launches {got}")
        ref = Predictor(cfg, straight.model, graph=b["graph"])(b["images"])
        err = float(np.abs(out["depth"] - ref["depth"]).max())
        if err > TOL_CKPT_SERVE_M or not np.array_equal(out["seg"], ref["seg"]):
            raise AssertionError(f"from_checkpoint: depth differs by {err} m "
                                 "or seg differs")
        log(f"[lifecycle] Predictor.from_checkpoint: depth within {err:.3e} m "
            f"(tol {TOL_CKPT_SERVE_M}) of the model in memory, seg equal")

    # 5. the benchmark's single-device benches, as a user runs them
    t0 = time.perf_counter()
    records = []
    for argv in (["--what", "fusion"], ["--what", "train_edge"],
                 ["--what", "train", "--config", "dynamic_swarm"],
                 ["--what", "mfu", "--config", "dynamic_swarm"]):
        recs = benchmark.main(argv)
        if not recs:
            raise AssertionError(f"benchmark {argv} gave no record")
        records += recs
    times["benchmark_s"] = time.perf_counter() - t0
    for r in records:
        if r["backend"] != dev.type or not all(
                np.isfinite(v) for v in r.values()
                if isinstance(v, float)):
            raise AssertionError(f"benchmark record {r}")
        path = r.get("path", "")
        if path.startswith("pallas_") and not r["launches"]:
            raise AssertionError(f"{r['bench']} {path} launched no kernel")
        if path.startswith("xla_") and r["launches"]:
            raise AssertionError(f"{r['bench']} {path} launched {r['launches']}")
    times["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"metric": "lifecycle", "config": cfg0.name,
                    "times": times,
                    "timing": "host clock; eval per batch includes the numpy "
                              "render of its scenes", **tag}))
    return times


def _outputs_agree(got: dict, want: dict, where: str) -> dict:
    """Bit equality of two output dicts, or else depth within
    TOL_EXPORT_DEPTH_M and seg equal on TOL_EXPORT_SEG of the pixels;
    returns the differences."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{where}: outputs {sorted(got)}, expected "
                             f"{sorted(want)}")
    exact = all(np.array_equal(got[k], want[k]) for k in want)
    err = float(np.abs(got["depth"].astype(np.float64) - want["depth"]).max())
    agree = float((got["seg"] == want["seg"]).mean())
    if not exact and (err > TOL_EXPORT_DEPTH_M or agree < TOL_EXPORT_SEG):
        raise AssertionError(f"{where}: depth max abs err {err} m, seg "
                             f"agreement {agree}")
    return {"bit_equal": exact, "depth_max_abs_err_m": err,
            "seg_agreement": agree}


_FRESH_PROCESS = """
import json, sys
import numpy as np
from mrp_gnn_tpu_torch.ops import bsp
from mrp_gnn_tpu_torch.serving import load_exported
infer = load_exported(sys.argv[1])  # it pins the numerics itself
images = np.load(sys.argv[2])
bsp.reset_launches()
outs = [infer(x) for x in images]
np.savez(sys.argv[3], depth=np.stack([o["depth"] for o in outs]),
         seg=np.stack([o["seg"] for o in outs]))
print(json.dumps({"launches": bsp.launch_counts(), "models_imported": sorted(
    m for m in sys.modules if m.startswith("mrp_gnn_tpu_torch.models"))}))
"""


def phase_export(dev, serve: dict, per_request: dict, tag: dict) -> dict:
    """The portable export of each path's Predictor (the serving phase's
    model and first eval batch's graph, so the path's kernels are on it):
    export and save, load on the card, three requests with exact launches
    held to the Predictor's outputs, the attention artifact also in a fresh
    process that never imports the model code, a profile of the artifact's
    requests with the path's kernel bodies, and the artifact's request and
    the Predictor's timed in turns with CUDA events."""
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        for path, op in EXPORT_OPS.items():
            s = serve[path]
            pred = Predictor(s["cfg"], s["model"],
                             graph=s["batches"][0]["graph"])
            art = os.path.join(tmp, f"{path}.pt2")
            t0 = time.perf_counter()
            meta = export_predictor(pred, art)
            export_s = time.perf_counter() - t0
            if meta["route"] != "kernels" or meta["ops"] != [
                    f"mrp_gnn_torch::{op}"]:
                raise AssertionError(f"{path} artifact: {meta}")
            t0 = time.perf_counter()
            infer = load_exported(art)
            load_s = time.perf_counter() - t0
            want = _expected(per_request[path])
            requests = [b["images"] for b in s["batches"]]
            torch.cuda.synchronize()
            bsp.reset_launches()  # the export path starts here
            outs = []
            for i, images in enumerate(requests):
                before = bsp.launch_counts()
                outs.append(infer(images))
                got = _delta(before, bsp.launch_counts())
                if got != want:
                    raise AssertionError(f"{path} artifact request {i}: "
                                         f"launches {got}, expected {want}")
            launches = bsp.launch_counts()  # the export path ends here
            diffs = [_outputs_agree(o, pred(x), f"{path} request {i}")
                     for i, (o, x) in enumerate(zip(outs, requests))]
            fresh = None
            if path == "attention":
                fresh = _fresh_process(art, requests, outs, want, tmp)
            images = torch.from_numpy(requests[0]).to(dev)

            def artifact():
                with torch.inference_mode():
                    infer.module(images)

            turns = {"artifact_device": [], "predictor_device": [],
                     "artifact_request": [], "predictor_request": []}
            for who in ("artifact", "predictor", "predictor", "artifact"):
                fwd = artifact if who == "artifact" else (
                    lambda: pred.forward(images))
                req = infer if who == "artifact" else pred
                turns[f"{who}_device"].append(cuda_ms(fwd, reps=5, inner=10,
                                                      warmup=2))
                turns[f"{who}_request"].append(cuda_ms(
                    lambda: req(requests[0]), reps=5, inner=5, warmup=1))
            log(json.dumps({"metric": "export", "config": s["cfg"].name,
                            "path": path, "ops": meta["ops"],
                            "export_s": export_s, "load_s": load_s,
                            "launches": launches, "vs_predictor": diffs,
                            "fresh_process": fresh, "ms": turns,
                            "timing": "CUDA events, median of 5 x 10 "
                                      "device-side forwards (images on the "
                                      "card) and of 5 x 5 whole requests "
                                      "(numpy in and out); turns artifact, "
                                      "predictor, predictor, artifact",
                            **tag}))
            ours = profile_device(lambda: infer(requests[0]), 5,
                                  "export_profile", "requests",
                                  {"path": path, **tag})
            check_path_bodies(path, ours, "export profile")
            res[path] = {"launches": launches, "ms": turns}
    return res


def _fresh_process(art: str, requests, outs, want: dict, tmp: str) -> dict:
    """Serve ``requests`` from the artifact in a new process that imports
    the op library and not the model code; its launches and outputs must
    be this process's."""
    images = os.path.join(tmp, "requests.npy")
    got_path = os.path.join(tmp, "fresh_outputs.npz")
    np.save(images, np.stack(requests))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _FRESH_PROCESS, art, images,
                           got_path], capture_output=True, text=True,
                          env=env, cwd=tmp, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the fresh process failed:\n{proc.stderr}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    expect = {k: v * len(requests) for k, v in want.items()}
    if rec["launches"] != expect or rec["models_imported"]:
        raise AssertionError(f"the fresh process: {rec}, expected launches "
                             f"{expect} and no model module")
    got = np.load(got_path)
    for i, o in enumerate(outs):
        _outputs_agree({"depth": got["depth"][i], "seg": got["seg"][i]}, o,
                       f"fresh process request {i}")
    log(f"[export] the attention artifact served {len(requests)} requests "
        f"in a fresh process in {seconds:.2f} s (start-up included), "
        f"launches {expect}, no model module imported, outputs as here")
    return {"seconds": seconds, "launches": rec["launches"]}


def _graph_tensors(g) -> list:
    out = []
    g.apply(lambda t: out.append(t) or t)
    return out


def _assert_same_batch(got: dict, want: dict, where: str) -> None:
    for k in ("images", "depth", "seg"):
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f"{where}: {k} differs")
    a, b = _graph_tensors(got["graph"]), _graph_tensors(want["graph"])
    if len(a) != len(b) or not all(torch.equal(x.cpu(), y)
                                   for x, y in zip(a, b)):
        raise AssertionError(f"{where}: the graph differs")


def _loop_busy_ms(fn) -> tuple:
    """(fn's result, device busy ms while it ran): the profiler, device
    activity only, after a short traced warm-up (a trace loses its first
    calls' activity otherwise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(10):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")) / 1e3
    if busy <= 0:
        raise AssertionError("the profiler saw no device activity in the loop")
    return out, busy


def phase_data(dev, tag: dict) -> dict:
    """The data layer on the card, on ``dynamic_swarm`` at full width with
    the native renderer and graph builder: placed batches read back equal
    to the host batches; the worker loader's unshuffled batches bit for bit
    the builtin pipeline's; then ``train()`` for LOOP_STEPS steps in four
    runs (a: the builtin loader, each batch placed on the card by the
    producer thread; b: the worker loader with DATA_WORKERS processes; c:
    augmentation; d: DISK_SCENES scene folders written by ``export_scenes``
    (npy), with mobility 0, since folder records carry no robot positions:
    a static radius graph, which dispatch serves by the dense plain ops),
    each with finite losses, its step times (host clock) and, from a second
    run under the profiler, the device's idle share over the loop."""
    cfg0 = native_swarm_config()
    cfg0 = cfg0.replace(train=dataclasses.replace(cfg0.train, log_every=1))
    host = make_train_iterator(cfg0.data)
    placed = TransformIterator(make_train_iterator(cfg0.data),
                               train.BatchPlacer(dev))
    try:
        for i in range(3):
            want = next(host)
            images, depth, seg, graph = train.batch_to_device(next(placed),
                                                              dev)
            _assert_same_batch({"images": images.cpu(), "depth": depth.cpu(),
                                "seg": seg.cpu(), "graph": graph}, want,
                               f"placed batch {i}")
    finally:
        host.close()
        placed.close()
    log("[data] 3 batches placed on the card by the producer thread read "
        "back equal to the host batches")
    t0 = time.perf_counter()
    workers = make_grain_iterator(cfg0.data, "train", shuffle=False,
                                  workers=DATA_WORKERS)
    try:
        builtin = iter(make_dataset(cfg0.data, "train", shuffle=False))
        for i in range(3):
            _assert_same_batch(next(workers), next(builtin),
                               f"worker loader batch {i}")
    finally:
        workers.close()
    log(f"[data] the worker loader's first 3 unshuffled batches "
        f"({DATA_WORKERS} worker processes, {time.perf_counter() - t0:.2f} s "
        "with their start-up) are the builtin pipeline's, bit for bit")
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scenes_") as tmp:
        export_scenes(cfg0.data, tmp, "train", num_scenes=DISK_SCENES,
                      fmt="npy")
        runs = {
            "builtin": cfg0.data,
            "grain": dataclasses.replace(cfg0.data, loader="grain",
                                         loader_workers=DATA_WORKERS),
            "augment": dataclasses.replace(cfg0.data, augment=True),
            "disk": dataclasses.replace(cfg0.data, dataset_root=tmp,
                                        mobility=0.0),
        }
        for name, data in runs.items():
            cfg = cfg0.replace(data=data)
            t0 = time.perf_counter()
            _, records = train.train(cfg, num_steps=LOOP_STEPS, device=dev)
            run_s = time.perf_counter() - t0
            (_, prof_records), busy = _loop_busy_ms(
                lambda: train.train(cfg, num_steps=LOOP_STEPS, device=dev))
            for recs in (records, prof_records):
                if len(recs) != LOOP_STEPS or not all(
                        np.isfinite(r["total"]) for r in recs):
                    raise AssertionError(f"data run {name}: {recs}")
            steps = [r["step_time_s"] for r in records]
            loop_s = prof_records[-1]["wall_s"]
            res[name] = {"step_time_s": steps,
                         "median_step_s": statistics.median(steps[1:]),
                         "device_idle_share": 1 - busy / 1e3 / loop_s}
            log(json.dumps({
                "metric": "data_loop", "run": name, "config": cfg.name,
                "loader": data.loader, "workers": data.loader_workers,
                "augment": data.augment, "dataset_root": bool(
                    data.dataset_root), "renderer": data.renderer,
                "graph_builder": data.graph_builder, "steps": LOOP_STEPS,
                "run_s": run_s, "losses": [r["total"] for r in records],
                **res[name], "device_busy_ms_profiled_run": busy,
                "loop_s_profiled_run": loop_s,
                "timing": "step_time_s: host clock between steps of train() "
                          "(step 1 includes first-call costs; the median "
                          "leaves it out); device idle share: 1 - device "
                          "busy time over the whole profiled train() call "
                          "(device activity only) / its loop's host clock",
                **tag}))
    return res


# --- the numerics phase: the pin at every entry point, and checked ----------

NUMERICS_STEPS = 4     # the straight run; the CLI trains 2, then resumes to 4
NUMERICS_REQUESTS = 3  # eval batches served in the fresh serving process
NUMERICS_TIMEOUT_S = 600
# The states timed against each other outside the entry points: (matmul
# TF32, cuDNN TF32, cuDNN deterministic); benchmark off in all three.
NUMERICS_STATES = {"a_pin": (False, False, True),
                   "b_no_tf32": (False, False, False),
                   "c_torch_defaults": (False, True, False)}
_NUMERICS_SWITCHES = (("cuda", "matmul"), ("cudnn", "conv"), ("cudnn", "rnn"))

_FRESH_SERVING = """
import json, sys
import numpy as np
import torch
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.serving import Predictor, load_exported
ckpt, art, requests, out = sys.argv[1:5]
b = torch.backends
flags = {"matmul": b.cuda.matmul.fp32_precision,
         "conv": b.cudnn.conv.fp32_precision,
         "deterministic": b.cudnn.deterministic}  # torch's own: none set here
cfg = get_config("dynamic_swarm")
graph = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))["graph"]
pred = Predictor.from_checkpoint(cfg, ckpt, graph=graph)
infer = load_exported(art)
images = np.load(requests)
outs = {"predictor": [pred(x) for x in images],
        "artifact": [infer(x) for x in images]}
np.savez(out, **{f"{who}_{k}": np.stack([o[k] for o in outs[who]])
                 for who in outs for k in ("depth", "seg")})
print(json.dumps({"flags": flags}))
"""


def numerics_config(checkpoint_dir: str = ""):
    """``dynamic_swarm`` as its CLI runs it (native host side), logging
    every step, for NUMERICS_STEPS steps (the warmup's 100 steps make the
    schedule the same for a run of 2)."""
    cfg = get_config("dynamic_swarm")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, steps=NUMERICS_STEPS, log_every=1,
        checkpoint_dir=checkpoint_dir))


def _numerics() -> tuple:
    c = torch.backends.cudnn
    return ((torch.get_float32_matmul_precision(),)
            + tuple(getattr(getattr(torch.backends, b), op).fp32_precision
                    for b, op in _NUMERICS_SWITCHES)
            + (c.enabled, c.deterministic, c.benchmark))


@contextlib.contextmanager
def caller_numerics(matmul_tf32: bool, cudnn_tf32: bool,
                    deterministic: bool, benchmark: bool):
    """This process as a caller of the port sets itself: TF32 through the
    legacy switches (as most programs set it), cuDNN's deterministic and
    benchmark flags. On exit phase 1's settings (TF32 off) come back, and
    are checked."""
    saved = _numerics()
    c = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    c.deterministic, c.benchmark = deterministic, benchmark
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1
        torch.backends.cudnn.allow_tf32 = False
        c.deterministic, c.benchmark = saved[-2:]
        if _numerics() != saved:
            raise AssertionError(f"numerics {_numerics()} after the phase, "
                                 f"{saved} before")


def _spawn(args, tmp: str, name: str, procs: list) -> tuple:
    """``python args`` in a fresh process, its output to ``tmp/name.log``;
    the process joins ``procs``. Returns (process, log path)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    path = os.path.join(tmp, f"{name}.log")
    with open(path, "w") as out:
        procs.append(subprocess.Popen([sys.executable, *args], stdout=out,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=tmp))
    return procs[-1], path


def _wait(proc, log_path: str, name: str) -> list:
    """The lines of a fresh process's output; raises if it failed."""
    try:
        rc = proc.wait(timeout=NUMERICS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    with open(log_path) as f:
        lines = f.read().splitlines()
    if rc != 0:
        raise AssertionError(f"the fresh process {name} exited {rc}:\n"
                             + "\n".join(lines[-40:]))
    return lines


def _stop(procs: list) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _json_lines(lines) -> list:
    return [json.loads(s) for s in lines if s.startswith("{")]


def _poisoned(real, poison):
    """A stand-in for the kernel wrapper ``real`` that lets ``poison`` write
    into its inputs (``poison(args, None)``) and its output (``poison(args,
    out)``) where the dispatcher does not see it, as a kernel launched
    through ctypes writes."""

    def wrapper(*args, **kw):
        args = list(args)
        with _disable_current_modes():
            poison(args, None)
        out = real(*args, **kw)
        with _disable_current_modes():
            poison(args, out)
        return out

    wrapper.launches = 0  # the launch counter the kernel's runner bumps
    return wrapper


def _expect_raise(exc, fn, where: str) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{where}: checked raised no {exc.__name__}")


class _OpThreads(TorchDispatchMode):
    """Which thread dispatched each op (the autograd engine runs a CUDA
    backward on a device thread of its own)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((threading.get_ident(),
                         func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def _host_syncs(fn) -> int:
    """Host syncs in one call of ``fn``: the CUDA runtime's synchronising
    calls in a profile of it (from every thread)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy"))


def _check_checked(dev, cfg, batch, res: dict) -> tuple:
    """``utils.debug.checked`` on the card: an attention step (forward and
    backward) bit for bit the unchecked one; NaNs written by a kernel the
    dispatcher sees (the fused forward, a custom op) and by one it does
    not (the dual transposed SpMM of the backward, through ctypes) caught;
    out-of-range indices turned into IndexError with the card still
    usable; and which thread dispatched each op of a step (the engine runs
    a CUDA backward on a thread of its own). Returns the unchecked and the
    checked step."""
    state = train.create_train_state(cfg, dev)
    grad_fn = train.make_grad_fn(cfg, state.model)
    run = checked(grad_fn)
    with reference_numerics():
        g0, t0 = grad_fn(*batch)
        g1, t1 = run(*batch)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(g0, g1))
                and all(torch.equal(t0[k], t1[k]) for k in t0)):
            raise AssertionError("checked: the step's terms or gradients "
                                 "differ from the unchecked step's")
        graph = batch[3]
        src = int(graph.ell_src[graph.ell_mask][0])

        def nan_values(args, out):
            if out is None:
                args[2] = args[2].clone()
                args[2][src, 0] = float("nan")

        def nan_dvalues(args, out):
            if out is not None:
                out[0].view(-1)[0] = float("nan")

        said = {}
        for name, poison in (("fused_attention", nan_values),
                             ("spmm_t2", nan_dvalues)):
            real = getattr(bsp, name)
            setattr(bsp, name, _poisoned(real, poison))
            try:
                said[name] = _expect_raise(FloatingPointError,
                                           lambda: run(*batch),
                                           f"a NaN from {name}")
            finally:
                setattr(bsp, name, real)
        if "fused_attention" not in said["fused_attention"]:
            raise AssertionError("the fused forward's NaN was not blamed on "
                                 f"its op: {said['fused_attention']}")
        v = torch.randn(graph.max_nodes, 64, device=dev)
        bad = graph.ell_src.clone()
        row, slot = (int(x) for x in graph.ell_mask.nonzero()[0])
        bad[row, slot] = graph.max_nodes + 7  # a valid slot's neighbour
        said["gather"] = _expect_raise(
            IndexError, lambda: checked(lambda x, i: x[i])(v, bad),
            "an out-of-range gather")
        plain = _plain(cfg)
        model = train.create_train_state(plain, dev).model.eval()
        bad_graph = dataclasses.replace(graph, ell_src=bad)

        def forward(g):
            with torch.inference_mode():
                return model(batch[0], g, ops_impl="xla")

        said["plain_model"] = _expect_raise(
            IndexError, lambda: checked(forward)(bad_graph),
            "the plain ops on an out-of-range neighbour")
        ok = checked(forward)(graph)  # the card goes on after the raises
        g2, _ = run(*batch)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(g0, g2))
                and all(np.isfinite(x.cpu().numpy()).all()
                        for x in ok.values())):
            raise AssertionError("checked: the card's later calls differ")
        log(f"[numerics] checked raised: {json.dumps(said)}; then a checked "
            "step on the card gave the same bits and a checked forward "
            "finite outputs")
        threads = _OpThreads()
        with threads:
            grad_fn(*batch)
        main = threading.main_thread().ident
        by_thread = {}
        for ident, name in threads.ops:
            by_thread.setdefault("main" if ident == main else "engine",
                                 []).append(name)
        if "convolution_backward" not in itertools.chain(*by_thread.values()):
            raise AssertionError("the dispatch mode saw no backward op")
    res["checked"] = {
        "raised": said,
        "ops_by_thread": {k: len(v) for k, v in by_thread.items()},
        "backward_ops_by_thread": {
            k: sum(n.endswith("_backward") for n in v)
            for k, v in by_thread.items()}}
    return grad_fn, run


def _time_checked(grad_fn, run, batch, res: dict) -> None:
    """The checked step's cost: host syncs (a profile's synchronising
    CUDA runtime calls) and CUDA-event times of the unchecked and checked
    steps in turns."""
    with reference_numerics():
        syncs = {"unchecked": _host_syncs(lambda: grad_fn(*batch)),
                 "checked": _host_syncs(lambda: run(*batch))}
        ms = {}
        for who in ("unchecked", "checked", "checked", "unchecked"):
            fn = grad_fn if who == "unchecked" else run
            ms.setdefault(who, []).append(cuda_ms(lambda: fn(*batch), reps=5,
                                                  inner=5, warmup=1))
    res["checked"].update(host_syncs=syncs, ms=ms)


def phase_numerics(dev, tag: dict) -> dict:
    """The entry points' numerics against a hostile caller, on
    ``dynamic_swarm`` at full width (native host side, the attention path).

    This process is put in the worst caller state (TF32 on for cuBLAS and
    cuDNN, cuDNN non-deterministic and benchmarking) for the phase. In it:
    ``train.train`` for NUMERICS_STEPS steps; ``python -m
    mrp_gnn_tpu_torch.train`` in a fresh process that sets no flag, for 2
    steps with a checkpoint, then in another resumed to NUMERICS_STEPS:
    every step's terms and the final parameters bit for bit the straight
    run's. The straight run's checkpoint served by ``Predictor`` here, and
    exported; a fresh process that sets nothing serves the same requests
    from the checkpoint and from the artifact: bit for bit this process's
    Predictor. Then, outside the entry points, the pin's cost and what it
    buys: the Predictor's device-side batch and a train step timed in
    turns under (a) the pin, (b) TF32 off and cuDNN non-deterministic and
    (c) torch's defaults, and (c)'s deviation from (a); and
    ``utils.debug.checked`` on the card (``_check_checked``)."""
    t_phase = time.perf_counter()
    res, procs = {}, []
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_numerics_"))
        stack.enter_context(caller_numerics(True, True, False, True))
        stack.callback(_stop, procs)  # if the phase fails on the way
        cli_dir, straight_dir = (os.path.join(tmp, d)
                                 for d in ("cli", "straight"))
        cli = ["-m", "mrp_gnn_tpu_torch.train", "--config", "dynamic_swarm",
               "--log_every", "1", "--checkpoint_dir", cli_dir]
        t0 = time.perf_counter()
        first = _spawn(cli + ["--steps", "2"], tmp, "train_2", procs)
        cfg = numerics_config(straight_dir)
        state, records = train.train(cfg, device=dev)
        straight_s = time.perf_counter() - t0
        eval_it = iter(make_dataset(cfg.data, "eval", shuffle=False))
        batches = [next(eval_it) for _ in range(NUMERICS_REQUESTS)]
        pred = Predictor.from_checkpoint(cfg, straight_dir,
                                         graph=batches[0]["graph"])
        requests = np.stack([b["images"] for b in batches])
        want = [pred(x) for x in requests]
        art = os.path.join(tmp, "model.pt2")
        export_predictor(pred, art)
        req_path = os.path.join(tmp, "requests.npy")
        got_path = os.path.join(tmp, "fresh_outputs.npz")
        np.save(req_path, requests)
        serving = _spawn(["-c", _FRESH_SERVING, straight_dir, art, req_path,
                          got_path], tmp, "serving", procs)
        lines = _wait(*first, "train_2")
        second = _spawn(cli + ["--steps", str(NUMERICS_STEPS)], tmp,
                        "train_resume", procs)
        it = iter(make_dataset(cfg.data, "train"))
        batch = train.batch_to_device(next(it), dev)
        grad_fn, run = _check_checked(dev, cfg, batch, res)
        cli_records = _json_lines(lines) + _json_lines(
            _wait(*second, "train_resume"))
        fresh_serving = _json_lines(_wait(*serving, "serving"))[-1]
        fresh_s = time.perf_counter() - t0
        steps = tuple(range(1, NUMERICS_STEPS + 1))
        got, ref = _train_terms(cli_records, steps), _train_terms(records,
                                                                 steps)
        if got != ref:
            raise AssertionError(f"the CLI in fresh processes {got}; the "
                                 f"straight run here {ref}")
        resumed = train.create_train_state(cfg, dev)
        CheckpointManager(cli_dir).restore_latest(resumed)
        diffs = [n for (n, a), (_, b) in zip(
            state.model.named_parameters(), resumed.model.named_parameters())
            if not torch.equal(a, b)]
        if resumed.step != NUMERICS_STEPS or diffs:
            raise AssertionError(f"the CLI's step-{resumed.step} parameters "
                                 f"differ from the straight run's: "
                                 f"{diffs[:5]}")
        log(f"[numerics] train CLI in 2 fresh processes (2 steps, then "
            f"resumed to {NUMERICS_STEPS}) bit for bit the straight run made "
            "here under TF32 on, cuDNN non-deterministic and benchmarking: "
            f"terms {json.dumps(ref)}, every parameter")
        fresh = np.load(got_path)
        serve_diffs = {}
        for who in ("predictor", "artifact"):
            serve_diffs[who] = [_outputs_agree(
                {"depth": fresh[f"{who}_depth"][i],
                 "seg": fresh[f"{who}_seg"][i]}, w,
                f"the fresh process's {who}, request {i}")
                for i, w in enumerate(want)]
            if not all(d["bit_equal"] for d in serve_diffs[who]):
                log(f"[numerics] the fresh process's {who} is within "
                    f"TOL_EXPORT_* of this process's Predictor but not bit "
                    f"for bit: {json.dumps(serve_diffs[who])}")
        log(f"[numerics] a fresh process that sets no flag (torch's own: "
            f"{json.dumps(fresh_serving['flags'])}) served "
            f"{NUMERICS_REQUESTS} requests from the checkpoint and from the "
            f"artifact: {json.dumps(serve_diffs)} against this process's "
            "Predictor")
        res.update(fresh_s=fresh_s, straight_s=straight_s,
                   fresh_flags=fresh_serving["flags"], serving=serve_diffs)

    # The pin's cost and what it buys, outside the entry points.
    raw_step_state = train.create_train_state(cfg, dev)
    raw_step = train.make_train_step(cfg, raw_step_state.model,
                                     raw_step_state.optimizer).__wrapped__
    images = torch.from_numpy(requests[0]).to(dev)

    def raw_forward():
        with torch.inference_mode():
            return pred._forward(images)

    first_terms, depth = {}, {}
    for name in ("a_pin", "c_torch_defaults"):
        with caller_numerics(*NUMERICS_STATES[name], False):
            s = train.create_train_state(cfg, dev)
            step = train.make_train_step(cfg, s.model, s.optimizer)
            first_terms[name] = {k: float(v) for k, v in
                                 step.__wrapped__(s, *batch)[1].items()}
            depth[name] = raw_forward()["depth"].cpu().numpy()
    a, c = first_terms["a_pin"], first_terms["c_torch_defaults"]
    valid = batches[0]["graph"].node_mask.numpy()
    deviation = {
        "depth_max_abs_m": float(np.abs(depth["c_torch_defaults"][valid]
                                        - depth["a_pin"][valid]).max()),
        "first_step_terms_rel": {k: abs(c[k] - a[k]) / max(abs(a[k]), 1e-30)
                                 for k in a}}
    turns = {k: {"predictor_batch_ms": [], "train_step_ms": []}
             for k in NUMERICS_STATES}
    for name in ("a_pin", "b_no_tf32", "c_torch_defaults", "c_torch_defaults",
                 "b_no_tf32", "a_pin"):
        with caller_numerics(*NUMERICS_STATES[name], False):
            turns[name]["predictor_batch_ms"].append(
                cuda_ms(raw_forward, reps=5, inner=10, warmup=2))
            turns[name]["train_step_ms"].append(
                cuda_ms(lambda: raw_step(raw_step_state, *batch), reps=5,
                        inner=10, warmup=3))
    _time_checked(grad_fn, run, batch, res)
    res.update(states=NUMERICS_STATES, ms=turns, deviation_c_vs_a=deviation,
               phase_s=time.perf_counter() - t_phase)
    log(json.dumps({"metric": "numerics", "config": cfg.name, **res,
                    "timing": "CUDA events, median of 5 x 10 device-side "
                              "Predictor forwards and of 5 x 10 train steps "
                              "(make_train_step's step outside the pin), in "
                              "turns a, b, c, c, b, a; states (matmul TF32, "
                              "cuDNN TF32, cuDNN deterministic), benchmark "
                              "off; checked: 5 x 5 grad steps (forward and "
                              "backward, no update) in turns",
                    **tag}))
    return res


# --- phase 10: data x graph parallelism over ranks sharing the card ----------

PARALLEL_RANKS = 8          # swarm_partitioned's graph axis, one rank each
PARALLEL_STEPS = 4          # the straight run; the resume repeats steps 3-4
PARALLEL_DXG_STEPS = 2      # the 2 x 4 run (its first step is held)
PARALLEL_TIMING_STEPS = 6   # steps timed per turn (turns: on, off, on, off)
PARALLEL_TIMEOUT_S = 600
PARALLEL_SEED = 13
TOL_PARALLEL = 1e-5         # fusion (relative to max(1, max |want|)), terms
# The kernel bodies one rank's attention train step must show: the SpMM's
# vector form (D 8192), the wide SDDMM (dα, d 8192) and the transposed
# SpMM's staged form.
PARALLEL_BODIES = ("spmm_vec_kernel", "sddmm_wide_kernel",
                   "spmm_t_staged_kernel")
# Rows 3, 4 and 5 as the partitioned fusion calls them, by their plain
# versions, against which each call on a shard is held.
PARALLEL_WRAPPERS = {"spmm": bsp.spmm_reference, "sddmm": bsp.sddmm_reference,
                     "spmm_t": bsp.spmm_t_reference}
PARALLEL_CASES = (("attention", "boundary", True),
                  ("attention", "boundary", False),
                  ("attention", "all_gather", True),
                  ("mean", "boundary", True), ("max", "boundary", True))


def parallel_config(data: int = 1, graph: int = 8, overlap: bool = True,
                    checkpoint_dir: str = ""):
    """``swarm_partitioned`` at full width (64x64, encoder 32/64/128, one
    attention fusion layer, 6 classes, f32; 4 scenes x 64 robots in radius
    4 = 256 nodes), on a data x graph mesh."""
    cfg = get_config("swarm_partitioned")
    return cfg.replace(
        train=dataclasses.replace(cfg.train, log_every=1, checkpoint_every=2,
                                  checkpoint_dir=checkpoint_dir),
        parallel=dataclasses.replace(cfg.parallel, data_axis_size=data,
                                     graph_axis_size=graph,
                                     overlap_boundary_exchange=overlap))


def parallel_inputs(cfg) -> dict:
    """Seeded q, k, v of the whole batch at the preset's fusion widths."""
    m = cfg.model
    s = m.bottleneck_stride
    V = cfg.data.scenes_per_batch * cfg.data.num_robots
    D = (m.image_size[0] // s) * (m.image_size[1] // s) * m.encoder_channels[-1]
    rng = np.random.default_rng(PARALLEL_SEED)
    return {k: rng.normal(size=(V, w)).astype(np.float32)
            for k, w in (("q", m.attention_dim), ("k", m.attention_dim),
                         ("v", D))}


def param_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(model.state_dict().items()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _HostTimers:
    """Host seconds spent in the methods ``kinds`` names (kind: [(class,
    method name)], plain or static methods), by kind, by wrapping them for
    a measurement. Phase 10 times the halo exchange (posting: the send
    gather, the pinned copy and its wait, and the batched isend/irecv;
    waiting for the receive and its copy back; the backward's reverse
    exchange) and the world sums (loss terms, gradients):
    :func:`parallel_timers`."""

    def __init__(self, kinds: dict):
        self.seconds = {k: 0.0 for k in kinds}
        self._saved = []
        for kind, sites in kinds.items():
            for cls, name in sites:
                orig = cls.__dict__[name]
                static = isinstance(orig, staticmethod)
                timed = self._timed(orig.__func__ if static else orig, kind)
                setattr(cls, name, staticmethod(timed) if static else timed)
                self._saved.append((cls, name, orig))

    def _timed(self, fn, key):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0
        return wrapped

    def close(self):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)


def parallel_timers() -> _HostTimers:
    from mrp_gnn_tpu_torch.parallel import fused, mesh
    return _HostTimers({
        "exchange": [(fused._Halo, "_swap"), (fused._Pending, "wait")],
        "world_sums": [(mesh.Mesh, "sum"), (mesh.Mesh, "all_gather")]})


def _plain_sddmm(a1, b1, ell_src, ell_mask, a2=None, b2=None):
    out = bsp.sddmm_reference(a1, b1, ell_src, ell_mask)
    return out if a2 is None else (out, bsp.sddmm_reference(a2, b2, ell_src,
                                                            ell_mask))


class _ShardCalls:
    """While open, each call of the wrappers of ``plain`` (name on ``bsp``:
    its plain version; PARALLEL_WRAPPERS by default, rows 3, 4 and 5) is
    held against its plain version on the same shard tensors, as the call
    returns; ``errors`` keeps, by wrapper, the calls, the largest max |got -
    want| over max(1, max |want|) and the feature widths (the widest 2-D
    float operand's dim 1) it ran at; ``forms`` the SpMM's and the fused
    forward's form at each width (``bsp.spmm_form``, ``bsp.fused_form``)."""

    def __init__(self, plain: dict | None = None):
        self.plain = plain or PARALLEL_WRAPPERS
        self.errors = {}
        self.forms = {}
        self._orig = {n: getattr(bsp, n) for n in self.plain}
        for name, fn in self._orig.items():
            setattr(bsp, name, self._held(name, fn))

    def _form(self, name, args) -> None:
        if name == "spmm":
            x = args[1]
            vec = 8 if bsp._vec8(x) else 1
            form = bsp.SPMM_FORMS[bsp.spmm_form(vec, x.shape[1],
                                                x.dtype == torch.bfloat16)]
        elif name == "fused_attention":
            v = args[2]
            form = bsp.FUSED_FORMS[bsp.fused_form(
                8 if bsp._vec8(v) else 1, v.dtype == torch.bfloat16)]
        elif name in ("spmm_t", "spmm_t2"):
            dual = name == "spmm_t2"
            src, mask = args[4:6] if dual else args[2:4]
            form = spmm_t_rule(src, mask, args[6 if dual else 4])
        else:
            return
        self.forms.setdefault(name, {})[str(args[
            2 if name == "fused_attention" else 1].shape[1])] = form

    def _held(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            want = self.plain[name](*args, **{
                k: v for k, v in kw.items() if k != "view"})
            outs = out if isinstance(out, (tuple, list)) else (out,)
            wants = want if isinstance(want, (tuple, list)) else (want,)
            err = max(float((o.float() - w.float()).abs().max()
                            / max(1.0, float(w.abs().max())))
                      for o, w in zip(outs, wants))
            width = max(t.shape[1] for t in args if torch.is_tensor(t)
                        and t.dim() == 2 and t.is_floating_point())
            rec = self.errors.setdefault(name, {"calls": 0, "max_err": 0.0,
                                                "widths": []})
            rec["calls"] += 1
            rec["max_err"] = max(rec["max_err"], err)
            if width not in rec["widths"]:
                rec["widths"].append(width)
            if out is not None and outs[0].is_cuda:
                self._form(name, args)
            return out
        wrapped.launches = 0    # the wrapper counts itself (not a launch
        return wrapped          # of the main path: not read)

    def close(self):
        for name, fn in self._orig.items():
            setattr(bsp, name, fn)


def _rank_fusion(pctx, dev, out_dir: str) -> dict:
    """The partitioned fusion's forward and backward of sum(out ** 2) on
    this rank's rows of the seeded inputs, for each case, with every call
    of rows 3-5 held against its plain version (:class:`_ShardCalls`);
    rank 0 writes the gathered outputs and gradients. Returns every rank's
    shard checks, gathered."""
    from mrp_gnn_tpu_torch.ops import dispatch
    from mrp_gnn_tpu_torch.parallel.fused import make_partitioned_edge_fusion
    x = parallel_inputs(parallel_config())
    lo, hi = pctx.local_node_range(x["v"].shape[0])
    ops = dispatch.get_ops("pallas", dev)
    res = {}
    held = _ShardCalls()
    try:
        for agg, exchange, overlap in PARALLEL_CASES:
            fn = make_partitioned_edge_fusion(pctx.mesh, pctx.plan, exchange,
                                              overlap)
            t = {k: torch.tensor(v[lo:hi], device=dev, requires_grad=True)
                 for k, v in x.items()}
            q, k = (t["q"], t["k"]) if agg == "attention" else (None, None)
            out = fn(ops, agg, q, k, t["v"], None)
            (out ** 2).sum().backward()
            tag = f"{agg}-{exchange}-{'overlap' if overlap else 'serial'}"
            parts = {"out": out.detach()}
            parts.update({f"d{k}": t[k].grad for k in ("q", "k", "v")
                          if t[k].grad is not None})
            for key, val in parts.items():
                res[f"{tag}/{key}"] = torch.cat(
                    pctx.mesh.all_gather(val)).cpu().numpy()
    finally:
        held.close()
    if pctx.mesh.rank == 0:
        np.savez(os.path.join(out_dir, "fusion.npz"), **res)
    shards = [None] * pctx.mesh.size
    torch.distributed.all_gather_object(shards, held.errors)
    forms = [None] * pctx.mesh.size
    torch.distributed.all_gather_object(forms, held.forms)
    return {"cases": len(PARALLEL_CASES), "shard_kernels": shards,
            "forms": forms}


def _timed_step(step, dev) -> tuple:
    """(CUDA-event ms on the device's stream, host-clock ms) of one call of
    ``step`` whose terms are read back (host clock alone on the CPU)."""
    _sync(dev)
    cuda = dev.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    terms = step()
    float(terms["total"])
    if cuda:
        end.record()
    _sync(dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    return (start.elapsed_time(end) if cuda else host_ms), host_ms


def _rank_timings(dev, out: dict, profile: bool) -> None:
    """Step time (median of PARALLEL_TIMING_STEPS by CUDA events on this
    rank's stream, every rank in step) with the value exchange overlapped
    and serialised in turns, the host time in the exchange and in the world
    sums over the steps' host clock, and rank 0's profile of one step."""
    turns = []
    for overlap in (True, False, True, False):
        cfg = parallel_config(overlap=overlap)
        pctx = train.make_parallel(cfg, dev)
        state = train.create_train_state(cfg, dev, pctx.edge_fusion_fn)
        pctx.shard_state(state)
        step = train.make_train_step(cfg, state.model, state.optimizer,
                                     pctx)
        d = cfg.data
        batch = next(iter(make_dataset(
            d, "train", node_range=pctx.local_node_range(
                d.scenes_per_batch * d.num_robots))))
        args = pctx.shard_batch(batch)
        for _ in range(2):
            step(state, *args)
        _sync(dev)
        timers = parallel_timers()
        try:
            times = [_timed_step(lambda: step(state, *args)[1], dev)
                     for _ in range(PARALLEL_TIMING_STEPS)]
        finally:
            timers.close()
        host_s = sum(t[1] for t in times) / 1e3
        turns.append({"overlap": overlap,
                      "step_ms": statistics.median(t[0] for t in times),
                      "exchange_share": timers.seconds["exchange"] / host_s,
                      "world_sums_share": timers.seconds["world_sums"] / host_s})
        if len(turns) == 1:
            out["profile"] = _rank_profile(lambda: step(state, *args), dev,
                                           profile)
    out["timings"] = turns


def _rank_profile(fn, dev, profile: bool, n: int = 3, tries: int = 3):
    """Rank 0's device activity over ``n`` steps (after ``n`` warm-up steps
    in the trace, as :func:`profiled` takes them), while every other rank
    runs the same steps unprofiled; a trace that missed device activity is
    repeated, the decision broadcast so all ranks step together."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule
    use = profile and dev.type == "cuda"
    for _ in range(tries):
        res = None
        if use:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA],
                               schedule=schedule(wait=0, warmup=1, active=1,
                                                 repeat=1)) as prof:
                for _ in range(n):
                    fn()
                _sync(dev)
                prof.step()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                _sync(dev)
                wall_us = (time.perf_counter() - t0) * 1e6
                prof.step()
            averages = prof.key_averages()
            events = [e for e in averages
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep")]
            if events and all(e.count % n == 0 for e in events):
                busy = sum(e.self_device_time_total for e in events)
                names = [e.key for e in events]
                # the profiler's view of the transport: host time of the
                # gloo operations (the collectives and the exchange's sends
                # and receives) and device time of the copies
                comm = {e.key: e.cpu_time_total / n / 1e3 for e in averages
                        if e.device_type == DeviceType.CPU
                        and e.key.startswith("gloo:")}
                copies = {e.key: e.self_device_time_total / n / 1e3
                          for e in events if e.key.startswith("Memcpy")}
                res = {"bodies": [b for b in PARALLEL_BODIES
                                  if any(f"::{b}<" in k or f"::{b}(" in k
                                         for k in names)],
                       "device_busy_ms_per_step": busy / n / 1e3,
                       "rank0_device_idle_share": 1 - busy / wall_us,
                       "step_wall_ms": wall_us / n / 1e3,
                       "gloo_host_ms_per_step": comm,
                       "copies_device_ms_per_step": copies}
        else:
            for _ in range(2 * n):
                fn()
            _sync(dev)
        flag = [res is not None or not use]
        torch.distributed.broadcast_object_list(flag, src=0)
        if flag[0]:
            return res
    raise AssertionError(f"rank 0's profile missed device activity in "
                         f"{tries} traces")


def parallel_rank_main(argv) -> int:
    """One rank of phase 10: ``chip_smoke.py --parallel-rank R WORLD STORE
    OUT [DEVICE]``. Joins the gloo group, then runs the fusion cases, the
    straight 4-step ``train.train`` (launch counts reset just before it and
    read just after), the resume from its step-2 checkpoint, ``evaluate``
    with the context, the 2 x 4 run and the timings; rank 0 writes
    ``OUT/rank0.json``."""
    import shutil
    from mrp_gnn_tpu_torch.parallel import launch
    from mrp_gnn_tpu_torch.parallel.partition import (boundary_fraction,
                                                      exchange_rows)
    rank, world, store, out_dir = (int(argv[0]), int(argv[1]), argv[2],
                                   argv[3])
    torch.set_num_threads(1)
    launch.initialize(f"file://{store}", world, rank, backend="gloo")
    dev = launch.rank_device(argv[4] if len(argv) > 4 else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"world": torch.distributed.get_world_size(), "device": str(dev)}
    t0 = time.perf_counter()

    def mark(name):
        torch.distributed.barrier()
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0

    ck = os.path.join(out_dir, "ck")
    cfg = parallel_config(checkpoint_dir=ck)
    pctx = train.make_parallel(cfg, dev)
    out["graph_axis"] = pctx.mesh.graph
    out["boundary_fraction"] = boundary_fraction(pctx.plan)
    out["exchange_rows"] = exchange_rows(pctx.plan)
    out["fusion"] = _rank_fusion(pctx, dev, out_dir)
    mark("fusion")
    # the main path of the phase: counts reset just before, read just after
    bsp.reset_launches()
    with counted_views() as views:
        state, records = train.train(cfg, num_steps=PARALLEL_STEPS,
                                     device=dev)
    launches = [None] * world
    torch.distributed.all_gather_object(launches, bsp.launch_counts())
    out["launches"] = launches
    out["source_views"] = [None] * world
    torch.distributed.all_gather_object(out["source_views"], views[0])
    out["straight"] = _train_terms(records, range(1, PARALLEL_STEPS + 1))
    digests = [None] * world
    torch.distributed.all_gather_object(digests, param_digest(state.model))
    out["digests"] = digests
    if rank == 0:
        torch.save(state.model.state_dict(), os.path.join(out_dir, "final.pt"))
        os.makedirs(os.path.join(out_dir, "resume"))
        shutil.copy(os.path.join(ck, "ckpt_2.pt"),
                    os.path.join(out_dir, "resume"))
    mark("train")
    _, records = train.train(cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(out_dir, "resume"))),
        num_steps=PARALLEL_STEPS, device=dev)
    out["resumed"] = _train_terms(records, range(1, PARALLEL_STEPS + 1))
    mark("resume")
    out["eval"] = evaluate(cfg, state.model, pctx=pctx)
    mark("eval")
    _, records = train.train(parallel_config(data=2, graph=4),
                             num_steps=PARALLEL_DXG_STEPS, device=dev)
    out["dxg"] = _train_terms(records, range(1, PARALLEL_DXG_STEPS + 1))
    mark("dxg")
    _rank_timings(dev, out, profile=rank == 0)
    mark("timings")
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _tail(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()[-4000:]
    except OSError:
        return "(no log)"


def spawn_parallel_ranks(out_dir: str, device: str | None = None,
                         world: int = PARALLEL_RANKS,
                         mode: tuple = ("--parallel-rank",)) -> None:
    """``world`` processes of this script in rank mode (``mode``: its flag
    and the arguments before the rank's), all started together; waits with
    a timeout, stops at the first rank that fails, kills the rest, and
    raises with the failing ranks' logs."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    store = os.path.join(out_dir, "store")
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), *mode,
               str(r), str(world), store, out_dir]
        if device is not None:
            cmd.append(device)
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(
            f"rank {r} exit {procs[r].returncode} (killed at the timeout or "
            f"after another rank failed when negative):\n{_tail(logs[r])}"
            for r in bad))


def _close(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max(1, max |want|)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _check_shard_kernels(shards: list, plain: dict = None) -> dict:
    """Every rank's calls of the wrappers of ``plain`` (PARALLEL_WRAPPERS
    by default): each wrapper called on every rank, every call within
    TOL_PARALLEL of its plain version; returns the largest error by
    wrapper."""
    worst = {}
    for r, errors in enumerate(shards):
        for name in plain or PARALLEL_WRAPPERS:
            rec = errors.get(name, {"calls": 0, "max_err": 0.0})
            n, err = rec["calls"], rec["max_err"]
            if n == 0 or not err <= TOL_PARALLEL:
                raise AssertionError(f"rank {r}'s bsp.{name} on its shard: "
                                     f"{n} call(s), max err {err}")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _parallel_reference_fusion(dev, fusion: dict) -> dict:
    """Each case's gathered output and gradients against the unpartitioned
    port's plain ops on the card, on the same graph as an ELL batch (the
    block tag dropped)."""
    from mrp_gnn_tpu_torch.ops import dispatch
    from mrp_gnn_tpu_torch.parallel.context import replica_graph_for
    cfg = parallel_config()
    g = dataclasses.replace(replica_graph_for(cfg), scene_adj=None,
                            scene_stride=0).to(dev)
    x = parallel_inputs(cfg)
    ops = dispatch.get_ops("xla", dev)
    errs = {}
    for agg, exchange, overlap in PARALLEL_CASES:
        tag = f"{agg}-{exchange}-{'overlap' if overlap else 'serial'}"
        t = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in x.items()}
        q, k = (t["q"], t["k"]) if agg == "attention" else (None, None)
        out = default_edge_fusion(ops, agg, q, k, t["v"], g)
        (out ** 2).sum().backward()
        want = {"out": out.detach()}
        want.update({f"d{k}": t[k].grad for k in ("q", "k", "v")
                     if t[k].grad is not None})
        for key, w in want.items():
            err = _close(fusion[f"{tag}/{key}"], w.cpu().numpy())
            if not err <= TOL_PARALLEL:
                raise AssertionError(f"partitioned {tag} {key}: {err} "
                                     f"(relative to max(1, max |want|))")
            errs[f"{tag}/{key}"] = err
    return errs


def _rel_terms(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want if k != "step")


def phase_parallel(dev, tag: dict, rank_device: str | None = None) -> dict:
    """Phase 10: ``swarm_partitioned`` over PARALLEL_RANKS gloo ranks on the
    one card (``spawn_parallel_ranks``), held to the port on one process:
    every call of rows 3-5 in the fusion cases within TOL_PARALLEL of its
    plain version on the rank's shard tensors; the fusion cases within
    TOL_PARALLEL of the unpartitioned plain ops; the straight run's
    launches on every rank (rows 3, 4 and 5 once per step, no other
    kernel); its first step's terms within TOL_PARALLEL relative of
    one process's run of the same config (its mesh shrunk to one rank),
    later steps printed beside them; every rank's parameters bit for bit
    equal; the resume from step 2 bit for bit the straight run; evaluation
    under the context within TOL_EVAL of one process's evaluation of the
    same weights; the 2 x 4 run's first step as the straight run's; then
    the numbers (step times, the exchange's share, rows exchanged, overlap
    on against off, rank 0's device idle share)."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        t0 = time.perf_counter()
        spawn_parallel_ranks(tmp, rank_device)
        ranks_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "rank0.json")) as f:
            got = json.load(f)
        fusion = dict(np.load(os.path.join(tmp, "fusion.npz")))
        final = torch.load(os.path.join(tmp, "final.pt"), map_location=dev,
                           weights_only=True)
    log(f"[parallel] {PARALLEL_RANKS} ranks in {ranks_s:.2f} s (their "
        f"barriers: {json.dumps(got['seconds'])})")
    if (got["world"], got["graph_axis"]) != (PARALLEL_RANKS, PARALLEL_RANKS):
        raise AssertionError(f"ran with world {got['world']} and graph axis "
                             f"{got['graph_axis']}")
    if not got["boundary_fraction"] > 0:
        raise AssertionError("the plan has no boundary rows")
    log(f"[parallel] world {got['world']}, graph axis {got['graph_axis']}, "
        f"boundary fraction {got['boundary_fraction']:.6f}, rows received "
        f"per shard: {json.dumps(got['exchange_rows'])}")
    shard = _check_shard_kernels(got["fusion"]["shard_kernels"])
    for r, forms in enumerate(got["fusion"]["forms"]):
        if set(forms.get("spmm_t", {}).values()) != {"staged"}:
            raise AssertionError(f"rank {r}'s transposed SpMM took "
                                 f"{forms.get('spmm_t')}; the staged form "
                                 "was expected at every width")
    log(f"[parallel] the transposed SpMM's form on the shards, by width, on "
        f"rank 0: {json.dumps(got['fusion']['forms'][0].get('spmm_t'))}")
    log(f"[parallel] rows 3-5 on every rank's shard vs their plain versions: "
        f"max err {json.dumps(shard)}")
    errs = _parallel_reference_fusion(dev, fusion)
    log(f"[parallel] fusion vs the unpartitioned plain ops: max err "
        f"{max(errs.values()):.3e} over {len(errs)} outputs and gradients")
    want = {"bsp_spmm": PARALLEL_STEPS, "bsp_sddmm": PARALLEL_STEPS,
            "bsp_spmm_t": PARALLEL_STEPS}
    want = {k: want.get(k, 0) for k in bsp.KERNELS}
    for r, counts in enumerate(got["launches"]):
        if counts != want:
            raise AssertionError(f"rank {r}'s launches over {PARALLEL_STEPS} "
                                 f"steps: {counts}, expected {want}")
    log(f"[parallel] launches per rank per step, on each of the "
        f"{len(got['launches'])} ranks: bsp_spmm 1, bsp_sddmm 1, bsp_spmm_t 1 "
        f"({json.dumps({k: v for k, v in want.items() if v})} over "
        f"{PARALLEL_STEPS} steps)")
    if any(got["source_views"]):
        raise AssertionError(f"bsp.source_view ran on the ranks: "
                             f"{got['source_views']}; the rule takes the "
                             "staged form on every shard")
    log(f"[parallel] bsp.source_view calls over {PARALLEL_STEPS} steps, by "
        f"rank: {got['source_views']}")
    if len(set(got["digests"])) != 1:
        raise AssertionError(f"parameters differ across ranks: {got['digests']}")
    if got["resumed"] != got["straight"][2:]:
        raise AssertionError(f"resume {got['resumed']} is not the straight "
                             f"run {got['straight'][2:]}")
    log("[parallel] every rank's parameters equal bit for bit; the resume "
        "from step 2 repeats steps 3-4 bit for bit")
    # one process, the same config: the mesh shrinks to one rank
    t0 = time.perf_counter()
    state, records = train.train(parallel_config(), num_steps=PARALLEL_STEPS,
                                 device=dev)
    single = _train_terms(records, range(1, PARALLEL_STEPS + 1))
    single_s = time.perf_counter() - t0
    for name, run in (("1 x 8", got["straight"]), ("2 x 4", got["dxg"])):
        err = _rel_terms(run[0], single[0])
        if not err <= TOL_PARALLEL:
            raise AssertionError(f"{name} step 1 {run[0]} vs one process "
                                 f"{single[0]}: {err}")
        log(f"[parallel] {name} first step within {err:.3e} of one process")
    for a, b in zip(got["straight"], single):
        log(json.dumps({"metric": "parallel_terms", "step": a["step"],
                        "ranks": a, "one_process": b}))
    state.model.load_state_dict(final)
    ev = evaluate(parallel_config(), state.model)
    for k in ("rmse", "abs_rel", "delta1", "delta2", "delta3", "miou"):
        bad = abs(got["eval"][k] - ev[k]) > TOL_EVAL_ABS + TOL_EVAL_REL * abs(ev[k])
        if bad:
            raise AssertionError(f"eval {k}: ranks {got['eval'][k]}, one "
                                 f"process {ev[k]}")
    log(json.dumps({"metric": "parallel_eval", "ranks": got["eval"],
                    "one_process": ev}))
    # the one-process step at the same config, timed as the ranks time it
    cfg = parallel_config()
    step_state = train.create_train_state(cfg, dev)
    step = train.make_train_step(cfg, step_state.model, step_state.optimizer)
    args = train.batch_to_device(next(iter(make_dataset(cfg.data, "train"))),
                                 dev)
    for _ in range(2):
        step(step_state, *args)
    times = [_timed_step(lambda: step(step_state, *args)[1], dev)[0]
             for _ in range(PARALLEL_TIMING_STEPS)]
    if dev.type == "cuda" and got["profile"]["bodies"] != list(PARALLEL_BODIES):
        raise AssertionError(f"rank 0's step ran {got['profile']['bodies']}, "
                             f"expected {PARALLEL_BODIES}")
    log(json.dumps({
        "metric": "parallel_step", "ranks": PARALLEL_RANKS,
        "transport": "gloo through pinned host memory, 8 ranks sharing one "
                     "card (not how a multi-card deployment runs)",
        "timing": "step_ms: CUDA events on rank 0's stream (one process: "
                  "its own), median; shares: host time in the exchange and "
                  "in the world sums over the steps' host clock",
        "turns": got["timings"], "one_process_step_ms":
            statistics.median(times),
        "profile": got.get("profile"), "one_process_train_s": single_s,
        **tag}))
    log(f"[parallel] phase {time.perf_counter() - t_phase:.2f} s")
    return got


# --- phase 11: the model axis (tensor parallel, spatial) over ranks ----------

# mode: (data, graph, model) axes; "spatial" shards image rows
MODEL_AXIS_MESHES = {"tp": (1, 1, 2), "spatial": (2, 1, 4)}
MODEL_AXIS_STEPS = 4          # the straight run; the resume repeats steps 3-4
MODEL_AXIS_TIMING_STEPS = 4   # steps timed over the ranks
MODEL_AXIS_EVAL_SCENES = 16   # 2 eval batches (the preset's 64: 8)
MODEL_AXIS_BENCH_INNER = 10   # chained calls per timing of the benches
# One process's own sensitivity to rounding: the held updates again with
# each pixel scaled by 1 +- 1e-7 (seeded signs), MODEL_AXIS_DRAWS times. A
# leaf of the ranks' gradients or parameters is held within TOL_PARALLEL
# beyond the most that two of these runs disagree on it
# (``_leaf_envelope``).
MODEL_AXIS_DRAWS = 16
# train()'s steps 2-4 against one process: the JAX tests' tolerance
TOL_MODEL_AXIS_STEPS = dict(rtol=2e-4, atol=2e-5)
# The kernels each path runs on its shards, by wrapper, with their plain
# versions: tensor parallel, the single-device attention of each rank's
# channel slice (rows 1, 3, 4/7 and 6; D 4096 a rank); spatial, the data
# axis's one-shard partitioned fusion of each rank's rows (rows 3, 4 and
# 5; D 2048 a rank).
MODEL_AXIS_WRAPPERS = {
    "tp": {"fused_attention": bsp.fused_attention_reference,
           "sddmm": _plain_sddmm, "spmm": bsp.spmm_reference,
           "spmm_t2": bsp.spmm_t2_reference},
    "spatial": PARALLEL_WRAPPERS}
MODEL_AXIS_PER_STEP = {
    "tp": {"bsp_fused_attention": 1, "bsp_sddmm": 1, "bsp_spmm": 1,
           "bsp_spmm_t2": 1},
    "spatial": {"bsp_spmm": 1, "bsp_sddmm": 1, "bsp_spmm_t": 1}}
MODEL_AXIS_WIDTH = {"tp": 4096, "spatial": 2048}
# the form each path's widest kernels must take there (``bsp.spmm_form``:
# the SpMM's vector form from D 2048; ``bsp.spmm_t_form``: the staged
# transposed SpMM)
MODEL_AXIS_FORMS = {"tp": {"fused_attention": {"4096": "vec"},
                           "spmm_t2": {"4096": "staged"}},
                    "spatial": {"spmm": {"2048": "vec"},
                                "spmm_t": {"2048": "staged"}}}


def model_axis_config(mode: str | None = None, checkpoint_dir: str = ""):
    """``dynamic_swarm`` at full width (``swarm_config``: 64x64, encoder
    32/64/128, one attention fusion layer, 6 classes, f32; 8 scenes x 32
    drifting robots), MODEL_AXIS_EVAL_SCENES eval scenes, checkpoints every
    2 steps, on ``mode``'s mesh (one process: None)."""
    cfg = swarm_config()
    d, g, m = MODEL_AXIS_MESHES[mode] if mode else (1, 1, 1)
    return cfg.replace(
        data=dataclasses.replace(cfg.data,
                                 num_eval_scenes=MODEL_AXIS_EVAL_SCENES),
        train=dataclasses.replace(cfg.train, log_every=1, checkpoint_every=2,
                                  checkpoint_dir=checkpoint_dir),
        parallel=dataclasses.replace(cfg.parallel, data_axis_size=d,
                                     graph_axis_size=g, model_axis_size=m,
                                     spatial_sharding=mode == "spatial"))


def _first_batch(cfg, dev, pctx=None) -> tuple:
    """The train stream's first batch on ``dev``: this rank's under
    ``pctx``."""
    d = cfg.data
    it = make_train_iterator(d, node_range=pctx.local_node_range(
        d.scenes_per_batch * d.num_robots) if pctx else None)
    try:
        batch = next(it)
    finally:
        it.close()
    return (pctx.shard_batch(batch) if pctx
            else train.batch_to_device(batch, dev))


def _first_update(cfg, dev, pctx=None, plain: dict | None = None,
                  draw: int | None = None) -> dict:
    """Two updates from the seeded state on the first batch, the first at
    lr 0 (the warmup schedule's start), the second above it (``pctx``: over
    the ranks, every call of the wrappers of ``plain`` held against its
    plain version; ``draw``: each pixel scaled by 1 +- 1e-7, signs seeded
    by it): the first step's terms, global norm and gradients, and the
    parameters after the second update, whole (gathered under tensor
    parallelism), on the CPU."""
    from mrp_gnn_tpu_torch.parallel import tp
    state = train.create_train_state(cfg, dev,
                                     pctx.edge_fusion_fn if pctx else None)
    if pctx:
        pctx.shard_state(state)
    if not (train.warmup_cosine_lr(cfg, 0) == 0
            < train.warmup_cosine_lr(cfg, 1)):
        raise AssertionError("the second held update must have lr above 0")
    params = list(state.model.parameters())
    args = _first_batch(cfg, dev, pctx)
    if draw is not None:
        images = args[0]
        signs = np.random.default_rng(draw).choice(
            [-1.0, 1.0], size=tuple(images.shape)).astype(np.float32)
        args = (images * (1 + 1e-7 * torch.from_numpy(signs).to(dev)),
                *args[1:])
    grad_fn = train.make_grad_fn(cfg, state.model, pctx)
    mesh = pctx.mesh if pctx else None
    held = _ShardCalls(plain) if plain else None
    try:
        grads, terms = grad_fn(*args)
        norm = train.global_norm(grads, params, mesh)
        state.optimizer.step(grads, norm)
        again, _ = grad_fn(*args)
        state.optimizer.step(again, train.global_norm(again, params, mesh))
    finally:
        if held:
            held.close()
    grads = list(grads)
    sharded = [i for i, p in enumerate(params) if tp.is_sharded(p)]
    if sharded:
        for i, g in zip(sharded, pctx.shard.gather_rows(
                [grads[i] for i in sharded])):
            grads[i] = g
    whole = pctx.full_tensors(state) if pctx else None
    names = [n for n, _ in state.model.named_parameters()]
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grad_norm": float(norm),
            "grads": {n: g.cpu() for n, g in zip(names, grads)},
            "params": {n: p.cpu() for n, p in (whole[0] if whole else
                                               state.model.state_dict())
                       .items()},
            "held": (held.errors, held.forms) if held else None}


def model_axis_timers() -> _HostTimers:
    """:class:`_HostTimers` of the model axis's collectives, by kind: the
    channel gathers of tensor parallelism (``tp._Gather`` and the backward
    of ``tp.enter``), the halo rows of spatial sharding
    (``spatial._HaloRows``), its group sums (GroupNorm's statistics and the
    pooled mean: ``spatial._ModelGather``, ``spatial._ModelSum``), and the
    batch sums (loss terms and gradients: ``Mesh.sum``)."""
    from mrp_gnn_tpu_torch.parallel import mesh, spatial, tp
    return _HostTimers({
        "channel_gathers": [(tp._Gather, "forward"), (tp._Gather, "backward"),
                            (tp._Enter, "backward")],
        "halo_rows": [(spatial._HaloRows, "forward"),
                      (spatial._HaloRows, "backward")],
        "group_sums": [(spatial._ModelGather, "forward"),
                       (spatial._ModelGather, "backward"),
                       (spatial._ModelSum, "forward"),
                       (spatial._ModelSum, "backward")],
        "batch_sums": [(mesh.Mesh, "sum")]})


def _model_axis_timings(cfg, pctx, dev) -> dict:
    """The step over the ranks (median of MODEL_AXIS_TIMING_STEPS by CUDA
    events on this rank's stream and by host clock, every rank in step,
    after 2 warm steps) and the host time per collective kind over those
    steps."""
    state = train.create_train_state(cfg, dev, pctx.edge_fusion_fn)
    pctx.shard_state(state)
    step = train.make_train_step(cfg, state.model, state.optimizer, pctx)
    args = _first_batch(cfg, dev, pctx)
    for _ in range(2):
        step(state, *args)
    _sync(dev)
    timers = model_axis_timers()
    try:
        times = [_timed_step(lambda: step(state, *args)[1], dev)
                 for _ in range(MODEL_AXIS_TIMING_STEPS)]
    finally:
        timers.close()
    n = len(times)
    return {"step_ms_cuda_events": statistics.median(t[0] for t in times),
            "step_ms_host": statistics.median(t[1] for t in times),
            "collective_host_ms_per_step": {
                k: v * 1e3 / n for k, v in timers.seconds.items()},
            "host_ms_per_step": sum(t[1] for t in times) / n}


def model_axis_rank_main(argv) -> int:
    """One rank of phase 11: ``chip_smoke.py --model-axis-rank MODE R WORLD
    STORE OUT [DEVICE]``. Joins the gloo group, then on ``MODE``'s mesh
    (``MODEL_AXIS_MESHES``) runs the held updates (every kernel call
    against its plain version), the straight ``train.train`` (launch counts
    reset just before it and read just after), the resume from its step-2
    checkpoint, ``evaluate`` with the context and the timings; under
    "spatial" also ``benchmark.bench_scaling`` and ``bench_overlap`` over
    the world. Rank 0 writes ``OUT/rank0.json``, ``OUT/step1.pt`` and
    ``OUT/final.pt`` (whole tensors)."""
    from mrp_gnn_tpu_torch.parallel import launch
    from mrp_gnn_tpu_torch.parallel.tp import is_sharded
    mode = argv[0]
    rank, world, store, out_dir = (int(argv[1]), int(argv[2]), argv[3],
                                   argv[4])
    torch.set_num_threads(1)
    launch.initialize(f"file://{store}", world, rank, backend="gloo")
    dev = launch.rank_device(argv[5] if len(argv) > 5 else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"world": torch.distributed.get_world_size(), "device": str(dev)}
    t0 = time.perf_counter()

    def mark(name):
        torch.distributed.barrier()
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0

    def gathered(obj):
        every = [None] * world
        torch.distributed.all_gather_object(every, obj)
        return every

    ck = os.path.join(out_dir, "ck")
    cfg = model_axis_config(mode, ck)
    pctx = train.make_parallel(cfg, dev)
    m = pctx.mesh
    out["mesh"] = [m.data, m.graph, m.model]
    out["spatial"] = pctx.spatial
    first = _first_update(cfg, dev, pctx, MODEL_AXIS_WRAPPERS[mode])
    out["held"] = gathered(first.pop("held"))
    out["first"] = {"terms": first["terms"], "grad_norm": first["grad_norm"]}
    if rank == 0:
        torch.save(first, os.path.join(out_dir, "step1.pt"))
    mark("held updates")
    # the main path of the phase: counts reset just before, read just after
    bsp.reset_launches()
    with counted_views() as views:
        state, records = train.train(cfg, num_steps=MODEL_AXIS_STEPS,
                                     device=dev)
    out["launches"] = gathered(bsp.launch_counts())
    out["source_views"] = gathered(views[0])
    out["straight"] = _train_terms(records, range(1, MODEL_AXIS_STEPS + 1))
    out["replicated_digests"] = gathered(param_digest_of(
        {n: p for n, p in state.model.named_parameters()
         if not is_sharded(p)}))
    out["local_shapes"] = {n: list(p.shape)
                           for n, p in state.model.named_parameters()}
    whole = pctx.full_tensors(state)
    if rank == 0:
        torch.save(whole[0] if whole else state.model.state_dict(),
                   os.path.join(out_dir, "final.pt"))
        os.makedirs(os.path.join(out_dir, "resume"))
        shutil.copy(os.path.join(ck, "ckpt_2.pt"),
                    os.path.join(out_dir, "resume"))
    mark("train")
    _, records = train.train(cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(out_dir, "resume"))),
        num_steps=MODEL_AXIS_STEPS, device=dev)
    out["resumed"] = _train_terms(records, range(1, MODEL_AXIS_STEPS + 1))
    mark("resume")
    out["eval"] = evaluate(cfg, state.model, pctx=pctx)
    mark("eval")
    out["timings"] = gathered(_model_axis_timings(cfg, pctx, dev))
    mark("timings")
    if mode == "spatial":
        out["scaling"] = benchmark.bench_scaling(
            inner=MODEL_AXIS_BENCH_INNER, device=dev)
        out["overlap"] = benchmark.bench_overlap(
            inner=MODEL_AXIS_BENCH_INNER, device=dev)
        mark("benches")
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def param_digest_of(params: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(params.items()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _leaf_scales(want: dict) -> dict:
    """Each leaf's largest element, or 1% of the whole's largest for a leaf
    that is rounding noise."""
    top = max(float(w.abs().max()) for w in want.values())
    return {n: max(float(w.abs().max()), 1e-2 * top)
            for n, w in want.items()}


def _leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's error relative to :func:`_leaf_scales`."""
    return {n: float((got[n].float() - want[n].float()).abs().max()) / s
            for n, s in _leaf_scales(want).items()}


def _leaf_envelope(first_one: dict, draws: list) -> dict:
    """By "grads" and "params", each leaf's bound: TOL_PARALLEL beyond the
    most that any two of one process's runs (``first_one`` and the draws,
    ``_first_update(draw=)``) disagree on it. The ranks against one process
    are one more such pair, each rounding otherwise. Where a ReLU gate's
    input lies within rounding of 0, the gradient of the weights before it
    jumps when the gate flips, and AdamW's second update from two equal
    gradients, g / (|g| + 1e-8) times the lr, moves an element whose
    gradient is near 1e-8 by a share of the lr."""
    runs = [first_one] + draws
    out = {}
    for key in ("grads", "params"):
        out[key] = {n: TOL_PARALLEL + max(
            float((a[key][n] - b[key][n]).abs().max())
            for a, b in itertools.combinations(runs, 2)) / s
            for n, s in _leaf_scales(first_one[key]).items()}
    return out


def _check_model_axis(mode: str, got: dict, single: list, first_one: dict,
                      envelope: dict, final: dict, dev) -> dict:
    """Phase 11's holds for ``mode`` (see :func:`phase_model_axis`)."""
    d, g, m = MODEL_AXIS_MESHES[mode]
    world = d * g * m
    if (got["world"], got["mesh"], got["spatial"]) != (
            world, [d, g, m], mode == "spatial"):
        raise AssertionError(f"{mode}: ran with world {got['world']}, mesh "
                             f"{got['mesh']}, spatial {got['spatial']}")
    plain = MODEL_AXIS_WRAPPERS[mode]
    shard = _check_shard_kernels([e for e, _ in got["held"]], plain)
    for r, (errors, forms) in enumerate(got["held"]):
        widths = sorted({w for e in errors.values() for w in e["widths"]})
        if MODEL_AXIS_WIDTH[mode] not in widths:
            raise AssertionError(f"{mode} rank {r}: kernel widths {widths}")
        for name, by_width in MODEL_AXIS_FORMS[mode].items():
            for width, form in by_width.items():
                if forms.get(name, {}).get(width) != form:
                    raise AssertionError(f"{mode} rank {r}: {name} at D "
                                         f"{width} took {forms.get(name)}")
    log(f"[model axis] {mode}: each kernel call on every rank's shards vs "
        f"its plain version: max err {json.dumps(shard)}; widths and forms "
        f"on rank 0: {json.dumps(got['held'][0][1])}")
    per = MODEL_AXIS_PER_STEP[mode]
    want = {k: per.get(k, 0) * MODEL_AXIS_STEPS for k in bsp.KERNELS}
    for r, counts in enumerate(got["launches"]):
        if counts != want:
            raise AssertionError(f"{mode} rank {r}'s launches over "
                                 f"{MODEL_AXIS_STEPS} steps: {counts}, "
                                 f"expected {want}")
    log(f"[model axis] {mode}: launches per rank per step, on each of the "
        f"{world} ranks: {json.dumps(per)}")
    if any(got["source_views"]):
        raise AssertionError(f"{mode}: bsp.source_view ran on the ranks: "
                             f"{got['source_views']}")
    log(f"[model axis] {mode}: bsp.source_view calls over "
        f"{MODEL_AXIS_STEPS} steps, by rank: {got['source_views']}")
    if len(set(got["replicated_digests"])) != 1:
        raise AssertionError(f"{mode}: replicated parameters differ across "
                             f"ranks")
    if got["resumed"] != got["straight"][2:]:
        raise AssertionError(f"{mode}: resume {got['resumed']} is not the "
                             f"straight run {got['straight'][2:]}")
    # the held updates against one process's on the same seeded state
    terms_err = _rel_terms(got["first"]["terms"], first_one["terms"])
    norm_err = abs(got["first"]["grad_norm"] - first_one["grad_norm"]) / \
        first_one["grad_norm"]
    straight_err = _rel_terms(got["straight"][0], single[0])
    for what, err in (("first update's terms", terms_err),
                      ("first update's grad norm", norm_err),
                      ("train()'s first step", straight_err)):
        if not err <= TOL_PARALLEL:
            raise AssertionError(f"{mode} {what}: {err} relative")
    leaves, bad = {}, {}
    for key in ("grads", "params"):
        errs = _leaf_errors(got["step1"][key], first_one[key])
        bound = envelope[key]
        bad[key] = {n: (e, bound[n]) for n, e in errs.items()
                    if not e <= bound[n]}
        worst = max(errs, key=errs.get)
        closest = max(errs, key=lambda n: errs[n] / bound[n])
        leaves[key] = {"worst": [worst, errs[worst], bound[worst]],
                       "closest": [closest, errs[closest], bound[closest]]}
    log(f"[model axis] {mode}: by leaf, [leaf, error, bound] of the largest "
        f"error and of the largest share of its bound, for the first step's "
        f"gradients and the parameters after the second update: "
        f"{json.dumps(leaves)}")
    if bad["grads"] or bad["params"]:
        raise AssertionError(f"{mode}: (error, bound) by leaf past its bound:"
                             f" {json.dumps(bad)}")
    for a, b in zip(got["straight"][1:], single[1:]):
        for k in b:
            if k != "step" and not abs(a[k] - b[k]) <= (
                    TOL_MODEL_AXIS_STEPS["atol"]
                    + TOL_MODEL_AXIS_STEPS["rtol"] * abs(b[k])):
                raise AssertionError(f"{mode} train() step {a['step']} {k}: "
                                     f"ranks {a[k]}, one process {b[k]}")
    log(f"[model axis] {mode}: first step's terms within {terms_err:.3e} "
        f"(train(): {straight_err:.3e}) of one process, grad norm "
        f"{norm_err:.3e}; train()'s steps 2-{MODEL_AXIS_STEPS} within "
        f"{json.dumps(TOL_MODEL_AXIS_STEPS)}; each leaf of the first step's "
        f"gradients and of the parameters after the second update (lr "
        f"above 0) within TOL_PARALLEL beyond the most that two of one "
        f"process's {MODEL_AXIS_DRAWS + 1} runs disagree on it; replicated "
        f"parameters equal on every rank; the resume repeats steps 3-4 bit "
        f"for bit")
    for a, b in zip(got["straight"], single):
        log(json.dumps({"metric": "model_axis_terms", "mode": mode,
                        "step": a["step"], "ranks": a, "one_process": b}))
    model = train.create_train_state(model_axis_config(), dev).model
    model.load_state_dict({k: v.to(dev) for k, v in final.items()})
    ev = evaluate(model_axis_config(), model)
    for k in ("rmse", "abs_rel", "delta1", "delta2", "delta3", "miou"):
        bound = TOL_EVAL_ABS + TOL_EVAL_REL * abs(ev[k])
        if abs(got["eval"][k] - ev[k]) > bound:
            raise AssertionError(f"{mode} eval {k}: ranks {got['eval'][k]}, "
                                 f"one process {ev[k]}")
    log(json.dumps({"metric": "model_axis_eval", "mode": mode,
                    "ranks": got["eval"], "one_process": ev}))
    return {"shard_kernels": shard, "terms_err": terms_err,
            "leaves": leaves}


def phase_model_axis(dev, tag: dict, rank_device: str | None = None) -> dict:
    """Phase 11: ``dynamic_swarm`` at full width over ranks of this script
    sharing the one card (gloo), on the model axis: tensor parallelism on a
    1 x 1 x 2 mesh, spatial sharding on a 2 x 1 x 4 mesh. Held, for each:
    every call of the path's kernels (``MODEL_AXIS_WRAPPERS``) on every
    rank's shard tensors within TOL_PARALLEL of its plain version, at the
    path's width (D 4096 a rank under tensor parallelism, 2048 under
    spatial sharding) and form (the fused forward's and the SpMM's vector
    forms); ``train.train`` for MODEL_AXIS_STEPS steps with launch counts
    reset just before it and read just after (``MODEL_AXIS_PER_STEP`` on
    every rank, no other kernel); the replicated parameters bit for bit
    equal on every rank; the resume from step 2 bit for bit; the two held
    updates from the seeded state (``_first_update``) against one
    process's on the same batch (the first step's terms and global norm
    within TOL_PARALLEL relative; each leaf of the first step's gradients
    and of the parameters after the second update, gathered whole, within
    ``_leaf_envelope``'s bound from MODEL_AXIS_DRAWS draws of one process
    on this card); ``train.train``'s first step's terms within
    TOL_PARALLEL relative of one process's run and its later steps within
    TOL_MODEL_AXIS_STEPS; ``evaluate`` with the context within TOL_EVAL of
    one process's evaluation of the ranks' final parameters (the run's
    checkpoint tensors, whole). Printed: the later steps beside one
    process's, the step over the ranks (CUDA events
    and host clock, each rank's median) beside one process's, the host
    time per collective kind, and under spatial sharding the
    ``bench_scaling`` and ``bench_overlap`` records over 8 ranks."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    _, records = train.train(model_axis_config(), num_steps=MODEL_AXIS_STEPS,
                             device=dev)
    single = _train_terms(records, range(1, MODEL_AXIS_STEPS + 1))
    first_one = _first_update(model_axis_config(), dev)
    draws = [_first_update(model_axis_config(), dev, draw=k)
             for k in range(MODEL_AXIS_DRAWS)]
    envelope = _leaf_envelope(first_one, draws)
    for key in envelope:
        worst = max(envelope[key], key=envelope[key].get)
        log(f"[model axis] two of one process's {MODEL_AXIS_DRAWS + 1} runs "
            f"disagree on {key} most at {worst}: "
            f"{envelope[key][worst] - TOL_PARALLEL:.3e} of its largest element")
    cfg = model_axis_config()
    state = train.create_train_state(cfg, dev)
    step = train.make_train_step(cfg, state.model, state.optimizer)
    args = _first_batch(cfg, dev)
    for _ in range(2):
        step(state, *args)
    times = [_timed_step(lambda: step(state, *args)[1], dev)
             for _ in range(MODEL_AXIS_TIMING_STEPS)]
    one_step = {"step_ms_cuda_events": statistics.median(t[0] for t in times),
                "step_ms_host": statistics.median(t[1] for t in times)}
    log(f"[model axis] one process: {MODEL_AXIS_STEPS} steps, the first "
        f"update and the step timed in {time.perf_counter() - t0:.2f} s")
    res, failed = {}, []
    for mode, (d, g, m) in MODEL_AXIS_MESHES.items():
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{mode}_") as tmp:
            t0 = time.perf_counter()
            spawn_parallel_ranks(tmp, rank_device, world=d * g * m,
                                 mode=("--model-axis-rank", mode))
            ranks_s = time.perf_counter() - t0
            with open(os.path.join(tmp, "rank0.json")) as f:
                got = json.load(f)
            got["step1"] = torch.load(os.path.join(tmp, "step1.pt"),
                                      weights_only=True)
            final = torch.load(os.path.join(tmp, "final.pt"),
                               weights_only=True)
        log(f"[model axis] {mode}: {d * g * m} ranks in {ranks_s:.2f} s "
            f"(their barriers: {json.dumps(got['seconds'])})")
        try:
            res[mode] = _check_model_axis(mode, got, single, first_one,
                                          envelope, final, dev)
        except AssertionError as e:  # the other mode still runs; then raise
            failed.append(f"{mode}: {e}")
            log(f"[model axis] {mode} failed: {e}")
            continue
        log(json.dumps({
            "metric": "model_axis_step", "mode": mode, "mesh": got["mesh"],
            "transport": "gloo through host memory, ranks sharing one card "
                         "(not how a multi-card deployment runs)",
            "timing": "per rank: median step by CUDA events on its stream "
                      "and by host clock; host ms per step in each kind of "
                      "collective",
            "ranks": got["timings"], "one_process": one_step,
            "launches_per_rank_per_step": MODEL_AXIS_PER_STEP[mode], **tag}))
        for rec in got.get("scaling", []) + got.get("overlap", []):
            log(json.dumps({"metric": "model_axis_bench", **rec, **tag}))
    log(f"[model axis] phase {time.perf_counter() - t_phase:.2f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    with phase("device"):
        info = phase_device()
    tag = {"gpu": info["gpu"], "nvidia_smi": info["nvidia_smi"]}
    with phase("build"):
        phase_build(list(bsp.SOURCES))
    with phase("kernels vs plain"):
        kin = phase_kernels(dev)
        tk = phase_train_kernels(dev)
        nk = phase_new_kernels(dev)
        bk = phase_block_kernels(dev)
        ek = phase_ell_kernels(dev)
        bk2 = phase_bsp2_kernels(dev)
        fk = phase_form_kernels(dev)
        gk = phase_gather_kernels(dev, ek, bk2)
        sk = phase_softmax_form_kernels(dev, ek, bk2)
    m = swarm_config().model
    h = m.num_fusion_layers * m.attention_heads
    L = m.num_fusion_layers
    mb = block_config().model
    hb = mb.num_fusion_layers * mb.attention_heads
    check_block_batches(block_config())
    ell_per = {"ell_sddmm": h, "ell_softmax": h, "ell_spmm": h}
    # path: (config, launches per request, launches per train step,
    # edge_fusion_fn)
    paths = {
        "attention": (swarm_config(), {"bsp_fused_attention": h},
                      {"bsp_fused_attention": h, "bsp_sddmm": h,
                       "bsp_spmm": h, "bsp_spmm_t2": h}, None),
        "hideg": (hideg_config(), {"bsp_fused_parts": h},
                  {"bsp_fused_parts": h, "bsp_sddmm": h, "bsp_spmm": h,
                   "bsp_spmm_t2": h}, None),
        "mean": (swarm_config("mean"), {"bsp_spmm": L},
                 {"bsp_spmm": L, "bsp_spmm_t": L}, None),
        "max": (swarm_config("max"), {"ell_max": L}, {"ell_max": L}, None),
        "block": (block_config(), {"block_attention": hb},
                  {"block_attention": hb}, kernel_swap(edge.with_block_kernel)),
        "ell": (swarm_config(), ell_per, ell_per,
                kernel_swap(ell.with_ell_kernels)),
        "bsp2": (native_swarm_config(), {"bsp_weights": h, "bsp_spmm": h},
                 {"bsp_weights": h, "bsp_spmm": 2 * h, "bsp_sddmm": h,
                  "bsp_spmm_t": 2 * h}, kernel_swap(bsp.with_bsp_attention)),
    }
    serve, tr = {}, {}
    with phase("serving"):
        for path, (cfg, per_request, _, fn) in paths.items():
            serve[path] = phase_serving(dev, cfg, per_request, path, fn)
    with phase("training"):
        for path, (cfg, _, per_step, fn) in paths.items():
            tr[path] = phase_train(dev, cfg, per_step, path, fn)
    with phase("timings"):
        kernels = [phase_timings(kin, serve["attention"], tag)]
        kernels += phase_train_kernel_timings(tk, tag)
        kernels += phase_new_kernel_timings(nk, tag)
        kernels += phase_block_timings(bk, tag)
        kernels += phase_ell_timings(ek, tag)
        kernels += phase_bsp2_timings(bk2, tag)
        phase_spmm_form_timings(gk, tag)
        phase_softmax_form_timings(sk, tag)
        phase_form_timings(fk, tag)
        phase_spmm_t_form_timings(tk, bk2, tag)
        phase_variant_timings(kin, ek, tag)
        check_path_bodies("attention", phase_train_timings(tr["attention"],
                                                           tag),
                          "train profile")
        for path in ("hideg", "mean", "max", "block", "ell", "bsp2"):
            served = predictor_timings(serve[path], tag, path)
            trained = phase_train_timings(tr[path], tag, loop=path == "bsp2",
                                          inner=10)
            if path in PATH_BODIES:
                check_path_bodies(path, served, "serving profile")
                check_path_bodies(path, trained, "train profile")
    with phase("lifecycle"):
        phase_lifecycle(dev, tag)
    with phase("export"):
        phase_export(dev, serve, {p: v[1] for p, v in paths.items()}, tag)
    with phase("data"):
        phase_data(dev, tag)
    with phase("numerics"):
        phase_numerics(dev, tag)
    with phase("parallel"):
        phase_parallel(dev, tag)
    with phase("model axis"):
        phase_model_axis(dev, tag)
    # Each kernel's launches come from the training path that runs it.
    own_path = {"bsp_fused_parts": "hideg", "ell_max": "max",
                "block_attention": "block", "ell_sddmm": "ell",
                "ell_softmax": "ell", "ell_spmm": "ell",
                "bsp_weights": "bsp2", "bsp_spmm_t": "bsp2",
                "bsp_spmm_t2": "hideg"}
    for k in kernels:
        k["launches"] = tr[own_path.get(k["name"], "attention")]["launches"][k["name"]]
    if sorted(k["name"] for k in kernels) != sorted(bsp.KERNELS):
        raise AssertionError("the kernels line must list every wrapper once")
    log(f"[phase] total: {time.perf_counter() - t_start:.2f} s")
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--model-axis-rank"]:
        sys.exit(model_axis_rank_main(sys.argv[2:]))
    sys.exit(main())
