"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

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
from one launch of the dual transposed SpMM.

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
   parts kernel at the hideg shapes and the masked max at the preset's, and
   both on a crafted graph with a degree-200 row (f32 and bf16; the max bit
   for bit, NaN in giving NaN out), with the gradients of their Functions;
   the block attention at the JAX benchmark's shape (1,024 scenes of 8,
   dk 64, D 2048), at the block path's and on 2 scenes of 256 with padded
   nodes (f32 and bf16, with the gradients of its Function); the ELL
   SDDMM, softmax and SpMM at the ell path's first train batch and on the
   crafted graphs of degree 100 and 200, with their attention's gradients;
   the weights kernel at the bsp2 path's first train batch and on the
   crafted graph with a tight and a padded tile-pair plan, with the
   gradients of its Function and of the two-kernel attention; the dual
   transposed SpMM bit for bit against two single launches at the
   attention backward's shapes and on the hideg path's expanded view;
4. serving: for each path, three eval batches through ``Predictor``,
   checked for range, for the kernel launches of each request, and against
   the same Predictor with the plain ops;
5. training: for each path, three steps of ``train.make_train_step`` on the
   first three train batches, checked for finite losses and grad norms, for
   the launches of every kernel per step, and against the same three steps
   with the plain ops on the card;
6. timings (medians): each kernel beside its bound, its plain version and
   a library yardstick; the block kernel against the einsum route at the
   benchmark's shape, forward and value gradient; the dual transposed SpMM
   against two single launches, in turns; the Predictor's device-side batch latency and whole-request
   latency; the train step's device time with the kernels and with the
   plain ops, one whole step through ``train()`` (host clock, data
   included; numpy renderer on the attention path, native renderer and
   builder on the bsp2 path's config), peak memory, and profiler
   breakdowns of device time by kernel.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch import train
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data import graph_native, native
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.graph import batch_fully_connected, build_graph_batch
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
from mrp_gnn_tpu_torch.ops import _build, bsp, edge, ell
from mrp_gnn_tpu_torch.ops import reference as R
from mrp_gnn_tpu_torch.serving import Predictor

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
TOL_F32 = 2e-5               # kernel vs plain, f32: sums in another order
TOL_BF16_REL = 2.0 ** -7     # bf16 outputs: one bf16 ulp, relative
TOL_SERVE_DEPTH_M = 1e-3     # kernel vs plain ops through the whole net, metres
TOL_TRAIN_REL = 1e-5         # train loss terms and grad norms, kernels vs plain
# Function gradients vs autograd through the plain version, relative to the
# largest gradient: f32 sums in another order; with bf16 values the plain
# autograd rounds each slot's value gradient to bf16 before summing them.
TOL_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
PORT_KERNEL_BODIES = ("fused_attention_kernel", "sddmm_kernel", "spmm_kernel",
                      "spmm_t_kernel", "spmm_t2_kernel", "fused_parts_kernel",
                      "weights_kernel", "ell_max_kernel", "ell_softmax_kernel",
                      "block_attention_kernel")
HIDEG_ROBOTS, HIDEG_SCENES, HIDEG_SLOTS = 193, 2, 512
# The edge block of the JAX package's benchmark (bench.py: V 8192 in
# fully connected 8-robot scenes, D 2048, dk 64).
BENCH_SCENES, BENCH_ROBOTS, BENCH_D, BENCH_DK = 1024, 8, 2048, 64
LOOP_STEPS = 12  # steps of each train() loop timing


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


def profiled(fn, n: int, tries: int = 5):
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
    return {"graph": g, "q": q, "k": k, "v": v, "errs": errs}


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


def check_parts(x: dict, tag: str, errs: dict | None = None) -> None:
    """The parts kernel against its plain version on the expanded view of
    ``x["graph"]`` (f32 and bf16 values), the whole expanded attention
    against the plain attention, and its Function's gradients."""
    g = x["graph"]
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q_s, kf = bsp._scaled(x["q"], x["k"])
    q_x = q_s.repeat_interleave(xp.rows, dim=0)
    empty = ~mask_x.any(dim=1)
    for dt in (torch.float32, torch.bfloat16):
        v = x["v"].to(dt)
        acc, m, l = bsp.fused_attention_parts(q_x, kf, v, src_x, mask_x)
        want = bsp.fused_attention_parts_reference(q_x, kf, v, src_x, mask_x)
        torch.cuda.synchronize()
        name = f"{tag} values {dt}"
        # acc and l sum up to W weights <= 1: f32 error grows with sqrt(W)
        err = check_kernel_vs_plain(f"bsp_fused_parts acc, {name}", acc,
                                    want[0], False, scale=xp.width ** 0.5)
        check_kernel_vs_plain(f"bsp_fused_parts m, {name}", m, want[1], False)
        check_kernel_vs_plain(f"bsp_fused_parts l, {name}", l, want[2], False,
                              scale=xp.width ** 0.5)
        if not (bool((m[empty] == bsp._NEG).all()) and bool((l[empty] == 0).all())
                and bool((acc[empty] == 0).all())):
            raise AssertionError("expanded rows without a valid slot must "
                                 "give m = -1e30, l = 0 and acc = 0")
        out = bsp.expanded_attention_fused(x["q"], x["k"], v, g)
        check_kernel_vs_plain(
            f"expanded_attention_fused, {name}", out,
            bsp.bsp_attention_fused_reference(x["q"], x["k"], v, g),
            dt == torch.bfloat16)
        if errs is not None and dt == torch.float32:
            errs["bsp_fused_parts"] = err
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
    (8 scenes of 5, D 8192) and on 2 scenes of 256 nodes with padded nodes
    (D 1030: the scalar path; several passes of 8 destinations); a scene
    past 256 nodes raises."""
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


def backward_view(x: dict, expanded: bool) -> dict:
    """The transposed SpMMs' operands of the attention backward on
    ``x["graph"]``: over its ELL lists, or over its row-expanded view (q_s
    and the cotangent repeated R times, alpha and dlog split into rows)."""
    g = x["graph"]
    src, mask = g.ell_src, g.ell_mask
    q_s, ct, alpha, dlog = x["q_s"], x["ct"], x["alpha"], x["dlog"]
    if expanded:
        xp = g.bsp_expanded
        src, mask = bsp.expand_ell_view(src, mask, xp.rows, xp.width)
        alpha, dlog = (bsp._expand_rows(t, xp.rows, xp.width)
                       for t in (alpha, dlog))
        q_s, ct = (t.repeat_interleave(xp.rows, dim=0) for t in (q_s, ct))
    return {"src": src, "mask": mask, "q_s": q_s, "ct": ct, "alpha": alpha,
            "dlog": dlog, "V": g.max_nodes,
            "view": bsp.source_view(src, mask, g.max_nodes)}


def check_spmm_t2(x: dict, tag: str, expanded: bool = False) -> float:
    """The dual transposed SpMM as the attention backward calls it, (alpha,
    cotangent) -> dvalues and (dlog, q_s) -> dk, bit for bit against two
    single launches and within tolerance of its plain version, with f32 and
    bf16 values. Returns the f32 max abs err."""
    b = backward_view(x, expanded)
    src, mask, V, view = b["src"], b["mask"], b["V"], b["view"]
    err = 0.0
    for vdt in (torch.float32, torch.bfloat16):
        ct = b["ct"].to(vdt)
        dv, dk = bsp.spmm_t2(b["alpha"], ct, b["dlog"], b["q_s"], src, mask,
                             V, vdt, torch.float32, view)
        one = bsp.spmm_t(b["alpha"], ct, src, mask, V, vdt, view)
        two = bsp.spmm_t(b["dlog"], b["q_s"], src, mask, V, torch.float32,
                         view)
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
    path's expanded view."""
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
                              check_spmm_t2(xh, "hideg expanded view",
                                            expanded=True))
    return {"inputs": x, "hideg": xh, "errs": errs}


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
    terms = []
    for i, x in enumerate(inputs):
        before = bsp.launch_counts()
        state, t = step(state, *x)
        got = _delta(before, bsp.launch_counts())
        if got != want:
            raise AssertionError(f"{path} train step {i}: launches {got}, "
                                 f"expected {want}")
        terms.append(t)
    launches = bsp.launch_counts()  # the training path ends here
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

    predictor_timings(serve, tag, "attention")
    return {"name": "bsp_fused_attention", "route": "cuda",
            "source": "mrp_gnn_tpu_torch/ops/csrc/bsp_fused_attention.cu",
            "replaces": "mrp_gnn_tpu/ops/pallas_bsp.py:707",
            "max_abs_err": kin["errs"]["torch.float32"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms}


def predictor_timings(serve: dict, tag: dict, path: str) -> None:
    """Device-side batch latency (CUDA events), whole-request latency (host
    clock) and a profiler breakdown of the Predictor on one eval batch."""
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
    profile_device(lambda: pred(batch["images"]), 5, "predictor_profile",
                   "requests", {"path": path, **tag})


def time_kernel(name, src_file, replaces, shape, fn, plain, library,
                lib_name, bound, err, tag) -> dict:
    """One kernel at one shape: device time per call (profiler) of the
    kernel, its plain version and the library yardstick, back-to-back CUDA
    events beside them, and its bound. Returns its entry of the kernels
    line."""
    ms, plain_ms, library_ms = (device_ms(f) for f in (fn, plain, library))
    call_ms = {"kernel": cuda_ms(fn), "plain": cuda_ms(plain, reps=7),
               "library": cuda_ms(library)}
    b_ms, b_by, n_bytes, flops = bound
    log(json.dumps({"metric": "kernel_time", "kernel": name,
                    "shape": shape, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library": lib_name,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                    "flops": flops, "l2": "warm (back-to-back launches)",
                    "timing": "ms, plain_ms, library_ms: device time per "
                              "call (profiler); call_ms: back-to-back "
                              "calls (CUDA events)",
                    "call_ms": call_ms, **tag}))
    return {"name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def dense_mask(g) -> torch.Tensor:
    """The graph's edges as a dense [V, V] mask, for the SDPA yardstick."""
    V = g.max_nodes
    allowed = torch.zeros(V, V, dtype=torch.bool, device=g.ell_src.device)
    rows = torch.arange(V, device=g.ell_src.device)[:, None].expand_as(g.ell_src)
    allowed[rows[g.ell_mask], g.ell_src.long()[g.ell_mask]] = True
    return allowed


def phase_new_kernel_timings(nk: dict, tag: dict) -> list:
    """The parts kernel at the hideg path's shapes and the masked max at the
    max path's (f32), beside their bounds, plain versions and yardsticks."""
    x = nk["inputs"]
    g = x["graph"]
    xp = g.bsp_expanded
    src_x, mask_x = bsp.expand_ell_view(g.ell_src, g.ell_mask, xp.rows,
                                        xp.width)
    q, k, v = x["q"], x["k"], x["v"]
    q_s, kf = bsp._scaled(q, k)
    q_x = q_s.repeat_interleave(xp.rows, dim=0)
    edges = int(mask_x.sum())
    D, dk = v.shape[1], q.shape[1]
    allowed = dense_mask(g)
    parts_out = (torch.empty(q_x.shape[0], D, device=v.device),
                 torch.empty(q_x.shape[0], device=v.device),
                 torch.empty(q_x.shape[0], device=v.device))
    out = [time_kernel(
        "bsp_fused_parts", "mrp_gnn_tpu_torch/ops/csrc/bsp_fused_parts.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:1187",
        {"V": g.max_nodes, "rows": xp.rows, "width": xp.width, "dk": dk,
         "D": D, "edges": edges, "dtype": "float32"},
        lambda: bsp.fused_attention_parts(q_x, kf, v, src_x, mask_x),
        lambda: bsp.fused_attention_parts_reference(q_x, kf, v, src_x, mask_x),
        lambda: F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None],
            attn_mask=allowed[None, None])[0, 0],
        "F.scaled_dot_product_attention, dense [V, V] mask (the whole "
        "normalised attention)",
        bound_ms((q_x, kf, v, src_x, mask_x), parts_out,
                 edges * (2 * dk + 1 + 2 * D)),
        nk["errs"]["bsp_fused_parts"], tag)]
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
    filled = logits.masked_fill(~mask, bsp._NEG)
    out = []
    for name, src_file, replaces, shp, fn, plain, lib, lib_name, bound in (
            ("ell_sddmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_sddmm.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:268", {"d": dk},
             lambda: ell.sddmm(q_s, kf, src, mask),
             lambda: bsp.sddmm_reference(q_s, kf, src, mask),
             lambda: torch.sparse.sampled_addmm(pattern, q_s, kT, beta=0.0),
             "torch.sparse.sampled_addmm on the deduplicated [V, V] pattern",
             bound_ms((q_s, kf, src, mask), (logits,), 2 * edges * dk)),
            ("ell_softmax", "mrp_gnn_tpu_torch/ops/csrc/ell_softmax.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:355", {},
             lambda: ell.softmax(logits, mask),
             lambda: bsp.masked_softmax(logits, mask),
             lambda: torch.softmax(filled, dim=-1),
             "torch.softmax of the logits filled with -1e30 on masked slots",
             bound_ms((logits, mask), (logits,), 5 * V * deg)),
            ("ell_spmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm.cu",
             "mrp_gnn_tpu/ops/pallas_ell.py:47", {"D": D},
             lambda: ell.spmm(alpha, v, src, mask),
             lambda: bsp.spmm_reference(alpha, v, src, mask),
             lambda: torch.sparse.mm(a_csr, v),
             "torch.sparse.mm(CSR of the weights, values)",
             bound_ms((alpha, v, src, mask), (v,), 2 * edges * D))):
        out.append(time_kernel(name, src_file, replaces, {**shape, **shp}, fn,
                               plain, lib, lib_name, bound, ek["errs"][name],
                               tag))
    return out


def phase_bsp2_timings(bk2: dict, tag: dict) -> list:
    """The weights kernel at the bsp2 path's first train batch and the dual
    transposed SpMM at the hideg path's expanded view (f32), beside their
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
        bk2["errs"]["bsp_weights"], tag)]

    def operands(xx, expanded):
        b = backward_view(xx, expanded)
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
                                   b["src"], b["mask"], b["V"], view=b["view"])

    def separate(b):
        return lambda: (
            bsp.spmm_t(b["alpha"], b["ct"], b["src"], b["mask"], b["V"],
                       view=b["view"]),
            bsp.spmm_t(b["dlog"], b["q_s"], b["src"], b["mask"], b["V"],
                       view=b["view"]))

    h = operands(bk2["hideg"], True)
    D = h["ct"].shape[1]
    dv_out = torch.empty(h["V"], D, device=src.device)
    dk_out = torch.empty(h["V"], dk, device=src.device)
    out.append(time_kernel(
        "bsp_spmm_t2", "mrp_gnn_tpu_torch/ops/csrc/bsp_spmm_t.cu",
        "mrp_gnn_tpu/ops/pallas_bsp.py:537",
        {"V": h["V"], "rows": h["src"].shape[0], "width": h["src"].shape[1],
         "D1": D, "D2": dk, "edges": h["edges"], "dtype": "float32",
         "use": "dvalues and dk of the hideg backward"},
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
    for label, b in (("hideg", h), ("bsp2", operands(x, False))):
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
                              "bsp_spmm_t launches over the same view; turns "
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
    view = bsp.source_view(src, mask, V)
    out = []

    def record(*args):
        out.append(time_kernel(*args, tk["errs"][args[0]], tag))

    # SDDMM, dual form: (q_s, k) and (g, values), as the backward calls it.
    pattern = _csr(rows, cols, torch.ones(edges, device=src.device), (V, V))
    kT, vT = kf.t().contiguous(), v.t().contiguous()
    record("bsp_sddmm", "mrp_gnn_tpu_torch/ops/csrc/bsp_sddmm.cu",
           "mrp_gnn_tpu/ops/pallas_bsp.py:377",
           {"V": V, "deg": deg, "d1": dk, "d2": D, "edges": edges,
            "form": "dual", "dtype": "float32"},
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
            "dtype": "float32"},
           lambda: bsp.spmm_t(alpha, ct, src, mask, V, view=view),
           lambda: bsp.spmm_t_reference(alpha, ct, src, mask, V),
           lambda: torch.sparse.mm(wt_csr, ct),
           "torch.sparse.mm(CSR of w transposed, x)",
           bound_ms((alpha, ct, src, mask), (ct,), 2 * edges * D))
    leaves = [t.detach().requires_grad_() for t in (q_s, kf, v)]
    parts = {
        "spmm_t_dk": lambda: bsp.spmm_t(dlog, q_s, src, mask, V, view=view),
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
                        inner: int = 20) -> None:
    """Device-side train step (one fixed batch on the card, CUDA events),
    kernels and plain ops in turns; peak memory; with ``loop``, one whole
    step through ``train()`` by host clock; a profiler breakdown over 5
    steps."""
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
    profile_device(kernels, 5, "train_profile", "steps", {"path": path, **tag})


def profile_device(fn, n: int, metric: str, unit: str, tag: dict) -> None:
    """Device time by kernel over ``n`` calls of ``fn`` (:func:`profiled`),
    and the share of the window with no device work (host clock, profiler
    on)."""
    events, wall_us = profiled(fn, n)
    kern = sorted(((e.key, e.self_device_time_total, e.count) for e in events),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    ours = {}
    for key, t, _ in kern:
        for body in PORT_KERNEL_BODIES:
            if f"{body}<" in key or f"{body}(" in key:
                ours[body] = ours.get(body, 0.0) + t / 1e3
    log(json.dumps({"metric": metric, unit: n,
                    "window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1 - busy / wall_us,
                    "port_kernels_ms": ours,
                    "top_kernels": [{"name": k[:90], "ms": t / 1e3,
                                     "share": t / busy, "calls": c}
                                    for k, t, c in kern[:16]], **tag}))


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
        phase_train_timings(tr["attention"], tag)
        for path in ("hideg", "mean", "max", "block", "ell", "bsp2"):
            predictor_timings(serve[path], tag, path)
            phase_train_timings(tr[path], tag, loop=path == "bsp2", inner=10)
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
    sys.exit(main())
