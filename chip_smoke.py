"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: every CUDA kernel of the path, compiled with nvcc for sm_90a;
3. each kernel against its plain torch version on the card: the first
   ``dynamic_swarm`` eval batch at full shapes (f32 and bf16 values) and a
   crafted graph with empty rows, duplicate edges, padded nodes and a
   feature width that takes the kernel's scalar path;
4. serving: ``dynamic_swarm`` at full width (64x64 images, encoder
   32/64/128, 8 scenes x 32 robots, 6 classes, numpy renderer) with random
   seeded weights; three eval batches through ``Predictor``, checked for
   range, for one kernel launch per fusion layer and head per request, and
   against the same Predictor with the plain ops;
5. timings with CUDA events (medians): each kernel beside its bound, its
   plain version and a library yardstick; the Predictor's device-side batch
   latency and its whole-request latency (host clock); a profiler breakdown
   of device time by kernel over five requests.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.graph import build_graph_batch
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.ops import _build, bsp
from mrp_gnn_tpu_torch.serving import Predictor

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
TOL_F32 = 2e-5               # kernel vs plain, f32: sums in another order
TOL_BF16_REL = 2.0 ** -7     # bf16 outputs: one bf16 ulp, relative
TOL_SERVE_DEPTH_M = 1e-3     # kernel vs plain ops through the whole net, metres


def log(msg: str) -> None:
    print(msg, flush=True)


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


def swarm_config():
    cfg = get_config("dynamic_swarm")
    return cfg.replace(data=dataclasses.replace(cfg.data, renderer="numpy"))


def attention_inputs(V: int, dk: int, D: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(V, dk)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(size=(V, dk)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dev)
    return q, k, v


def crafted_graph():
    """Empty rows, duplicate edges, a wide row (deg 100) and padded nodes."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5],    # src (1->0 twice, 5->4 x3)
                  [0, 0, 0, 1, 2, 4, 4, 4]])   # dst; node 3 has no in-edge
    wide_src = np.arange(100) % 12             # node 0 of scene 1: deg 100
    b = np.stack([wide_src, np.zeros(100, np.int64)])
    return build_graph_batch([a, b], [6, 12], max_nodes=32, max_edges=128)


def check_kernel_vs_plain(name, got, want, bf16: bool) -> float:
    err = float((got.float() - want.float()).abs().max())
    if bf16:
        ok = torch.allclose(got.float(), want.float(), rtol=TOL_BF16_REL,
                            atol=1e-6)
        tol = f"rtol {TOL_BF16_REL} (one bf16 ulp)"
    else:
        ok = err <= TOL_F32
        tol = f"atol {TOL_F32}"
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


def phase_serving(dev) -> dict:
    cfg = swarm_config()
    cfg_plain = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                         ops_impl="xla"))
    m = cfg.model
    per_request = m.num_fusion_layers * m.attention_heads
    model = MultiRobotPerceptionNet(
        m, ops_impl=cfg.parallel.ops_impl,
        generator=torch.Generator().manual_seed(0)).to(dev)
    batches = []
    it = iter(make_dataset(cfg.data, "eval", shuffle=False))
    for _ in range(3):
        batches.append(next(it))
    bsp.fused_attention.launches = 0  # main path starts here
    outs = []
    for i, b in enumerate(batches):
        pred = Predictor(cfg, model, graph=b["graph"])
        before = bsp.fused_attention.launches
        out = pred(b["images"])
        got = bsp.fused_attention.launches - before
        if got != per_request:
            raise AssertionError(f"request {i}: {got} kernel launches, "
                                 f"expected {per_request}")
        outs.append(out)
    launches = bsp.fused_attention.launches  # main path ends here
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")
    max_err = 0.0
    for i, (b, out) in enumerate(zip(batches, outs)):
        d, s = out["depth"], out["seg"]
        V = b["graph"].max_nodes
        if d.shape != (V,) + cfg.data.image_size or s.shape != d.shape:
            raise AssertionError(f"request {i}: bad shapes {d.shape} {s.shape}")
        if not np.isfinite(d).all() or not ((d > m.min_depth) & (d < m.max_depth)).all():
            raise AssertionError(f"request {i}: depth out of range "
                                 f"[{d.min()}, {d.max()}]")
        if s.min() < 0 or s.max() >= m.num_seg_classes:
            raise AssertionError(f"request {i}: seg out of range")
        plain = Predictor(cfg_plain, model, graph=b["graph"])(b["images"])
        err = float(np.abs(plain["depth"] - d).max())
        agree = float((plain["seg"] == s).mean())
        max_err = max(max_err, err)
        log(f"[serve] request {i}: depth [{d.min():.4f}, {d.max():.4f}] m, "
            f"vs plain ops max abs err {err:.3e} m (tol {TOL_SERVE_DEPTH_M}),"
            f" seg agreement {agree:.6f}")
        if err > TOL_SERVE_DEPTH_M:
            raise AssertionError(f"request {i}: kernel path disagrees with "
                                 "the plain ops")
    log(f"[serve] 3 requests served, kernel launches {launches} "
        f"({per_request} per request)")
    return {"model": model, "cfg": cfg, "batches": batches,
            "launches": {"bsp_fused_attention": launches},
            "depth_err": max_err}


def fused_attention_bound_ms(q, k, v, ell_src, ell_mask) -> tuple:
    """Least time for the function on an H100 from this run's inputs:
    each input read once and the output written once, against the valid
    edges' f32 work (logits, exp, weighted sum)."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (q, k, v, ell_src, ell_mask)) + v.numel() * v.element_size()
    edges = int(ell_mask.sum())
    flops = edges * (2 * q.shape[1] + 1 + 2 * v.shape[1])
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def phase_timings(kin: dict, serve: dict, tag: dict) -> list:
    g, q, k, v = kin["graph"], kin["q"], kin["k"], kin["v"]
    q_s, kf = bsp._scaled(q, k)
    args = (q_s, kf, v, g.ell_src, g.ell_mask)
    ms = cuda_ms(lambda: bsp.fused_attention(*args))
    plain_ms = cuda_ms(lambda: bsp.fused_attention_reference(*args))
    # Yardstick: dense masked SDPA over [V, V] (same function when the
    # graph has no duplicate edges); timed here, never called by the port.
    V = q.shape[0]
    allowed = torch.zeros(V, V, dtype=torch.bool, device=q.device)
    rows = torch.arange(V, device=q.device)[:, None].expand_as(g.ell_src)
    allowed[rows[g.ell_mask], g.ell_src.long()[g.ell_mask]] = True
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None, None], k[None, None], v[None, None],
        attn_mask=allowed[None, None])[0, 0]
    library_ms = cuda_ms(sdpa)
    has = allowed.any(dim=1)
    sdpa_err = float((sdpa()[has] - bsp.fused_attention(*args)[has]).abs().max())
    bound_ms, bound_by, n_bytes, flops = fused_attention_bound_ms(*args)
    line = {"metric": "kernel_time", "kernel": "bsp_fused_attention",
            "shape": {"V": V, "deg": int(g.ell_src.shape[1]),
                      "dk": int(q.shape[1]), "D": int(v.shape[1]),
                      "values": "float32", "edges": int(g.ell_mask.sum())},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention, dense [V, V] mask",
            "library_max_abs_err_vs_kernel": sdpa_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
            "flops": flops, "l2": "warm (back-to-back launches)", **tag}
    log(json.dumps(line))

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
    log(json.dumps({"metric": "predictor_batch", "config": "dynamic_swarm",
                    "views_per_batch": pred.batch_nodes,
                    "batch_latency_ms": lat * 1e3,
                    "views_per_s": pred.batch_nodes / lat,
                    "runs_latency_ms": [r["batch_latency_s"] * 1e3 for r in runs],
                    "request_ms_median": statistics.median(req),
                    "request_ms_max": req[-1], "requests": len(req), **tag}))
    phase_profile(pred, batch["images"], tag)
    return [{"name": "bsp_fused_attention", "route": "cuda",
             "source": "mrp_gnn_tpu_torch/ops/csrc/bsp_fused_attention.cu",
             "replaces": "mrp_gnn_tpu/ops/pallas_bsp.py:707",
             "launches": serve["launches"]["bsp_fused_attention"],
             "max_abs_err": kin["errs"]["torch.float32"],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}]


def phase_profile(pred, images, tag: dict) -> None:
    """Device time by kernel over 5 requests (torch.profiler, CUPTI), and the
    share of the window with no device work (host clock, profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        pred(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            pred(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    log(json.dumps({"metric": "predictor_profile", "requests": 5,
                    "window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1 - busy / wall_us,
                    "top_kernels": [{"name": n[:90], "ms": t / 1e3,
                                     "share": t / busy, "calls": c}
                                    for n, t, c in kern[:14]], **tag}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = phase_device()
    tag = {"gpu": info["gpu"], "nvidia_smi": info["nvidia_smi"]}
    phase_build(["bsp_fused_attention"])
    kin = phase_kernels(dev)
    serve = phase_serving(dev)
    kernels = phase_timings(kin, serve, tag)
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
