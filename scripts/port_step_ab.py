"""Serving and training times of the PyTorch port's paths, for an A/B of two
checkouts on one CUDA card, each turn in a process of its own.

    python3 scripts/port_step_ab.py --ab PARENT_DIR CHANGE_DIR [--paths ...]
    python3 scripts/port_step_ab.py --root DIR --path mean

One turn (``--root``) imports ``mrp_gnn_tpu_torch`` from ``DIR``, builds its
CUDA kernels and, with random seeded weights, times on the path's first
batches (numpy renderer and graph builder, but for bsp2):

- the train step (``train.make_train_step``) with CUDA events: the median
  over 5 repetitions of the mean of 10 back-to-back steps, after 3 warm-up
  steps; and its device busy time per step (profiler, 5 steps after 5);
- the Predictor's batch latency (``Predictor.throughput``, CUDA events): the
  median of 5 runs of 20 batches; and its device busy time per request
  (profiler, 5 device-side forwards of one eval batch after 5, the images
  already on the card, so no host-device copy is counted);
- on the bsp2 and ell paths, the device time per call (profiler, 30 calls
  after 30) of the path's softmax kernel on the first train batch's ELL
  lists, with seeded random operands: the attention weights
  (``bsp.attention_weights``, dk the model's) on bsp2, the ELL softmax
  (``ell.softmax``) on ell;
- on the bsp2 path, the whole loop: ``train.train`` on its config (the
  native host side, the default fused attention) for LOOP_STEPS steps,
  the median of the records' ``step_time_s`` after the first (host clock,
  the next batch's render, graph build and copy included).

Paths: "mean", "max" and "attention" (``dynamic_swarm`` with that
``model.fusion``), "ell" (``dynamic_swarm`` with the plan-free ELL
attention swapped in through ``edge_fusion_fn``), "block"
(``multitask_batched`` with the block kernel swapped in the same way; both
as chip_smoke.py does), "hideg" (2 fully connected scenes of 193 robots
in 512 node slots: the high-degree attention) and "bsp2"
(``dynamic_swarm`` on the native renderer and graph builder, with the
two-kernel attention, ``bsp.with_bsp_attention``, swapped in, as
chip_smoke.py's bsp2 path). A turn prints one JSON line.

``--ab`` runs, for each path, the turns PARENT, CHANGE, CHANGE, PARENT, then
one JSON line with each label's times. The card's name and power limit go
beside every line. Steps of these sizes are launch-bound and drift inside
one long process, so compare two trees only within one call, by turns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPS, INNER = 5, 10
LOOP_STEPS = 12
PATHS = ("mean", "max", "attention", "ell", "block", "hideg", "bsp2")


def kernel_swap(swap):
    """An ``edge_fusion_fn`` that runs ``swap(ops)`` on the kernel backend
    and the ops as they are otherwise (chip_smoke.kernel_swap)."""
    from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion

    def edge_fusion(ops, aggregation, q, k, values, graph):
        if ops.impl == "pallas":
            ops = swap(ops)
        return default_edge_fusion(ops, aggregation, q, k, values, graph)
    return edge_fusion


def path_config(path: str):
    """(config, edge_fusion_fn) of a path."""
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.ops import bsp, edge, ell
    if path == "block":
        cfg = get_config("multitask_batched")
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, renderer="numpy"))
        return cfg, kernel_swap(edge.with_block_kernel)
    cfg = get_config("dynamic_swarm")
    if path == "bsp2":  # "native" raises where the libraries do not build
        return cfg.replace(data=dataclasses.replace(
            cfg.data, renderer="native", graph_builder="native")), \
            kernel_swap(bsp.with_bsp_attention)
    data = dataclasses.replace(cfg.data, renderer="numpy",
                               graph_builder="numpy")
    if path == "hideg":
        data = dataclasses.replace(data, num_robots=193, scenes_per_batch=2,
                                   connectivity="full", comm_radius=0,
                                   mobility=0.0, max_nodes=512)
    fusion = "attention" if path in ("hideg", "ell") else path
    return cfg.replace(data=data, model=dataclasses.replace(
        cfg.model, fusion=fusion)), (kernel_swap(ell.with_ell_kernels)
                                     if path == "ell" else None)


def busy_ms(fn, n: int = 5) -> float:
    """Device busy time per call of ``fn`` (profiler: n warm-up calls traced
    and dropped, then n kept)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")) / n / 1e3


def turn(root: Path, path: str) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from mrp_gnn_tpu_torch import train
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.ops import _build, bsp, ell
    from mrp_gnn_tpu_torch.serving import Predictor

    here = Path(train.__file__).resolve()
    if root.resolve() not in here.parents:
        raise RuntimeError(f"imported the port from {here}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(list(bsp.SOURCES))
    cfg, fusion_fn = path_config(path)
    x = train.batch_to_device(next(iter(make_dataset(cfg.data, "train"))), dev)
    state = train.create_train_state(cfg, dev, fusion_fn)
    step = train.make_train_step(cfg, state.model, state.optimizer)
    for _ in range(3):
        state, _ = step(state, *x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(INNER):
            state, _ = step(state, *x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    busy = busy_ms(lambda: step(state, *x))
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    pred = Predictor(cfg, state.model, graph=batch["graph"])
    serve = [pred.throughput(iters=20)["batch_latency_s"] * 1e3
             for _ in range(REPS)]
    images = torch.as_tensor(batch["images"], dtype=torch.float32, device=dev)
    serve_busy = busy_ms(lambda: pred.forward(images))
    g = x[3]
    rng = np.random.default_rng(41)
    kernel = None
    if path == "bsp2":
        dk = cfg.model.attention_dim
        q_s, k = (torch.from_numpy((rng.normal(size=(g.max_nodes, dk))
                                    / np.sqrt(dk)).astype(np.float32)).to(dev)
                  for _ in range(2))
        kernel = busy_ms(lambda: bsp.attention_weights(q_s, k, g.ell_src,
                                                       g.ell_mask), n=30)
    elif path == "ell":
        logits = torch.from_numpy(rng.normal(size=tuple(
            g.ell_src.shape)).astype(np.float32)).to(dev)
        kernel = busy_ms(lambda: ell.softmax(logits, g.ell_mask), n=30)
    loop = None
    if path == "bsp2":
        loop_cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                         log_every=1))
        _, records = train.train(loop_cfg, num_steps=LOOP_STEPS, device=dev)
        loop = statistics.median(r["step_time_s"] for r in records[1:])
    return {"root": str(root), "path": path, "step_ms": times,
            "median_ms": statistics.median(times), "busy_ms_per_step": busy,
            "serve_ms": serve, "serve_median_ms": statistics.median(serve),
            "busy_ms_per_request": serve_busy, "kernel_ms": kernel,
            "loop_step_s": loop,
            "loadavg": os.getloadavg(), "torch_threads": torch.get_num_threads()}


def ab(parent: Path, change: Path, paths) -> dict:
    turns = [("parent", parent), ("change", change), ("change", change),
             ("parent", parent)]
    keys = ("median_ms", "busy_ms_per_step", "serve_median_ms",
            "busy_ms_per_request", "kernel_ms", "loop_step_s")
    out = {}
    for path in paths:
        res = {key: {"parent": [], "change": []} for key in keys}
        for label, root in turns:
            cmd = [sys.executable, __file__, "--root", str(root), "--path", path]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"turn {label} {path} failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": label, "seconds":
                              time.perf_counter() - t0, **rec}), flush=True)
            for key in keys:
                res[key][label].append(rec[key])
        out[path] = res
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ab", nargs=2, type=Path, metavar=("PARENT", "CHANGE"))
    p.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    p.add_argument("--root", type=Path)
    p.add_argument("--path", default="mean", choices=PATHS)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_step_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.ab:
        res = ab(*args.ab, args.paths)
        print(json.dumps({"metric": "port_step_ab", "by_path": res,
                          "timing": f"train step: CUDA events, median of "
                                    f"{REPS} x {INNER} steps; busy: profiler "
                                    "device time per step and per request "
                                    "(device-side forward); serve: Predictor "
                                    f"batch latency, median of {REPS} x 20; "
                                    "kernel: the path's softmax kernel, "
                                    "profiler device time per call (bsp2, "
                                    "ell); loop: train() step, host clock, "
                                    f"median of steps 2-{LOOP_STEPS} "
                                    "(bsp2); one process per turn",
                          "nvidia_smi": smi}))
        return 0
    if args.root is None:
        p.error("give --root or --ab")
    rec = turn(args.root, args.path)
    print(json.dumps({**rec, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
