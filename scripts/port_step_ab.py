"""Device time of one train step of the PyTorch port, for an A/B of two
checkouts on one CUDA card, each turn in a process of its own.

    python3 scripts/port_step_ab.py --ab PARENT_DIR CHANGE_DIR
    python3 scripts/port_step_ab.py --root DIR --path mean [--native]

One turn (``--root``) imports ``mrp_gnn_tpu_torch`` from ``DIR``, builds its
CUDA kernels and times ``train.make_train_step`` on ``dynamic_swarm``'s
first train batch (numpy renderer and graph builder, ``model.fusion``
``--path``: "mean" or "attention", random seeded weights) with CUDA events:
the median over 5 repetitions of the mean of 10 back-to-back steps, after
3 warm-up steps. ``--native`` first renders and builds two batches
with the native C++ renderer and graph builder (their OpenMP threads then
idle beside the timed steps); the step still runs on the numpy batch.
A turn prints one JSON line.

``--ab`` runs, for each path, the turns PARENT, CHANGE, CHANGE --native,
CHANGE --native, CHANGE, PARENT, then one JSON line with each label's
times. The card's name and power limit go beside every line.
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

REPS, INNER = 5, 10
PATHS = ("mean", "attention")


def turn(root: Path, path: str, native: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from mrp_gnn_tpu_torch import train
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.data.pipeline import make_dataset
    from mrp_gnn_tpu_torch.ops import _build, bsp

    here = Path(train.__file__).resolve()
    if root.resolve() not in here.parents:
        raise RuntimeError(f"imported the port from {here}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(list(bsp.SOURCES))
    cfg = get_config("dynamic_swarm")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, renderer="numpy",
                                 graph_builder="numpy"),
        model=dataclasses.replace(cfg.model, fusion=path))
    if native:
        it = iter(make_dataset(dataclasses.replace(
            cfg.data, renderer="native", graph_builder="native"), "train"))
        for _ in range(2):
            next(it)
    x = train.batch_to_device(next(iter(make_dataset(cfg.data, "train"))), dev)
    state = train.create_train_state(cfg, dev)
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
    return {"root": str(root), "path": path, "native": native,
            "step_ms": times, "median_ms": statistics.median(times),
            "loadavg": os.getloadavg(), "torch_threads": torch.get_num_threads()}


def ab(parent: Path, change: Path) -> dict:
    turns = [("parent", parent, False), ("change", change, False),
             ("change+native", change, True), ("change+native", change, True),
             ("change", change, False), ("parent", parent, False)]
    out = {}
    for path in PATHS:
        res = {label: [] for label, _, _ in turns}
        for label, root, native in turns:
            cmd = [sys.executable, __file__, "--root", str(root), "--path", path]
            if native:
                cmd.append("--native")
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"turn {label} {path} failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": label, "seconds":
                              time.perf_counter() - t0, **rec}), flush=True)
            res[label].append(rec["median_ms"])
        out[path] = res
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ab", nargs=2, type=Path, metavar=("PARENT", "CHANGE"))
    p.add_argument("--root", type=Path)
    p.add_argument("--path", default="mean", choices=PATHS)
    p.add_argument("--native", action="store_true")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_step_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.ab:
        res = ab(*args.ab)
        print(json.dumps({"metric": "port_step_ab", "median_ms_by_turn": res,
                          "timing": f"CUDA events, median of {REPS} x {INNER} "
                                    "steps per turn, one process per turn",
                          "nvidia_smi": smi}))
        return 0
    if args.root is None:
        p.error("give --root or --ab")
    rec = turn(args.root, args.path, args.native)
    print(json.dumps({**rec, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
