"""Readings that the limits of ``correct`` are set from, for one cell, in
one process: for each seed, the program's numbers against the reference
that the cell's configuration names (the lower readings), the control's
(that reference in TF32, the nearest lower precision, put in the
program's place) and those of planted faults (that reference put in the
program's place, with the fault in it).

    python3 -m perfbench.calibrate --workload swarm_train --seeds 1-12 \
        [--control 1-3] [--seconds 3] [--out FILE]

Training needs no window: the readings are of the set-up's checked steps.
Serving runs a short window of ``--seconds`` at the cell's rate, so that
as many requests are compared as a run compares. Faults:

- training: the state left unchanged (the parameters after the steps are
  the first ones); half of the batch left out (the second half of the real
  robots masked), the loss the mean over the rest; an answer altered where
  it is produced (0.5 m added to one view's depth);
- serving: half of the batch left out (the second half of the real robots
  answered with zeros); an answer altered where it is produced (0.5 m added
  to one pixel's depth, and its label moved to the next class).

One JSON line per seed goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from perfbench import cells, compare

BUMP_M = 0.5


def seed_range(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _halved(mask: torch.Tensor) -> torch.Tensor:
    real = torch.nonzero(mask).flatten()
    out = mask.clone()
    out[real[len(real) // 2:]] = False
    return out


def _bumped(forward):
    """``forward`` with 0.5 m added to the first view's depth."""
    def bumped(p, images, graph, model):
        out = forward(p, images, graph, model)
        depth = out["depth"].clone()
        depth[0] = depth[0] + BUMP_M
        return {**out, "depth": depth}
    return bumped


def train_seed(cell: dict, seed: int, device, control: bool) -> dict:
    from perfbench.drivers.train import TrainCell
    c = TrainCell(cell, seed, device)
    c.free()
    ref = c.reference()
    line = {"seed": seed,
            "program": compare.train_readings(c.prog, ref, c.params0)}
    if control:
        line["control_tf32"] = compare.train_readings(
            c.reference("tf32"), ref, c.params0)
        line["fault_unchanged"] = compare.train_readings(
            {**ref, "params": c.params0}, ref, c.params0)
        half = [(i, d, s, dataclasses.replace(g, node_mask=_halved(g.node_mask)))
                for i, d, s, g in c.reference_batches()]
        line["fault_half_batch"] = compare.train_readings(
            c.reference(batches=half), ref, c.params0)
        line["fault_altered_answer"] = compare.train_readings(
            c.reference(forward=_bumped(c.ref.forward)), ref, c.params0)
    return line


def _served(out: dict) -> dict:
    return {"depth": out["depth"].cpu().numpy(),
            "seg": out["seg_logits"].argmax(-1).to(torch.int32).cpu().numpy()}


def serve_seed(cell: dict, seed: int, device, seconds: float,
               control: bool) -> dict:
    from perfbench.drivers.serve import ServeCell
    c = ServeCell(cell, seed, device, seconds=seconds)
    w = c.window()
    c.free()
    line = {"seed": seed, "requests": w["requests"], "failed": w["failed"],
            "program": c.readings()}
    if control:
        tf32, half, bumped = {}, {}, {}
        for i in c.served:
            out, mask = c.reference_outputs(i, "tf32")
            tf32[i] = _served(out)
            ref = _served(c.reference_outputs(i)[0])
            keep = _halved(mask).cpu().numpy()
            half[i] = {k: v * keep[:, None, None] for k, v in ref.items()}
            b = {k: v.copy() for k, v in ref.items()}
            b["depth"][0, 0, 0] += BUMP_M
            b["seg"][0, 0, 0] = (b["seg"][0, 0, 0] + 1) % out[
                "seg_logits"].shape[-1]
            bumped[i] = b
        line["control_tf32"] = c.readings(tf32)
        line["fault_half_batch"] = c.readings(half)
        line["fault_altered_answer"] = c.readings(bumped)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    p.add_argument("--control", default="",
                   help="seeds whose control and faults are read too")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from perfbench.run import require_cards
    cell = cells.cell(args.workload)
    device = require_cards(cell["chips"])
    control = set(seed_range(args.control)) if args.control else set()
    mode = cell["traffic_doc"]["mode"]
    for seed in seed_range(args.seeds):
        if mode == "train":
            line = train_seed(cell, seed, device, seed in control)
        else:
            line = serve_seed(cell, seed, device, args.seconds,
                              seed in control)
        text = json.dumps({"workload": args.workload, **line})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
