"""Training cells: the loop of ``train.train``, composed from the program's
public pieces so that it can start from the benchmark's weights.

Set-up builds the model (``create_train_state``, then the seeded weights
loaded), the data stream (``make_train_iterator``: the prefetching
renderer and graph builder, then ``BatchPlacer`` on a producer thread
through ``TransformIterator``) and the step (``make_train_step``). It
drives that one object through the checked steps, which the reference
follows afterwards on batches it renders itself (the frozen scene
generator, ``reference/render.py``), and a few more, and hands the same
object to the window.

The window is a closed loop of steps, as ``train.train`` runs them: a
log point every ``log_every`` steps reads the loss terms, which
synchronises the device. It starts at a log point and ends at the first
log point at or after ``--seconds``; ``train_views_per_s`` is every real
robot view trained in it over its length.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import cells, compare, trace, weights
from perfbench.drivers import (attach_profile, device_info,
                               free_device_memory, metric, per_layer,
                               ref_graph)
from perfbench.reference import numerics
from perfbench.reference import train as RT
from perfbench.reference.graph import train_batch_scenes, train_scene_seed
from perfbench.reference.render import noise_seed, render_scenes, scene_world


class TrainCell:
    def __init__(self, cell: dict, seed: int, device: torch.device,
                 rec: trace.Recorder = trace.OFF):
        from mrp_gnn_tpu_torch.data.pipeline import (TransformIterator,
                                                     make_train_iterator)
        from mrp_gnn_tpu_torch.train import (BatchPlacer, batch_to_device,
                                             create_train_state,
                                             make_train_step)
        self.doc = cell["config_doc"]
        self.ref = cells.reference(self.doc)
        self.traffic = cell["traffic_doc"]
        self.limits = cell["limits"]
        self.seed, self.device, self.rec = seed, device, rec
        self.cfg = cfg = cells.port_config(self.doc, seed)
        self._to_device = batch_to_device
        state = create_train_state(cfg, device)
        model = state.model
        self.names = [n for n, _ in model.named_parameters()]
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.params0 = weights.seeded_state_dict(shapes, seed, device)
        model.load_state_dict(self.params0)
        for i in range(model.num_fusion_layers):
            rec.time_forward(getattr(model, f"fusion{i}"), "fusion")
            rec.time_backward(getattr(model, f"fusion{i}"), "fusion_backward")
        self.state = state
        self.it = TransformIterator(make_train_iterator(cfg.data),
                                    BatchPlacer(device))
        self.step = make_train_step(cfg, model, state.optimizer)
        self.prog = {"losses": []}
        for i in range(self.traffic["checked_steps"]):
            terms = self._step(next(self.it))
            self.prog["losses"].append({k: float(v) for k, v in terms.items()})
            if i == 0:
                mu = state.optimizer.mu
                self.prog["grads"] = {n: (m / (1.0 - RT.B1)).clone()
                                      for n, m in zip(self.names, mu)}
        self.prog["params"] = {n: p.detach().clone()
                               for n, p in model.named_parameters()}
        for _ in range(self.traffic["warmup_steps"]):
            terms = self._step(next(self.it))
        float(terms["total"])  # a log point: the window starts on an idle card

    def _step(self, batch):
        self.state, terms = self.step(self.state,
                                      *self._to_device(batch, self.device))
        return terms

    def _checked_scenes(self, index: int) -> list:
        """The scenes of checked batch ``index`` as the reference makes
        them itself: (world, noise stream seed) of each, from the frozen
        scene generator (``reference/render.py``) at the stream's seed."""
        d = self.doc["data"]
        stream = train_scene_seed(self.seed)
        scenes = train_batch_scenes(d["num_train_scenes"],
                                    d["scenes_per_batch"], self.seed, index)
        return [(scene_world(d["num_robots"], d["mobility"], stream, int(s),
                             tuple(d["image_size"]), d["num_seg_classes"]),
                 noise_seed(stream, int(s))) for s in scenes]

    def window(self, seconds: float, profile: trace.ProfileWindow | None = None
               ) -> dict:
        rec, every = self.rec, self.traffic["log_every"]
        rec.reset()
        steps = views = nonfinite = 0
        edges = []
        t0 = time.perf_counter()
        while True:
            with rec.span("data_wait"):
                batch = next(self.it)
            g = batch["graph"]
            views += int(g.n_nodes)
            edges.append(int(g.n_edges))
            with rec.span("step"):
                terms = self._step(batch)
            steps += 1
            if profile is not None:
                profile.tick()
            if steps % every == 0:
                with rec.span("log_sync"):
                    total = float(terms["total"])
                nonfinite += not math.isfinite(total)
                now = time.perf_counter()
                if now - t0 >= seconds:
                    break
        if profile is not None:
            profile.close()
        self.it.close()
        return {"window_s": now - t0, "steps": steps, "views": views,
                "edges": edges, "nonfinite_logs": nonfinite}

    def free(self) -> None:
        """Drops the program's state (the model, the optimizer, the step)."""
        self.it.close()
        self.state = self.step = None
        free_device_memory(self.device)

    def reference_batches(self) -> list:
        """The checked batches, made by the reference: frames, depth and
        labels rendered by the frozen scene generator, padded to the node
        slots, and the graph from the scenes' camera positions."""
        d = self.doc["data"]
        max_nodes = d["max_nodes"] or d["num_robots"] * d["scenes_per_batch"]
        out = []
        for i in range(self.traffic["checked_steps"]):
            scenes = self._checked_scenes(i)
            arrays = render_scenes(scenes, tuple(d["image_size"]))
            pad = lambda a: np.concatenate(  # noqa: E731
                [a, np.zeros((max_nodes - len(a),) + a.shape[1:], a.dtype)])
            positions = ([w["offsets"] for w, _ in scenes]
                         if d["connectivity"] == "radius" else None)
            out.append(tuple(torch.from_numpy(pad(a)).to(self.device)
                             for a in arrays)
                       + (ref_graph(d, positions).to(self.device),))
        return out

    def reference(self, precision: str = "ieee", forward=None,
                  batches=None) -> dict:
        """The checked steps of the configuration's reference; ``forward``
        and ``batches`` replace its network and inputs (a planted fault)."""
        with numerics(precision):
            return RT.follow(self.params0, batches or self.reference_batches(),
                             self.doc["model"], self.doc["train"],
                             forward=forward or self.ref.forward)

    def readings(self, against: dict | None = None) -> dict:
        """The numbers compared: the program's checked steps (or
        ``against``, another run put in its place) against the reference."""
        ref = self.reference()
        return compare.train_readings(against or self.prog, ref, self.params0)


def run(cell: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, readers: dict) -> dict:
    rec = trace.Recorder(traced, device)
    c = TrainCell(cell, seed, device, rec)
    prof = None
    if traced and device.type == "cuda":
        p = c.traffic["profile"]
        prof = trace.ProfileWindow(p["start"], p["warm"], p["active"])
    setup_s = time.perf_counter() - t_start
    w = c.window(seconds, prof)
    record = {"mode": "train", "model": c.doc["model"],
              "reference": c.doc["reference"],
              "num_nodes": int(c.cfg.data.max_nodes or
                               c.cfg.data.num_robots
                               * c.cfg.data.scenes_per_batch),
              **w, "spans_ms": dict(rec.spans_ms),
              "device_ms": rec.device_ms(),
              "profile": prof.result() if prof else None}
    rec.remove_hooks()
    dev = device_info(device, cell["chips"])
    c.free()
    correct, checks = compare.judge(c.readings(), c.limits)
    correct = correct and w["nonfinite_logs"] == 0
    if traced:
        metrics = per_layer(readers, record)
    else:
        metrics = {"train_views_per_s": metric(w["views"] / w["window_s"],
                                               "views/s"),
                   "setup_s": metric(setup_s, "s")}
    result = {"correct": correct, "attempted": w["steps"],
              "failed": w["nonfinite_logs"] * c.traffic["log_every"],
              "metrics": metrics, "device": dev}
    attach_profile(result, record["profile"])
    result["checks"] = checks
    return result
