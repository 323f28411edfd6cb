"""Serving cells: requests at camera rate through ``serving.Predictor``.

A request is one Predictor batch: every robot's frame of
``scenes_per_batch`` scenes. Frames come from a pool of ``pool`` distinct
batches of pseudo-random float32 frames made from the seed and held in
pageable host memory, as a camera driver hands them over. The topology is
static, so the ``Predictor`` is made once at set-up with the batch's
graph; its call copies the frames in, runs the model, and returns depth
and segmentation labels to the host. (A dynamic topology, whose graph is
built per request, has no cell yet.)

The window is an open loop: requests are due at the times of
``traffic.due_times`` (the traffic's ``arrivals`` at its ``rate_per_s``)
and taken up one at a time, in order, as soon as
each is due and the one before has returned. Each is timed from its due
time to its outputs on the host.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from perfbench import cells, compare, trace, traffic, weights
from perfbench.drivers import (attach_profile, device_info,
                               free_device_memory, metric, per_layer,
                               ref_graph)
from perfbench.reference import numerics

FAILED_LATENCY_MS = 3.6e6  # stands for an infinite latency in the line
SPIN_S = 1e-3              # the last stretch before a due time is spun


class ServeCell:
    def __init__(self, cell: dict, seed: int, device: torch.device,
                 rec: trace.Recorder = trace.OFF, rate: float | None = None,
                 seconds: float = 0.0, requests: int = 0,
                 arrivals: str | None = None):
        """Set-up for a window of ``seconds`` at ``rate`` with ``arrivals``
        (default: the traffic's); ``requests`` prepares inputs for at least
        that many requests (a sweep sets ``due`` for several rates)."""
        from mrp_gnn_tpu_torch.graph import batch_homogeneous, scene_edges_for
        from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
        from mrp_gnn_tpu_torch.serving import Predictor
        self.doc = cell["config_doc"]
        self.ref = cells.reference(self.doc)
        self.traffic = tr = cell["traffic_doc"]
        self.limits = cell["limits"]
        self.seed, self.device, self.rec = seed, device, rec
        self.cfg = cfg = cells.port_config(self.doc, seed)
        d = cfg.data
        if d.mobility > 0:
            raise ValueError(f"{cell['name']}: serving a dynamic topology "
                             "(a graph per request) has no driver yet")
        self.scenes, self.robots = d.scenes_per_batch, d.num_robots
        self.max_nodes = d.max_nodes or self.scenes * self.robots

        model = MultiRobotPerceptionNet(cfg.model, ops_impl=cfg.parallel.ops_impl)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.params0 = weights.seeded_state_dict(shapes, seed, device)
        model.load_state_dict(self.params0)
        self.model = model.to(device).eval()
        rec.time_forward(model, "forward")
        for i in range(model.num_fusion_layers):
            rec.time_forward(getattr(model, f"fusion{i}"), "fusion")

        self.rate = tr["rate_per_s"] if rate is None else rate
        self.arrivals = tr["arrivals"] if arrivals is None else arrivals
        self.due = traffic.due_times(self.rate, seconds, seed, self.arrivals)
        n = max(len(self.due), requests)
        rng = np.random.default_rng([seed, 1])
        self.pool_index = rng.integers(tr["pool"], size=n)
        self.sample = set(rng.choice(n, size=min(tr["sample"], n),
                                     replace=False).tolist())
        gen = torch.Generator(device=device).manual_seed(seed)
        H, W = d.image_size
        frames = torch.rand((tr["pool"], self.max_nodes, H, W,
                             cfg.model.in_channels), generator=gen,
                            device=device)
        frames[:, self.scenes * self.robots:] = 0.0   # empty node slots
        self.pool = list(frames.cpu().numpy())        # pageable host memory
        del frames
        edges = scene_edges_for(self.robots, d.connectivity, d.comm_radius)
        graph = batch_homogeneous(self.scenes, self.robots, edges,
                                  max_nodes=self.max_nodes)
        self.predictor = Predictor(cfg, self.model, graph=graph, device=device)
        for i in range(n, n + tr["warmup_requests"]):
            self.handle(i)
        self.served: dict = {}

    def handle(self, i: int) -> dict:
        """Serves request ``i`` and returns its outputs on the host."""
        images = self.pool[self.pool_index[i % len(self.pool_index)]]
        with self.rec.span("predictor"):
            return self.predictor(images)

    def window(self, profile: trace.ProfileWindow | None = None) -> dict:
        self.rec.reset()
        n = len(self.due)
        start, done, errors = [0.0] * n, [None] * n, []
        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + self.due[i]
            with self.rec.span("await_due"):
                wait = due - time.perf_counter()
                if wait > SPIN_S:
                    time.sleep(wait - SPIN_S)
                while time.perf_counter() < due:
                    pass
            start[i] = time.perf_counter()
            try:
                out = self.handle(i)
            except Exception:  # noqa: BLE001 (a failed request is counted)
                errors.append(traceback.format_exc())
            else:
                done[i] = time.perf_counter()
                if i in self.sample:
                    self.served[i] = out
            if profile is not None:
                profile.tick()
        if profile is not None:
            profile.close()
        due_abs = [t0 + x for x in self.due]
        lat = traffic.latency_ms(due_abs, done)
        finished = [x for x in done if x is not None]
        return {"window_s": (max(finished) if finished else time.perf_counter())
                - t0, "requests": n, "failed": len(errors), "errors": errors,
                "latency_ms": lat,
                "lateness_growth_ms": traffic.lateness_growth_ms(due_abs, start)}

    def free(self) -> None:
        self.model = self.predictor = None
        free_device_memory(self.device)

    def reference_outputs(self, i: int, precision: str = "ieee") -> tuple:
        """(outputs of the configuration's reference, real-robot mask) of
        request ``i``."""
        graph = ref_graph(self.doc["data"], None).to(self.device)
        images = torch.from_numpy(self.pool[self.pool_index[i]]).to(self.device)
        with numerics(precision), torch.no_grad():
            out = self.ref.forward(self.params0, images, graph,
                                   self.doc["model"])
        return out, graph.node_mask

    def readings(self, served: dict | None = None) -> dict:
        """The numbers compared: the sampled requests' answers (or
        ``served``, another run's put in their place) against the
        reference."""
        served = self.served if served is None else served
        pairs = []
        for i in sorted(served):
            ref, mask = self.reference_outputs(i)
            pairs.append((served[i], ref, mask))
        return compare.serve_readings(pairs, len(self.sample))


def _stats(w: dict) -> tuple:
    lat = w["latency_ms"]
    p50, p95 = (traffic.percentile(lat, q) for q in (50, 95))
    fix = lambda v: FAILED_LATENCY_MS if v == float("inf") else v  # noqa: E731
    return fix(p50), fix(p95)


def run(cell: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, readers: dict) -> dict:
    rec = trace.Recorder(traced, device)
    c = ServeCell(cell, seed, device, rec, seconds=seconds)
    prof = None
    if traced and device.type == "cuda":
        p = c.traffic["profile"]
        prof = trace.ProfileWindow(p["start"], p["warm"], p["active"])
    setup_s = time.perf_counter() - t_start
    w = c.window(prof)
    for e in w["errors"][:3]:
        print(e, file=sys.stderr)
    graph_edges = [int(ref_graph(c.doc["data"], None).num_edges)] * len(c.due)
    record = {"mode": "serve", "model": c.doc["model"],
              "reference": c.doc["reference"],
              "num_nodes": c.max_nodes, "edges": graph_edges, **w,
              "spans_ms": dict(rec.spans_ms),
              "device_ms": rec.device_ms(),
              "profile": prof.result() if prof else None}
    rec.remove_hooks()
    dev = device_info(device, cell["chips"])
    c.free()
    correct, checks = compare.judge(c.readings(), c.limits)
    correct = correct and w["failed"] == 0
    if traced:
        metrics = per_layer(readers, record)
    else:
        p50, p95 = _stats(w)
        metrics = {"serve_p95_ms": metric(p95, "ms"),
                   "serve_p50_ms": metric(p50, "ms"),
                   "setup_s": metric(setup_s, "s")}
    result = {"correct": correct, "attempted": w["requests"],
              "failed": w["failed"], "metrics": metrics, "device": dev}
    attach_profile(result, record["profile"])
    result["checks"] = checks
    return result
