"""Inference / serving path (port of ``mrp_gnn_tpu/serving.py``).

``Predictor`` runs fixed-shape inference for one scene batch on one device:
the graph topology and batch capacity are fixed at construction, so every
request has the same shapes. It runs on the CUDA card unless the caller
passes ``device="cpu"``; with no card it raises rather than run elsewhere.

``Predictor.from_checkpoint`` serves the newest checkpoint of a training
run. Not ported yet (ROADMAP.md, queue A item 10): the portable export
(``torch.export`` in the place of StableHLO) and the CLI.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mrp_gnn_tpu_torch.config import ExperimentConfig
from mrp_gnn_tpu_torch.graph import (GraphBatch, batch_homogeneous,
                                     scene_edges_for)
from mrp_gnn_tpu_torch.utils.platform import resolve_device


def _scene_graph(cfg: ExperimentConfig) -> GraphBatch:
    d = cfg.data
    return batch_homogeneous(
        d.scenes_per_batch, d.num_robots,
        scene_edges_for(d.num_robots, d.connectivity, d.comm_radius))


class Predictor:
    """Fixed-shape inference on one device.

    images: float [V, H, W, 3] with V = the graph's node capacity (pad the
    final partial batch; padded slots are zeroed by node_mask).
    Returns numpy {"depth": [V, H, W], "seg": int32 [V, H, W] (if
    configured)}. The model's weights are used as they are, in eval mode;
    the edge-op backend is ``cfg.parallel.ops_impl``.
    """

    def __init__(self, cfg: ExperimentConfig, model: nn.Module,
                 graph: Optional[GraphBatch] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        graph = graph if graph is not None else _scene_graph(cfg)
        self.graph = graph.to(self.device)
        self.model = model.to(self.device).eval()
        self.ops_impl = cfg.parallel.ops_impl
        h, w = cfg.data.image_size
        self.batch_nodes = self.graph.max_nodes
        self.input_shape = (self.batch_nodes, h, w, cfg.model.in_channels)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> dict:
        """Device-side forward on a tensor already on ``self.device``;
        returns device tensors, without synchronising."""
        out = self.model(images, self.graph, ops_impl=self.ops_impl)
        res = {"depth": out["depth"]} if "depth" in out else {}
        if "seg_logits" in out:
            res["seg"] = torch.argmax(out["seg_logits"], dim=-1).to(torch.int32)
        return res

    def __call__(self, images) -> dict:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        if tuple(images.shape) != self.input_shape:
            raise ValueError(f"expected images {self.input_shape}, "
                             f"got {tuple(images.shape)}")
        images = images.to(self.device, torch.float32)
        return {k: v.cpu().numpy() for k, v in self.forward(images).items()}

    def predict_scenes(self, scene_images) -> list:
        """Any number of scenes, chunked and padded to the fixed batch shape.

        scene_images: sequence of [num_robots, H, W, 3] arrays.
        Returns a per-scene list of output dicts (padding stripped).
        """
        n = self.cfg.data.num_robots
        bs = self.cfg.data.scenes_per_batch
        scenes = [np.asarray(s, np.float32) for s in scene_images]
        for s in scenes:
            if s.shape[0] != n or s.shape[1:] != self.input_shape[1:]:
                raise ValueError(f"each scene must be [{n}, "
                                 f"{self.input_shape[1:]}], got {s.shape}")
        results = []
        for i in range(0, len(scenes), bs):
            chunk = scenes[i:i + bs]
            flat = np.concatenate(chunk)
            pad = self.batch_nodes - flat.shape[0]
            if pad:
                flat = np.concatenate(
                    [flat, np.zeros((pad,) + flat.shape[1:], np.float32)])
            out = self(flat)
            for j in range(len(chunk)):
                sl = slice(j * n, (j + 1) * n)
                results.append({k: v[sl] for k, v in out.items()})
        return results

    @classmethod
    def from_checkpoint(cls, cfg: ExperimentConfig, checkpoint_dir: str,
                        device=None,
                        graph: Optional[GraphBatch] = None) -> "Predictor":
        """A Predictor on the model of the newest checkpoint in
        ``checkpoint_dir`` (``checkpoint.py``); ``graph`` as in the
        constructor. Raises FileNotFoundError when there is none."""
        from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
        from mrp_gnn_tpu_torch.train import create_train_state
        device = resolve_device(device)
        state = create_train_state(cfg, device)
        if CheckpointManager(checkpoint_dir).restore_latest(state) is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        return cls(cfg, state.model, graph=graph, device=device)

    def throughput(self, iters: int = 20) -> dict:
        """Steady-state batch latency and robot views/s on the card, timed
        with CUDA events around ``iters`` device-side forwards of one
        random batch. Raises on a non-CUDA predictor: this is a device
        measurement."""
        if self.device.type != "cuda":
            raise RuntimeError("throughput measures the CUDA card; this "
                               f"predictor runs on {self.device}")
        rng = np.random.default_rng(0)
        images = torch.from_numpy(
            rng.uniform(size=self.input_shape).astype(np.float32)
        ).to(self.device)
        for _ in range(3):  # warm-up
            self.forward(images)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for _ in range(iters):
            self.forward(images)
        end.record()
        torch.cuda.synchronize(self.device)
        dt = start.elapsed_time(end) / 1e3 / iters
        return {"batch_latency_s": dt,
                "views_per_s": self.batch_nodes / dt,
                "scenes_per_s": self.cfg.data.scenes_per_batch / dt,
                "device": torch.cuda.get_device_name(self.device)}
