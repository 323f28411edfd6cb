"""Inference / serving path (port of ``mrp_gnn_tpu/serving.py``).

``Predictor`` runs fixed-shape inference for one scene batch on one device:
the graph topology and batch capacity are fixed at construction, so every
request has the same shapes. It runs on the CUDA card unless the caller
passes ``device="cpu"``; with no card it raises rather than run elsewhere.
``Predictor.from_checkpoint`` serves the newest checkpoint of a training
run.

``export_predictor`` / ``load_exported``: the Predictor's forward, with its
weights and serving graph baked in, saved by ``torch.export`` (the JAX
package's StableHLO export). The kernels' forwards are custom ops
(``ops/library.py``), so the loaded program launches the same CUDA kernels
on the card and runs their plain versions on the CPU; loading needs that
op library and none of the model code.

CLI:
  python -m mrp_gnn_tpu_torch.serving --config dynamic_swarm \
      --checkpoint_dir /tmp/ckpt [--export /tmp/model.pt2] [--bench] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
from typing import Optional

import numpy as np
import torch
from torch import nn

from mrp_gnn_tpu_torch.config import ExperimentConfig, get_config
from mrp_gnn_tpu_torch.graph import (GraphBatch, batch_homogeneous,
                                     scene_edges_for)
from mrp_gnn_tpu_torch.ops.dispatch import resolve_impl
from mrp_gnn_tpu_torch.utils import profiling
from mrp_gnn_tpu_torch.utils.platform import (reference_numerics,
                                              resolve_device)

PLATFORMS = ("cpu", "cuda")  # the device types an artifact may run on


def _scene_graph(cfg: ExperimentConfig) -> GraphBatch:
    d = cfg.data
    return batch_homogeneous(
        d.scenes_per_batch, d.num_robots,
        scene_edges_for(d.num_robots, d.connectivity, d.comm_radius))


class _Forward(nn.Module):
    """The Predictor's forward as a function of the images alone, the one
    that eager serving runs and ``torch.export`` traces: the model, the
    serving graph and the edge-op route (``impl``) are fixed."""

    def __init__(self, model: nn.Module, graph: GraphBatch, impl: str):
        super().__init__()
        self.model = model
        self.graph = graph
        self.impl = impl

    def forward(self, images: torch.Tensor) -> dict:
        out = self.model(images, self.graph, ops_impl=self.impl)
        res = {"depth": out["depth"]} if "depth" in out else {}
        if "seg_logits" in out:
            res["seg"] = torch.argmax(out["seg_logits"], dim=-1).to(torch.int32)
        return res


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
        self._forward = _Forward(self.model, self.graph,
                                 resolve_impl(self.ops_impl, self.device))

    @reference_numerics()
    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> dict:
        """Device-side forward on a tensor already on ``self.device``;
        returns device tensors, without synchronising. Runs under
        ``reference_numerics``, as every serving call does."""
        return self._forward(images)

    def __call__(self, images) -> dict:
        with profiling.span("serve.request"):
            with profiling.span("serve.copy_in"):
                if not torch.is_tensor(images):
                    images = torch.from_numpy(np.asarray(images, np.float32))
                if tuple(images.shape) != self.input_shape:
                    raise ValueError(f"expected images {self.input_shape}, "
                                     f"got {tuple(images.shape)}")
                images = images.to(self.device, torch.float32)
            with profiling.span("serve.forward", device=True) as fwd:
                out = self.forward(images)
            # with the recorder on, the copy out then times the copy alone
            with profiling.span("serve.wait"):
                fwd.wait()
            with profiling.span("serve.copy_out"):
                return {k: v.cpu().numpy() for k, v in out.items()}

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

    # --- ahead-of-time export -------------------------------------------

    def export_program(self) -> torch.export.ExportedProgram:
        """:meth:`forward` traced by ``torch.export`` on this Predictor's
        device, with the weights and the serving graph as constants. The
        edge ops take the route that the Predictor takes on this device:
        with the kernels, the program calls the custom ops of
        ``ops/library.py``. Raises ValueError for a model whose fusion
        layers carry an ``edge_fusion_fn`` swap (a swapped kernel has no
        registered op; the JAX Predictor takes no swap)."""
        if any(getattr(m, "edge_fusion_fn", None) is not None
               for m in self.model.modules()):
            raise ValueError("a model with an edge_fusion_fn swap cannot be "
                             "exported: only the dispatch route's kernels "
                             "are registered ops (ops/library.py)")
        images = torch.zeros(self.input_shape, device=self.device)
        with torch.no_grad():  # inference tensors cannot be traced
            return torch.export.export(self._forward, (images,))

    def export_bytes(self, platforms=PLATFORMS) -> bytes:
        """The program of :meth:`export_program`, saved by
        ``torch.export.save`` with its tensors on the CPU and the device
        types it may run on (``platforms``) inside."""
        return _serialize(self.export_program(), platforms)

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


def _serialize(program: torch.export.ExportedProgram, platforms) -> bytes:
    from torch.export.passes import move_to_device_pass
    bad = set(platforms) - set(PLATFORMS)
    if bad or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of "
                         f"{PLATFORMS}, got {tuple(platforms)}")
    buf = io.BytesIO()
    torch.export.save(move_to_device_pass(program, "cpu"), buf,
                      extra_files={"platforms": json.dumps(list(platforms))})
    return buf.getvalue()


def export_predictor(pred: Predictor, path: str,
                     platforms=PLATFORMS) -> dict:
    """Write the artifact of :meth:`Predictor.export_bytes` to ``path`` and
    a JSON sidecar to ``path + ".json"``, which it returns: the JAX
    package's keys (``config``, ``input_shape``, ``outputs``,
    ``platforms``) and the port's ``route`` ("kernels" when the program
    calls the kernels' ops, "plain" otherwise) and ``ops`` (the names of
    those ops)."""
    from mrp_gnn_tpu_torch.ops import library
    program = pred.export_program()
    blob = _serialize(program, platforms)
    ops = library.op_names(program.graph_module)
    with open(path, "wb") as f:
        f.write(blob)
    meta = {"config": pred.cfg.name,
            "input_shape": list(pred.input_shape),
            "outputs": (["depth"] if pred.cfg.model.predict_depth else [])
            + (["seg"] if pred.cfg.model.num_seg_classes else []),
            "platforms": list(platforms),
            "route": "kernels" if ops else "plain", "ops": ops}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_exported(path: str, device=None):
    """Load an artifact of :func:`export_predictor` on ``device`` (default:
    the CUDA card; raises without one). Needs the op library, not the model
    code. Returns ``callable(images) -> {"depth", "seg"}`` of numpy arrays,
    as :meth:`Predictor.__call__`, which raises ValueError on images of
    another shape than the exported one, and runs the program under
    ``reference_numerics`` (an artifact's numbers follow the loading
    process's settings). The callable carries the program's ``module``
    (the raw device-side forward, under the caller's settings) and its
    ``input_shape``."""
    from torch.export.passes import move_to_device_pass

    from mrp_gnn_tpu_torch.ops import library  # noqa: F401 (registers the ops)
    device = resolve_device(device)
    extra = {"platforms": ""}
    program = torch.export.load(path, extra_files=extra)
    platforms = json.loads(extra["platforms"])
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for {platforms}, not "
                         f"{device.type}")
    program = move_to_device_pass(program, device)
    module = program.module()
    name = program.graph_signature.user_inputs[0]
    shape = next(tuple(n.meta["val"].shape) for n in program.graph.nodes
                 if n.name == name)

    def infer(images) -> dict:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        if tuple(images.shape) != shape:
            raise ValueError(f"expected images {shape}, got "
                             f"{tuple(images.shape)}")
        with reference_numerics(), torch.inference_mode():
            out = module(images.to(device, torch.float32))
        return {k: v.cpu().numpy() for k, v in out.items()}

    infer.module = module  # device tensors in, device tensors out
    infer.input_shape = shape
    return infer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--export", default=None,
                   help="write the torch.export artifact here (and its "
                        "sidecar to <path>.json)")
    p.add_argument("--bench", action="store_true",
                   help="print Predictor.throughput() (the CUDA card only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    device = resolve_device(args.device)
    pred = Predictor.from_checkpoint(cfg, args.checkpoint_dir, device=device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serving] config={cfg.name} input={pred.input_shape} "
          f"device={device} ({card})", flush=True)
    if args.export:
        meta = export_predictor(pred, args.export)
        print(f"[serving] exported -> {args.export} (route {meta['route']}, "
              f"ops {meta['ops']})", flush=True)
    if args.bench:
        print(json.dumps(pred.throughput()), flush=True)


if __name__ == "__main__":
    main()
