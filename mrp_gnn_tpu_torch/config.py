"""Typed configuration with the preset experiments (PyTorch port).

Field-for-field copy of ``mrp_gnn_tpu/config.py`` so that presets compare
equal across the two packages. ``ParallelConfig.ops_impl`` keeps the JAX
package's values; in this package they mean:

- ``"xla"``: the plain torch ops (``ops/reference.py``);
- ``"pallas"``: the hand-written CUDA kernels (``ops/bsp.py``);
- ``"auto"``: the kernels when the tensors are on CUDA, the plain ops on CPU.

Fields that only the JAX package acts on yet (the mesh axes) are kept so
the dataclasses stay identical. ``DataConfig.loader`` "grain" selects the
port's multi-worker loader (``data/grain_pipeline.py``, on
``torch.utils.data.DataLoader``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    image_size: Tuple[int, int] = (64, 64)
    in_channels: int = 3
    # Channel width per encoder stage; each stage downsamples 2x.
    encoder_channels: Tuple[int, ...] = (32, 64, 128)
    # Robot-graph fusion at the bottleneck: "none" | "mean" | "attention".
    fusion: str = "attention"
    num_fusion_layers: int = 1
    attention_dim: int = 64
    # Independent attention heads over channel groups (1 = the reference's
    # single scalar weight per robot pair). Requires channels % heads == 0.
    attention_heads: int = 1
    # Heads.
    predict_depth: bool = True
    num_seg_classes: int = 0  # 0 => no segmentation head
    min_depth: float = 0.1
    max_depth: float = 20.0
    norm_groups: int = 8
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"

    @property
    def bottleneck_stride(self) -> int:
        return 2 ** len(self.encoder_channels)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    num_robots: int = 5
    scenes_per_batch: int = 4
    image_size: Tuple[int, int] = (64, 64)
    num_seg_classes: int = 6  # including background class 0
    num_train_scenes: int = 512
    num_eval_scenes: int = 64
    seed: int = 0
    # Robot-graph connectivity: "full" or "radius" (communication range in
    # robot-index distance; robots sit along the camera baseline).
    connectivity: str = "full"
    comm_radius: int = 0
    # Scene renderer backend: "auto" (native C++ if buildable, else numpy),
    # "native", or "numpy". Identical world geometry either way; sensor-noise
    # RNG differs per backend.
    renderer: str = "auto"
    # On-disk dataset root (reference-style per-scene folders, data/disk.py);
    # "" = synthetic generator.
    dataset_root: str = ""
    # Train-split augmentation: rig-consistent horizontal flip + photometric
    # jitter (deterministic per seed/epoch/scene).
    augment: bool = False
    # Probability that a robot's camera is degraded (heavy sensor noise) in
    # each scene — models unreliable teammates; learned edge attention
    # should down-weight degraded senders where mean aggregation cannot.
    degraded_fraction: float = 0.0
    # Per-scene robot position jitter in robot-index units (adjacent nominal
    # slots are 1 apart, matching comm_radius). > 0 with radius connectivity
    # switches to DYNAMIC TOPOLOGY: the communication graph is rebuilt per
    # batch from the scene's actual robot positions (static array capacities
    # keep it one jit compile). Synthetic data only.
    mobility: float = 0.0
    # Host-side plan builder for dynamic batches: "auto" (native C++ when
    # buildable — native/graphbuild.cc — else numpy), "native", "numpy".
    graph_builder: str = "auto"
    # Background prefetch depth for the batch pipeline (0 = synchronous).
    prefetch: int = 2
    # Input pipeline: "builtin" (thread-prefetched BatchIterator) or
    # "grain" (multi-process workers, per-batch determinism, O(1) seek;
    # data/grain_pipeline.py).
    loader: str = "builtin"
    loader_workers: int = 0  # loader worker processes (0 = in-process)
    # Static padded capacities; None => exact fit for homogeneous teams.
    max_nodes: int | None = None
    max_edges: int | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 1000
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0
    # Rematerialize the forward during backward (jax.checkpoint): trades
    # recompute FLOPs for activation memory — big feature maps on small HBM.
    remat: bool = False
    # Microbatches accumulated per optimizer step (scan inside the jitted
    # step); effective batch = scenes_per_batch * grad_accum_steps.
    grad_accum_steps: int = 1
    # Raise (after checkpointing progress) when logged loss goes non-finite.
    halt_on_nonfinite: bool = True
    depth_loss: str = "l1"  # "l1" | "berhu" | "silog"
    depth_loss_weight: float = 1.0
    seg_loss_weight: float = 1.0
    log_every: int = 50
    checkpoint_every: int = 500
    checkpoint_dir: str = ""
    # Periodic validation during training (reference behavior, SURVEY.md
    # section 3.1): every N steps run the eval split and log metrics;
    # 0 = off. The best depth-RMSE step is tracked in the run records.
    eval_every: int = 0
    # TensorBoard scalar summaries via clu.metric_writers ("" = disabled);
    # the JSONL log_fn stream is always available regardless.
    tensorboard_dir: str = ""
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    # Mesh axes: data (scene-graph batch shards) x graph (edge partitions)
    # x model (tensor-parallel channel shards; parallel/tp.py).
    data_axis_size: int = 1
    graph_axis_size: int = 1
    model_axis_size: int = 1
    # Use the "model" axis for spatial (image-H) activation sharding instead
    # of channel tensor parallelism — the SP analog for dense feature maps
    # (GSPMD inserts conv halo exchanges). Mutually exclusive with TP param
    # sharding; params stay replicated.
    spatial_sharding: bool = False
    # Backend for the fusion ops: "xla" | "pallas".
    ops_impl: str = "xla"
    # Boundary feature exchange for the partitioned fusion (config 5):
    # "boundary" = send/recv plan, all_to_all of only the rows each peer's
    # boundary edges reference (contract path, BASELINE.json:5);
    # "all_gather" = legacy full-value gather (kept for A/B benchmarking).
    boundary_exchange: str = "boundary"
    # Overlap boundary feature exchange with local aggregation (config 5):
    # issue the value collective before the local partial aggregation so XLA
    # hides the ICI transfer; False serializes it after (the A/B control).
    overlap_boundary_exchange: bool = True
    # DYNAMIC partitioned streams whose per-shard local in-degree exceeds
    # the 128-column kernel cap: pinned length for the per-shard
    # row-expanded tile-pair plans (PlanCapacities.xp_pairs — the opt-in
    # that keeps the local aggregate on the expanded Pallas kernels
    # instead of the XLA gather fallback). 0 = fallback (with a one-time
    # warning); the expanded-plan length is not subset-monotone, so only
    # the caller can bound their topology family (docs/kernels.md) — a
    # violating batch raises at plan build. Static plans need no opt-in.
    expanded_plan_pairs: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    data: DataConfig
    train: TrainConfig
    parallel: ParallelConfig = ParallelConfig()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _preset_single_robot_depth() -> ExperimentConfig:
    """Config 1 (BASELINE.json:7): CNN encoder-decoder depth, no GNN,
    CPU-runnable tiny images. Parity anchor + CI config."""
    return ExperimentConfig(
        name="single_robot_depth",
        model=ModelConfig(image_size=(32, 32), encoder_channels=(16, 32, 64),
                          fusion="none", num_seg_classes=0),
        data=DataConfig(num_robots=1, scenes_per_batch=8, image_size=(32, 32)),
        train=TrainConfig(steps=300, learning_rate=1e-3),
    )


def _preset_two_robot_mean() -> ExperimentConfig:
    """Config 2 (BASELINE.json:8): 2-robot graph, one message-passing layer,
    mean aggregation, depth head."""
    return ExperimentConfig(
        name="two_robot_mean",
        model=ModelConfig(image_size=(32, 32), encoder_channels=(16, 32, 64),
                          fusion="mean", num_fusion_layers=1, num_seg_classes=0),
        data=DataConfig(num_robots=2, scenes_per_batch=4, image_size=(32, 32)),
        train=TrainConfig(steps=500, learning_rate=1e-3),
    )


def _preset_five_robot_attention() -> ExperimentConfig:
    """Config 3 (BASELINE.json:9): 5-robot fully-connected graph with learned
    edge-attention message passing."""
    return ExperimentConfig(
        name="five_robot_attention",
        model=ModelConfig(image_size=(64, 64), encoder_channels=(32, 64, 128),
                          fusion="attention", num_fusion_layers=1,
                          attention_dim=64, num_seg_classes=0),
        data=DataConfig(num_robots=5, scenes_per_batch=4, image_size=(64, 64)),
        train=TrainConfig(steps=1000),
        parallel=ParallelConfig(ops_impl="auto"),
    )


def _preset_multitask_batched() -> ExperimentConfig:
    """Config 4 (BASELINE.json:10): depth + segmentation heads over fused GNN
    features, batched scene-graphs."""
    return ExperimentConfig(
        name="multitask_batched",
        model=ModelConfig(image_size=(64, 64), encoder_channels=(32, 64, 128),
                          fusion="attention", num_fusion_layers=1,
                          num_seg_classes=6),
        data=DataConfig(num_robots=5, scenes_per_batch=8, image_size=(64, 64),
                        num_seg_classes=6),
        train=TrainConfig(steps=1000, seg_loss_weight=0.5),
        parallel=ParallelConfig(ops_impl="auto"),
    )


def _preset_swarm_partitioned() -> ExperimentConfig:
    """Config 5 (BASELINE.json:11): large batched swarm graphs edge-partitioned
    across a device mesh with overlapped boundary exchange. No reference
    counterpart — correctness oracle is config 4 run unpartitioned."""
    return ExperimentConfig(
        name="swarm_partitioned",
        model=ModelConfig(image_size=(64, 64), encoder_channels=(32, 64, 128),
                          fusion="attention", num_fusion_layers=1,
                          num_seg_classes=6),
        # 64-robot swarms with communication-radius connectivity: 4 scenes x
        # 64 robots = 256 nodes over 8 graph shards (32 nodes each), so every
        # swarm STRADDLES two shards and the boundary exchange is real (an
        # 8-scene x 32-robot layout would align scenes to shards and carry
        # zero boundary edges).
        data=DataConfig(num_robots=64, scenes_per_batch=4, image_size=(64, 64),
                        num_seg_classes=6, connectivity="radius",
                        comm_radius=4),
        train=TrainConfig(steps=1000, seg_loss_weight=0.5),
        parallel=ParallelConfig(data_axis_size=1, graph_axis_size=8,
                                ops_impl="auto"),
    )


def _preset_dynamic_swarm() -> ExperimentConfig:
    """Beyond the 5 contract configs: 32-robot swarms whose robots DRIFT per
    scene, so the communication-radius graph changes every batch (the
    realistic mobile-swarm regime). The graph plan is rebuilt per batch on
    the host (native C++ builder when available) under static capacities —
    one jit compile serves the whole stream; the Pallas tile-block-sparse
    kernels run on capacity-padded pair plans."""
    return ExperimentConfig(
        name="dynamic_swarm",
        model=ModelConfig(image_size=(64, 64), encoder_channels=(32, 64, 128),
                          fusion="attention", num_fusion_layers=1,
                          num_seg_classes=6),
        data=DataConfig(num_robots=32, scenes_per_batch=8, image_size=(64, 64),
                        num_seg_classes=6, connectivity="radius",
                        comm_radius=4, mobility=1.5),
        train=TrainConfig(steps=1000, seg_loss_weight=0.5),
        parallel=ParallelConfig(ops_impl="auto"),
    )


PRESETS = {
    "single_robot_depth": _preset_single_robot_depth,
    "two_robot_mean": _preset_two_robot_mean,
    "five_robot_attention": _preset_five_robot_attention,
    "multitask_batched": _preset_multitask_batched,
    "swarm_partitioned": _preset_swarm_partitioned,
    "dynamic_swarm": _preset_dynamic_swarm,
}


def get_config(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown config {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]()
