"""Deterministic synthetic multi-robot scene generator (numpy renderer).

Copy of ``mrp_gnn_tpu/data/synthetic.py``: scenes are layered textured
rectangles at random metric depths in front of a far background, seen by
robot cameras at different lateral offsets, so near objects shift more
between views. Fully deterministic per (seed, scene_index); the same seed
gives bit-identical arrays in both packages (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    num_robots: int = 5
    image_size: tuple = (64, 64)
    num_classes: int = 6        # class 0 = background
    num_rects: int = 8
    min_depth: float = 1.0
    max_depth: float = 10.0
    background_depth: float = 15.0
    focal: float = 40.0         # pixels; disparity = focal * baseline / depth
    max_baseline: float = 1.0   # metres of lateral camera spread
    # Per-scene camera-position jitter (metres): robots drift around their
    # nominal baseline slots, so the communication-range graph varies per
    # scene (dynamic swarm topology). 0 = static linspace rig.
    mobility: float = 0.0


def camera_offsets(spec: SceneSpec, rng: np.random.Generator) -> np.ndarray:
    """Lateral camera offsets for one scene (shared by both renderer
    backends so positions — and therefore the dynamic graph — are identical
    whichever backend renders the pixels)."""
    N = spec.num_robots
    if N > 1:
        offsets = np.linspace(-spec.max_baseline / 2, spec.max_baseline / 2, N)
    else:
        offsets = np.zeros(1)
    if spec.mobility > 0:
        offsets = offsets + rng.uniform(-spec.mobility, spec.mobility, N)
    return offsets


def scene_positions(spec: SceneSpec, seed: int, scene_index: int) -> np.ndarray:
    """Camera positions of one scene WITHOUT rendering it.

    Replays exactly generate_scene's world RNG draws (a few dozen scalars)
    and then the offsets draw, so the result equals
    ``generate_scene(spec, seed, idx)["positions"]`` — lets a per-host
    sharded pipeline compute the dynamic communication graph for scenes
    that OTHER hosts render (parallel/context.py local_node_range)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, scene_index]))
    K = spec.num_rects
    rng.uniform(spec.min_depth, spec.max_depth, K)   # depths
    rng.uniform(0.1, 0.9, K)                         # cx
    rng.uniform(0.1, 0.9, K)                         # cy
    rng.uniform(0.12, 0.35, K)                       # rw
    rng.uniform(0.12, 0.35, K)                       # rh
    rng.uniform(0.15, 1.0, (K, 3))                   # colors
    rng.integers(1, spec.num_classes, K)             # classes
    return camera_offsets(spec, rng).astype(np.float32)


def generate_scene(spec: SceneSpec, seed: int, scene_index: int):
    """Render one scene for all robots.

    Returns dict of numpy arrays:
      images:    [N, H, W, 3] float32 in [0, 1]
      depth:     [N, H, W]    float32 metric depth
      seg:       [N, H, W]    int32 class ids (0 = background)
      positions: [N]          float32 lateral camera offsets (metres)
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, scene_index]))
    H, W = spec.image_size
    N = spec.num_robots

    # World: K rectangles, far-to-near for painter's algorithm.
    K = spec.num_rects
    depths = np.sort(rng.uniform(spec.min_depth, spec.max_depth, K))[::-1]
    cx = rng.uniform(0.1, 0.9, K) * W
    cy = rng.uniform(0.1, 0.9, K) * H
    rw = rng.uniform(0.12, 0.35, K) * W
    rh = rng.uniform(0.12, 0.35, K) * H
    colors = rng.uniform(0.15, 1.0, (K, 3)).astype(np.float32)
    classes = rng.integers(1, spec.num_classes, K).astype(np.int32)

    # Cameras: lateral offsets spread over the baseline (centered), plus
    # per-scene mobility jitter (drawn AFTER the world so the rect layout is
    # shared with the native renderer path, which mirrors this draw order).
    offsets = camera_offsets(spec, rng)

    images = np.zeros((N, H, W, 3), np.float32)
    depth = np.full((N, H, W), spec.background_depth, np.float32)
    seg = np.zeros((N, H, W), np.int32)

    # Background: smooth horizontal colour gradient (slightly view-shifted).
    xs = np.linspace(0, 1, W, dtype=np.float32)
    for i in range(N):
        g = 0.15 + 0.2 * np.sin(2 * np.pi * (xs + 0.05 * offsets[i]))[None, :]
        images[i, :, :, 0] = 0.2 + 0.5 * g
        images[i, :, :, 1] = 0.25 + 0.3 * g
        images[i, :, :, 2] = 0.35 - 0.2 * g

    for i in range(N):
        for k in range(K):
            # Disparity shift of this rect in robot i's view.
            dx = spec.focal * offsets[i] / depths[k]
            x0 = int(np.clip(cx[k] - rw[k] / 2 + dx, 0, W))
            x1 = int(np.clip(cx[k] + rw[k] / 2 + dx, 0, W))
            y0 = int(np.clip(cy[k] - rh[k] / 2, 0, H))
            y1 = int(np.clip(cy[k] + rh[k] / 2, 0, H))
            if x0 >= x1 or y0 >= y1:
                continue  # shifted out of this robot's frustum
            images[i, y0:y1, x0:x1] = colors[k]
            depth[i, y0:y1, x0:x1] = depths[k]
            seg[i, y0:y1, x0:x1] = classes[k]

    # Mild per-view sensor noise so views are not pixel-identical.
    noise = rng.normal(0.0, 0.02, images.shape).astype(np.float32)
    images = np.clip(images + noise, 0.0, 1.0)
    return {"images": images, "depth": depth, "seg": seg,
            "positions": offsets.astype(np.float32)}
