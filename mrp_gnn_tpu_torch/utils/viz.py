"""Qualitative visualization: dense predictions -> color PNGs (a copy of
``mrp_gnn_tpu/utils/viz.py``; numpy only, the same pixels).

Colormapped depth maps, segmentation overlays, and side-by-side
prediction/GT panels, written with PIL, which ``save_panels`` imports when
it is called. Used by
`python -m mrp_gnn_tpu_torch.evaluate --dump_dir <dir>`.
"""

from __future__ import annotations

import os

import numpy as np

# Compact inferno-like ramp; linearly interpolated to 256 entries.
_RAMP = np.array([
    [0, 0, 4], [40, 11, 84], [101, 21, 110], [159, 42, 99],
    [212, 72, 66], [245, 125, 21], [250, 193, 39], [252, 255, 164],
], np.float32)


def _colormap(x01: np.ndarray) -> np.ndarray:
    """[H, W] in [0,1] -> uint8 [H, W, 3] via the ramp."""
    x = np.clip(x01, 0.0, 1.0) * (len(_RAMP) - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, len(_RAMP) - 1)
    t = (x - lo)[..., None]
    rgb = _RAMP[lo] * (1 - t) + _RAMP[hi] * t
    return rgb.astype(np.uint8)


def depth_to_rgb(depth: np.ndarray, min_depth: float, max_depth: float) -> np.ndarray:
    """Metric depth [H, W] -> colormapped uint8 [H, W, 3] (near = bright)."""
    x = (np.asarray(depth, np.float32) - min_depth) / max(max_depth - min_depth, 1e-6)
    return _colormap(1.0 - x)


# 1 + 11 visually-distinct class colors (class 0 = background, dark).
_PALETTE = np.array([
    [30, 30, 30], [230, 80, 60], [70, 160, 240], [90, 200, 90],
    [240, 200, 60], [180, 100, 220], [240, 140, 50], [100, 220, 220],
    [220, 110, 170], [140, 140, 70], [90, 110, 220], [200, 220, 120],
], np.uint8)


def seg_to_rgb(seg: np.ndarray) -> np.ndarray:
    """Class ids [H, W] -> palette uint8 [H, W, 3]."""
    return _PALETTE[np.asarray(seg, np.int64) % len(_PALETTE)]


def save_panels(out_dir: str, images: np.ndarray, outputs: dict,
                targets: dict, node_mask: np.ndarray,
                min_depth: float, max_depth: float,
                max_views: int = 8, prefix: str = "view") -> list:
    """Write per-view side-by-side panels: RGB | depth pred | depth GT
    [| seg pred | seg GT]. Returns the written file paths."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    valid = np.nonzero(np.asarray(node_mask))[0][:max_views]
    paths = []
    for v in valid:
        cols = [(np.clip(np.asarray(images[v]), 0, 1) * 255).astype(np.uint8)]
        if "depth" in outputs:
            cols.append(depth_to_rgb(outputs["depth"][v], min_depth, max_depth))
            cols.append(depth_to_rgb(targets["depth"][v], min_depth, max_depth))
        if "seg_logits" in outputs:
            cols.append(seg_to_rgb(np.argmax(outputs["seg_logits"][v], -1)))
            cols.append(seg_to_rgb(targets["seg"][v]))
        panel = np.concatenate(cols, axis=1)
        path = os.path.join(out_dir, f"{prefix}_{int(v):03d}.png")
        Image.fromarray(panel).save(path)
        paths.append(path)
    return paths
