"""On-disk dataset: per-scene folders of robot views and ground truth (port
of ``mrp_gnn_tpu/data/disk.py``, same layout, records and messages).

    root/
      train/scene_00000/
        rgb_0.png  rgb_1.png ...      (uint8 RGB, or rgb_i.npy float32 [H,W,3])
        depth_0.npy ...               (float32 [H,W] metric depth)
        seg_0.png  ...                (uint8 class ids, or seg_i.npy int32)
      eval/scene_00000/...

Set ``DataConfig.dataset_root`` to train or evaluate from such folders.
``export_scenes`` writes the synthetic scenes in this layout. PIL is
imported only to read or write a ``.png``; ``.npy`` folders need numpy
alone.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mrp_gnn_tpu_torch.config import DataConfig


def _nearest_resize(img: np.ndarray, hw: tuple) -> np.ndarray:
    """Nearest-neighbour resize by index sampling (exact for class ids)."""
    H, W = hw
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img
    ys = (np.arange(H) * h // H).astype(np.int64)
    xs = (np.arange(W) * w // W).astype(np.int64)
    return img[ys][:, xs]


def _load_image(path_base: str, hw: tuple) -> Optional[np.ndarray]:
    """rgb as float32 [H,W,3] in [0,1] from .npy or .png; None if absent."""
    if os.path.exists(path_base + ".npy"):
        return _nearest_resize(np.load(path_base + ".npy"), hw).astype(np.float32)
    if os.path.exists(path_base + ".png"):
        from PIL import Image
        arr = np.asarray(Image.open(path_base + ".png").convert("RGB"))
        return _nearest_resize(arr, hw).astype(np.float32) / 255.0
    return None


def _load_label(path_base: str, hw: tuple) -> Optional[np.ndarray]:
    """seg ids as int32 [H,W] from .npy or .png; None if absent."""
    if os.path.exists(path_base + ".npy"):
        return _nearest_resize(np.load(path_base + ".npy"), hw).astype(np.int32)
    if os.path.exists(path_base + ".png"):
        from PIL import Image
        return _nearest_resize(
            np.asarray(Image.open(path_base + ".png")), hw).astype(np.int32)
    return None


class DiskSceneDataset:
    """Map-style dataset over ``root/split/scene_XXXXX`` folders.

    Same record schema as ``data.synthetic.generate_scene`` without
    positions: images [N,H,W,3] f32 in [0,1], depth [N,H,W] f32, seg
    [N,H,W] i32, nearest-resized to ``cfg.image_size``. A missing seg gives
    zeros (depth-only datasets), a missing depth the background 15 m.
    """

    def __init__(self, cfg: DataConfig, split: str = "train",
                 root: Optional[str] = None):
        self.cfg = cfg
        self.split = split
        self.root = os.path.join(root or cfg.dataset_root, split)
        if not os.path.isdir(self.root):
            raise FileNotFoundError(f"dataset split dir missing: {self.root}")
        self.scenes = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))
        if not self.scenes:
            raise FileNotFoundError(f"no scene dirs under {self.root}")

    def __len__(self) -> int:
        return len(self.scenes)

    def __getitem__(self, idx: int) -> dict:
        d = os.path.join(self.root, self.scenes[idx])
        hw = self.cfg.image_size
        N = self.cfg.num_robots
        images, depths, segs = [], [], []
        for i in range(N):
            img = _load_image(os.path.join(d, f"rgb_{i}"), hw)
            if img is None:
                raise FileNotFoundError(
                    f"{d}: missing rgb_{i}.npy/.png (num_robots={N})")
            images.append(img)
            dp_path = os.path.join(d, f"depth_{i}.npy")
            if os.path.exists(dp_path):
                depths.append(_nearest_resize(np.load(dp_path), hw)
                              .astype(np.float32))
            else:
                depths.append(np.full(hw, 15.0, np.float32))
            seg = _load_label(os.path.join(d, f"seg_{i}"), hw)
            segs.append(seg if seg is not None else np.zeros(hw, np.int32))
        return {"images": np.stack(images), "depth": np.stack(depths),
                "seg": np.stack(segs)}


def export_scenes(cfg: DataConfig, root: str, split: str = "train",
                  num_scenes: Optional[int] = None, fmt: str = "png") -> int:
    """Write the synthetic scenes of ``split`` to ``root/split`` in the
    folder layout; returns the number written. fmt: "png" (rgb and seg as
    PNG) or "npy" (lossless float RGB); depth is always .npy."""
    from mrp_gnn_tpu_torch.data.pipeline import SceneDataset
    ds = SceneDataset(cfg, split)
    n = num_scenes if num_scenes is not None else len(ds)
    for idx in range(n):
        rec = ds[idx]
        d = os.path.join(root, split, f"scene_{idx:05d}")
        os.makedirs(d, exist_ok=True)
        for i in range(cfg.num_robots):
            if fmt == "png":
                from PIL import Image
                rgb = (rec["images"][i] * 255 + 0.5).astype(np.uint8)
                Image.fromarray(rgb).save(os.path.join(d, f"rgb_{i}.png"))
                Image.fromarray(rec["seg"][i].astype(np.uint8)).save(
                    os.path.join(d, f"seg_{i}.png"))
            else:
                np.save(os.path.join(d, f"rgb_{i}.npy"), rec["images"][i])
                np.save(os.path.join(d, f"seg_{i}.npy"), rec["seg"][i])
            np.save(os.path.join(d, f"depth_{i}.npy"), rec["depth"][i])
    return n
