"""A frozen copy of the synthetic scenes that the training stream renders,
so that the reference trains on frames it made itself.

A scene is drawn from ``(seed, scene_index)``: eight layered rectangles at
metric depths, their colours and classes, then each robot's lateral camera
offset. Each robot's view is painted far to near over a background
gradient, with the rectangles shifted by their disparity, and then gets
sensor noise from its own xoshiro128+ stream (Box-Muller), clipped to
[0, 1]: the native renderer's rules, in float32.

Where the native renderer's compiler fuses a multiply and an add, the copy
rounds once from float64, and its sine, cosine and logarithm are float64
rounded to float32; a frame may differ from the program's by a rounding,
never by a pixel of geometry. Plain numpy; nothing of the program is
imported.
"""

from __future__ import annotations

import numpy as np

SLOT_SPACING_M = 0.25   # metres between nominal camera slots
NUM_RECTS = 8
DEPTH_RANGE_M = (1.0, 10.0)
BACKGROUND_DEPTH_M = 15.0
FOCAL_PX = 40.0
NOISE_STD = 0.02
TWO_PI = np.float32(6.2831853)

_U64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_ROBOT_STRIDE = 0x9E3779B9
_f32 = np.float32


def scene_world(num_robots: int, mobility: float, seed: int,
                scene_index: int, image_size=(1, 1),
                num_classes: int = 6) -> dict:
    """One scene's rectangles (far to near, pixel units, float32) and its
    cameras' lateral offsets (metres, float32): the nominal baseline plus a
    uniform drift of ``mobility`` slots."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, scene_index]))
    H, W = image_size
    k = NUM_RECTS
    depths = np.sort(rng.uniform(*DEPTH_RANGE_M, k))[::-1].astype(_f32)
    cx = (rng.uniform(0.1, 0.9, k) * W).astype(_f32)
    cy = (rng.uniform(0.1, 0.9, k) * H).astype(_f32)
    rw = (rng.uniform(0.12, 0.35, k) * W).astype(_f32)
    rh = (rng.uniform(0.12, 0.35, k) * H).astype(_f32)
    colors = rng.uniform(0.15, 1.0, (k, 3)).astype(_f32)
    classes = rng.integers(1, num_classes, k).astype(np.int32)
    n = num_robots
    base = SLOT_SPACING_M * max(n - 1, 1)
    offsets = (np.linspace(-base / 2, base / 2, n) if n > 1
               else np.zeros(1))
    if mobility > 0:
        drift = mobility * SLOT_SPACING_M
        offsets = offsets + rng.uniform(-drift, drift, n)
    return {"depths": depths, "cx": cx, "cy": cy, "rw": rw, "rh": rh,
            "colors": colors, "classes": classes,
            "offsets": offsets.astype(_f32)}


def _fused(a, b, c) -> np.ndarray:
    """a x b + c rounded once to float32."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_f32)


def _paint(world: dict, image_size) -> tuple:
    """Noise-free views of one scene: images [N, H, W, 3], depth [N, H, W],
    seg [N, H, W]."""
    H, W = image_size
    off = world["offsets"]
    n = len(off)
    xs = np.arange(W, dtype=_f32) / _f32(W - 1)
    arg = TWO_PI * _fused(_f32(0.05), off[:, None], xs[None, :])
    g = _fused(_f32(0.2), np.sin(arg.astype(np.float64)).astype(_f32),
               _f32(0.15))                                    # [N, W]
    row = np.stack([_fused(_f32(0.5), g, _f32(0.2)),
                    _fused(_f32(0.3), g, _f32(0.25)),
                    _fused(_f32(-0.2), g, _f32(0.35))], -1)  # [N, W, 3]
    images = np.repeat(row[:, None], H, axis=1)
    depth = np.full((n, H, W), BACKGROUND_DEPTH_M, _f32)
    seg = np.zeros((n, H, W), np.int32)
    dx = _f32(FOCAL_PX) * off[:, None] / world["depths"][None, :]  # [N, K]
    half_w, half_h = world["rw"] / _f32(2), world["rh"] / _f32(2)
    x0 = np.clip((world["cx"] - half_w + dx).astype(np.int64), 0, W)
    x1 = np.clip((world["cx"] + half_w + dx).astype(np.int64), 0, W)
    y0 = np.clip((world["cy"] - half_h).astype(np.int64), 0, H)
    y1 = np.clip((world["cy"] + half_h).astype(np.int64), 0, H)
    for i in range(n):
        for k in range(len(world["depths"])):
            a, b, c, d = x0[i, k], x1[i, k], y0[k], y1[k]
            if a >= b or c >= d:
                continue
            images[i, c:d, a:b] = world["colors"][k]
            depth[i, c:d, a:b] = world["depths"][k]
            seg[i, c:d, a:b] = world["classes"][k]
    return images, depth, seg


def _stream_states(seeds) -> list:
    """xoshiro128+ states of each stream seed (splitmix64 expansion), as
    four uint32 lanes."""
    lanes = [[], [], [], []]
    for seed in seeds:
        s = seed
        for j in range(4):
            s = (s + _GOLDEN) & _U64
            z = s
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
            lanes[j].append(((z ^ (z >> 31)) >> 16) & 0xFFFFFFFF)
    return [np.array(v, np.uint32) for v in lanes]


def _normals(seeds, count: int) -> np.ndarray:
    """[count, streams] float32 normal draws, one Box-Muller value per two
    uniforms, each stream seeded by ``seeds``."""
    s0, s1, s2, s3 = _stream_states(seeds)
    raw = np.empty((2 * count, len(seeds)), np.uint32)
    t = np.empty_like(s0)
    nine, eleven, rest = np.uint32(9), np.uint32(11), np.uint32(21)
    for p in range(2 * count):
        np.add(s0, s3, out=raw[p])
        np.left_shift(s1, nine, out=t)
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = (s3 << eleven) | (s3 >> rest)
    u = ((raw >> np.uint32(8)).astype(_f32) * _f32(1.0 / 16777216.0))
    u1 = np.maximum(u[0::2], _f32(1e-7))
    r = np.sqrt(_f32(-2.0) * np.log(u1.astype(np.float64)).astype(_f32))
    c = np.cos((TWO_PI * u[1::2]).astype(np.float64)).astype(_f32)
    return r * c


def render_scenes(worlds_and_seeds, image_size) -> tuple:
    """Views of several scenes, one after the other: ``worlds_and_seeds``
    is a list of (``scene_world(...)``, stream seed); a robot's noise
    stream is the scene's stream seed plus its index times 0x9E3779B9.
    Returns images [R, H, W, 3] float32, depth [R, H, W] float32 and seg
    [R, H, W] int32 over the R robots of all scenes."""
    H, W = image_size
    parts = [_paint(w, image_size) for w, _ in worlds_and_seeds]
    images = np.concatenate([p[0] for p in parts])
    seeds = [(seed + i * _ROBOT_STRIDE) & _U64
             for w, seed in worlds_and_seeds for i in range(len(w["offsets"]))]
    noise = _normals(seeds, H * W * 3).T.reshape(images.shape)
    images = np.clip(_fused(_f32(NOISE_STD), noise, images), _f32(0.0),
                     _f32(1.0))
    return (images, np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def noise_seed(stream_seed: int, scene_index: int) -> int:
    """The scene's noise stream seed for the training split's seed."""
    return (stream_seed * 1000003 + scene_index) & _U64
