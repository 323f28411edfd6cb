"""ctypes bridge to the native C++ scene renderer (``native/renderer.cc``).

Port of ``mrp_gnn_tpu/data/native.py``. The library is built from the
unchanged source at first use (``_native_loader``, into ``data/_build/``)
with a plain C interface. The world layout (rectangles, colours, classes,
camera offsets) is drawn in Python with the same seeded numpy RNG as the
numpy renderer (``synthetic.generate_scene``), so both backends render the
same geometry; the sensor noise comes from the library's own xoshiro128+
streams, so its images are those of the JAX package's native renderer, not
of the numpy one. :func:`is_available` says whether the library builds and
runs here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mrp_gnn_tpu_torch.data._native_loader import NativeLibrary
from mrp_gnn_tpu_torch.data.synthetic import camera_offsets

# Subprocess smoke call (see _native_loader): one 4x4 render of a single
# rectangle for 2 robots runs the real entry point end to end.
_SMOKE = """
import sys, ctypes
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
lib.render_scene.restype = None
vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
N, H, W, K = 2, 4, 4, 1
f32 = lambda *v: np.array(v, np.float32)
img = np.zeros(N * H * W * 3, np.float32)
dep = np.zeros(N * H * W, np.float32)
seg = np.zeros(N * H * W, np.int32)
lib.render_scene(N, H, W, K, vp(f32(5.0)), vp(f32(2.0)), vp(f32(2.0)),
                 vp(f32(2.0)), vp(f32(2.0)), vp(f32(1.0, 1.0, 1.0)),
                 vp(np.array([1], np.int32)), vp(np.zeros(N, np.float32)),
                 ctypes.c_float(4.0), ctypes.c_float(10.0),
                 ctypes.c_uint64(1), ctypes.c_float(0.0),
                 vp(img), vp(dep), vp(seg))
assert np.isfinite(dep).all() and dep.max() > 0, float(dep.max())
"""


def _configure(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.render_scene.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, f32p, f32p, f32p, i32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_uint64, ctypes.c_float,
        f32p, f32p, i32p,
    ]
    lib.render_scene.restype = None


LIBRARY = NativeLibrary("renderer", _SMOKE, _configure)


def is_available() -> bool:
    """True when the renderer library builds and passes its smoke call."""
    return LIBRARY.get() is not None


def render_scene_native(spec, seed: int, scene_index: int) -> dict:
    """Native counterpart of ``synthetic.generate_scene``: images [N, H, W,
    3] f32, depth [N, H, W] f32, seg [N, H, W] i32 and positions [N].
    Raises RuntimeError when the library cannot be built or loaded."""
    lib = LIBRARY.get()
    if lib is None:
        raise RuntimeError("the native renderer could not be built or "
                           "loaded (native/renderer.cc)")
    rng = np.random.default_rng(np.random.SeedSequence([seed, scene_index]))
    H, W = spec.image_size
    N, K = spec.num_robots, spec.num_rects

    # the draw order of synthetic.generate_scene, hence the same world
    depths = np.sort(rng.uniform(spec.min_depth, spec.max_depth, K)
                     )[::-1].astype(np.float32).copy()
    cx = (rng.uniform(0.1, 0.9, K) * W).astype(np.float32)
    cy = (rng.uniform(0.1, 0.9, K) * H).astype(np.float32)
    rw = (rng.uniform(0.12, 0.35, K) * W).astype(np.float32)
    rh = (rng.uniform(0.12, 0.35, K) * H).astype(np.float32)
    colors = rng.uniform(0.15, 1.0, (K, 3)).astype(np.float32)
    classes = rng.integers(1, spec.num_classes, K).astype(np.int32)
    offsets = camera_offsets(spec, rng).astype(np.float32)

    images = np.empty((N, H, W, 3), np.float32)
    depth = np.empty((N, H, W), np.float32)
    seg = np.empty((N, H, W), np.int32)
    lib.render_scene(
        N, H, W, K, depths, cx, cy, rw, rh,
        np.ascontiguousarray(colors), classes, offsets,
        ctypes.c_float(spec.focal), ctypes.c_float(spec.background_depth),
        ctypes.c_uint64((seed * 1000003 + scene_index) & 0xFFFFFFFFFFFFFFFF),
        ctypes.c_float(0.02),
        images, depth, seg)
    return {"images": images, "depth": depth, "seg": seg,
            "positions": offsets}
