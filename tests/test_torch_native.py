"""The port's native host side (``data/native.py``, ``data/graph_native.py``,
``data/_native_loader.py``) against the JAX package's: ctypes over the same
unchanged ``native/*.cc``, so renders and graph batches must agree bit for
bit, and the default ``renderer="auto"`` must feed both packages the same
scenes."""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data import graph_native as jgn
from mrp_gnn_tpu.data import native as jnative
from mrp_gnn_tpu.data import pipeline as jp
from mrp_gnn_tpu.data.synthetic import SceneSpec as JSceneSpec
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data import _native_loader, graph_native, native
from mrp_gnn_tpu_torch.data import pipeline as tp
from mrp_gnn_tpu_torch.data.synthetic import SceneSpec

from tests.test_torch_graph import assert_graph_equal
from torch_native_jax import jax_native  # noqa: F401

ROOT = _native_loader.NATIVE_DIR.parent


@pytest.fixture(scope="module", autouse=True)
def _libraries(jax_native):
    """Both packages' libraries build on this host (g++ is there); the JAX
    package's in this process's own directory (tests/torch_native_jax.py)."""
    assert native.is_available() and graph_native.is_available()


@pytest.mark.parametrize("spec", [
    dict(num_robots=4, image_size=(16, 16), num_classes=6),
    dict(num_robots=3, image_size=(24, 40), num_classes=4, num_rects=7,
         max_baseline=1.5, mobility=0.3),
])
@pytest.mark.parametrize("idx", [0, 5])
def test_render_matches_jax_bit_for_bit(spec, idx):
    got = native.render_scene_native(SceneSpec(**spec), 7, idx)
    want = jnative.render_scene_native(JSceneSpec(**spec), 7, idx)
    assert sorted(got) == sorted(want)
    for key in ("images", "depth", "seg", "positions"):
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("split", ["train", "eval"])
def test_default_dataset_matches_jax_bit_for_bit(split):
    """dynamic_swarm's data config as the preset has it (renderer "auto"):
    the same images, depth and seg in both packages; the numpy renderer's
    images differ, since its sensor noise comes from another RNG."""
    jd, td = jget_config("dynamic_swarm").data, tget_config("dynamic_swarm").data
    assert jd.renderer == td.renderer == "auto"
    jds, tds = jp.SceneDataset(jd, split), tp.SceneDataset(td, split)
    for idx in (0, 9):
        a, b = tds[idx], jds[idx]
        for key in ("images", "depth", "seg", "positions"):
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), key
    numpy_ds = tp.SceneDataset(dataclasses.replace(td, renderer="numpy"), split)
    assert not np.array_equal(numpy_ds[0]["images"], tds[0]["images"])
    assert np.array_equal(numpy_ds[0]["depth"], tds[0]["depth"])


def test_without_the_library_native_raises_and_auto_takes_numpy(monkeypatch):
    """A renderer library that does not build: render_scene_native and
    renderer="native" raise, and "auto" renders with numpy."""
    monkeypatch.setattr(native.LIBRARY, "get", lambda: None)
    spec = SceneSpec(num_robots=2, image_size=(8, 8), num_classes=3)
    with pytest.raises(RuntimeError, match="native renderer"):
        native.render_scene_native(spec, 1, 2)
    cfg = tget_config("dynamic_swarm").data
    with pytest.raises(RuntimeError, match="native renderer"):
        tp.SceneDataset(dataclasses.replace(cfg, renderer="native"))
    auto = tp.SceneDataset(cfg)[3]
    numpy_rec = tp.SceneDataset(dataclasses.replace(cfg, renderer="numpy"))[3]
    for key in ("images", "depth", "seg"):
        assert np.array_equal(auto[key], numpy_rec[key]), key


def _positions(S, N, dim, seed, spread=1.5):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, N - 1, N)
    if dim == 1:
        return [base + rng.uniform(-spread, spread, N) for _ in range(S)]
    return [np.stack([base + rng.uniform(-spread, spread, N),
                      rng.uniform(-spread, spread, N)], axis=1)
            for _ in range(S)]


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("pairs", [None, 24])
def test_batch_from_positions_native_matches_jax_and_numpy(dim, pairs):
    pos = _positions(4, 24, dim, seed=dim)
    caps = dict(radius=3.0, max_nodes=128, max_edges=4 * 24 * 23,
                max_degree=23, max_bsp_pairs=pairs)
    got = graph_native.batch_from_positions_native(
        pos, caps["radius"], caps["max_nodes"], caps["max_edges"],
        caps["max_degree"], pairs)
    assert_graph_equal(got, jgn.batch_from_positions_native(
        pos, caps["radius"], caps["max_nodes"], caps["max_edges"],
        caps["max_degree"], pairs))
    assert_graph_equal(got, jg.batch_from_positions(pos, backend="numpy",
                                                    **caps))
    assert_graph_equal(tg.batch_from_positions(pos, backend="numpy", **caps),
                       jg.batch_from_positions(pos, backend="numpy", **caps))


@pytest.mark.parametrize("xp_pairs", [None, 8])
def test_native_builder_past_the_degree_cap(xp_pairs):
    """ELL width 144 (> 128): no square plan; a row-expanded plan only on
    opt-in, as the numpy builder and the JAX package's native one."""
    pos = [np.linspace(0, 1, 140)]
    caps = dict(radius=10.0, max_nodes=256, max_edges=140 * 139,
                max_degree=139, max_bsp_pairs=None,
                max_expanded_pairs=xp_pairs)
    with _hideg_warning(xp_pairs is None):
        got = tg.batch_from_positions(pos, backend="native", **caps)
    assert got.bsp_pair_dst is None
    assert (got.bsp_expanded is None) == (xp_pairs is None)
    with _hideg_warning(xp_pairs is None):
        want = jg.batch_from_positions(pos, backend="native", **caps)
    assert_graph_equal(got, want)
    with _hideg_warning(xp_pairs is None):
        numpy_built = tg.batch_from_positions(pos, backend="numpy", **caps)
    assert_graph_equal(numpy_built, want)


@contextlib.contextmanager
def _hideg_warning(expected: bool):
    """The warning of a wide batch without a row-expanded plan, or none."""
    if expected:
        with pytest.warns(UserWarning, match="row-expanded plan"):
            yield
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield


@pytest.mark.parametrize("caps,match", [
    (dict(max_edges=10), "edge capacity"),
    (dict(max_degree=7), "in-degree capacity"),
    (dict(max_bsp_pairs=1), "tile-pair capacity"),
])
def test_native_capacity_errors_match_jax(caps, match):
    """Two fully connected scenes of 16 in 48 slots (tile 16, 3 tiles)."""
    pos = _positions(2, 16, 1, seed=3)
    kw = dict(radius=30.0, max_nodes=48, max_edges=2 * 16 * 15, max_degree=15,
              max_bsp_pairs=None)
    kw.update(caps)
    args = (pos, kw["radius"], kw["max_nodes"], kw["max_edges"],
            kw["max_degree"], kw["max_bsp_pairs"])
    with pytest.raises(ValueError, match=match) as got:
        graph_native.batch_from_positions_native(*args)
    with pytest.raises(ValueError, match=match) as want:
        jgn.batch_from_positions_native(*args)
    assert str(got.value) == str(want.value)


def test_native_builder_leaves_other_shapes_to_numpy():
    """Scenes of different sizes are outside the native builder's shapes:
    None from it, "auto" gives the numpy builder's batch, and "native"
    raises instead of falling back."""
    pos = [np.arange(5.0), np.arange(7.0)]
    caps = dict(radius=1.5, max_nodes=16, max_edges=64, max_degree=4)
    assert graph_native.batch_from_positions_native(
        pos, caps["radius"], caps["max_nodes"], caps["max_edges"],
        caps["max_degree"], None) is None
    assert_graph_equal(tg.batch_from_positions(pos, **caps),
                       jg.batch_from_positions(pos, backend="numpy", **caps))
    with pytest.raises(RuntimeError, match="native graph builder"):
        tg.batch_from_positions(pos, backend="native", **caps)


# What native/ may hold: the sources and the JAX package's own builds, which
# its loader writes there (other test files may build them meanwhile).
NATIVE_FILES = {"graphbuild.cc", "renderer.cc", "libgraphbuild.so",
                "libgraphbuild.so.ok", "librenderer.so", "librenderer.so.ok"}


def _sources():
    return {p.name: p.read_bytes() for p in (ROOT / "native").glob("*.cc")}


def test_builds_go_to_the_port_directory_not_native(tmp_path, monkeypatch):
    """A fresh build of both libraries lands in the port's build directory
    under a hashed name, with its smoke stamp; nothing of the port's is
    written under native/, and the sources stay as they are."""
    before = _sources()
    monkeypatch.setattr(_native_loader, "BUILD_DIR", tmp_path / "_build")
    for mod in (native, graph_native):
        lib = mod.LIBRARY
        monkeypatch.setattr(mod, "LIBRARY", _native_loader.NativeLibrary(
            lib.name, lib.smoke_code, lib.configure))
        assert mod.is_available()
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert [n.split("-")[0] for n in built] == [
        "libgraphbuild", "libgraphbuild", "librenderer", "librenderer"]
    assert sum(n.endswith(".so.ok") for n in built) == 2
    assert not any(n.endswith(".tmp") for n in built)
    assert {p.name for p in (ROOT / "native").iterdir()} <= NATIVE_FILES
    assert _sources() == before
    spec = SceneSpec(num_robots=2, image_size=(8, 8), num_classes=3)
    assert np.array_equal(native.render_scene_native(spec, 1, 2)["images"],
                          jnative.render_scene_native(
                              JSceneSpec(num_robots=2, image_size=(8, 8),
                                         num_classes=3), 1, 2)["images"])


def test_library_path_follows_the_source():
    """The build's name carries a hash of the source and the flags."""
    path = _native_loader.library_path("renderer")
    assert path.parent == _native_loader.BUILD_DIR
    assert path.name.startswith("librenderer-") and path.suffix == ".so"
    assert _native_loader.library_path("graphbuild") != path


def test_jax_libraries_are_this_process_own(jax_native):
    """The JAX package's loaders build and load this process's own copies,
    outside native/, where the JAX package's own tests build theirs."""
    for mod, name in ((jnative, "librenderer.so"), (jgn, "libgraphbuild.so")):
        lib = Path(mod._LIB)
        assert lib == jax_native / name and lib.exists()
        assert (ROOT / "native") not in lib.parents
        assert mod._lib is not None and not mod._failed


_LOAD_AT_ONCE = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from mrp_gnn_tpu_torch.data import _native_loader, native
    _native_loader.BUILD_DIR = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.01)
    lib = _native_loader.load_verified("renderer", native.LIBRARY.smoke_code)
    sys.exit(0 if lib is not None else 3)
""")


def test_port_loader_builds_once_for_processes_that_load_at_once(tmp_path):
    """Four processes load the renderer from one fresh build directory at
    the same moment: each gets a library that passed its smoke call, and no
    temporary file is left (each build writes a name of its own, moved into
    place whole)."""
    build = tmp_path / "_build"
    go = tmp_path / "go"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_AT_ONCE,
                               str(build), str(go)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(4)]
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[0] for o in outs]
    names = sorted(p.name for p in build.iterdir())
    assert not any(n.endswith(".tmp") for n in names), names
    assert [n for n in names if n.endswith(".so")] == [
        _native_loader.library_path("renderer").name]
