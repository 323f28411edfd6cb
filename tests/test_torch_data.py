"""The port's synthetic scenes and batches are identical to the JAX
package's for the same seed and index (renderer and graph builder pinned
to numpy on both sides; tests/test_torch_native.py holds the native ones)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data import pipeline as jp
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data import pipeline as tp

from tests.test_torch_graph import assert_graph_equal
from torch_native_jax import jax_native  # noqa: F401


def _cfgs(name, **data):
    out = []
    for get in (jget_config, tget_config):
        cfg = get(name)
        d = dataclasses.replace(cfg.data, image_size=(16, 16),
                                renderer="numpy", graph_builder="numpy",
                                num_train_scenes=6, num_eval_scenes=5, **data)
        out.append(d)
    return out


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("degraded", [0.0, 0.5])
def test_scene_dataset_matches_jax(split, degraded):
    jd, td = _cfgs("dynamic_swarm", degraded_fraction=degraded)
    jds, tds = jp.SceneDataset(jd, split), tp.SceneDataset(td, split)
    assert len(jds) == len(tds)
    for idx in (0, 3):
        a, b = tds[idx], jds[idx]
        assert sorted(a) == sorted(b)
        for key in ("images", "depth", "seg", "positions"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), key
        assert np.array_equal(tds.positions(idx), jds.positions(idx))


@pytest.mark.parametrize("name,split", [("dynamic_swarm", "eval"),
                                        ("dynamic_swarm", "train"),
                                        ("multitask_batched", "eval")])
def test_batches_match_jax(name, split):
    jd, td = _cfgs(name, num_robots=8, scenes_per_batch=2)
    jit = jp.make_dataset(jd, split)
    tit = tp.make_dataset(td, split)
    n = 0
    for a, b in zip(tit, jit):  # eval: the partial final batch is padded
        for key in ("images", "depth", "seg"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), key
        assert_graph_equal(a["graph"], b["graph"])
        n += 1
    assert n == (3 if split == "eval" else 3)
    assert tit.max_nodes == jit.max_nodes


@pytest.mark.usefixtures("jax_native")
def test_renderer_native_not_ported():
    """The native renderer is ported: renderer "native" gives the JAX
    package's native scenes bit for bit; an unknown renderer raises."""
    jd, td = (dataclasses.replace(d, renderer="native")
              for d in _cfgs("dynamic_swarm"))
    a, b = tp.SceneDataset(td)[2], jp.SceneDataset(jd)[2]
    for key in ("images", "depth", "seg", "positions"):
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    with pytest.raises(ValueError, match="renderer"):
        tp.SceneDataset(dataclasses.replace(td, renderer="opengl"))


def test_pad_nodes_matches_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert np.array_equal(tp._pad_nodes(a, 5), jp._pad_nodes(a, 5))
    assert tp._pad_nodes(a, 2) is a


@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_iterator_matches_jax(prefetch):
    """The endless training stream crosses an epoch boundary (3 batches of
    2 scenes per epoch of 6) in the same order as the JAX stream, with and
    without the prefetch thread."""
    jd, td = _cfgs("dynamic_swarm", prefetch=prefetch, scenes_per_batch=2)
    jit, tit = jp.make_train_iterator(jd), tp.make_train_iterator(td)
    try:
        for _ in range(4):
            a, b = next(tit), next(jit)
            for key in ("images", "depth", "seg"):
                assert np.array_equal(a[key], b[key]), key
            assert_graph_equal(a["graph"], b["graph"])
    finally:
        for it in (jit, tit):
            if hasattr(it, "close"):
                it.close()


def test_train_iterator_refuses_what_is_not_ported(monkeypatch):
    """Everything of the data layer is ported; what still raises is the
    worker loader in a process group of more than one process (as the JAX
    package raises for more than one process)."""
    _, td = _cfgs("dynamic_swarm")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="single-process only"):
        tp.make_train_iterator(dataclasses.replace(td, loader="grain"))


def test_prefetch_relays_a_producer_error():
    _, td = _cfgs("two_robot_mean", prefetch=1)

    class Broken(tp.BatchIterator):
        def __iter__(self):
            raise ValueError("renderer failed")
            yield

    it = tp.PrefetchIterator(Broken(tp.SceneDataset(td, "train"), 2))
    try:
        for _ in range(2):  # raised again, never a hang
            with pytest.raises(ValueError, match="renderer failed"):
                next(it)
    finally:
        it.close()


# --- augmentation, per-host node ranges, TransformIterator ------------------


@pytest.mark.parametrize("seed", [3, 4, 11])  # flip (3) and no flip (4)
def test_augment_scene_matches_jax(seed):
    jd, td = _cfgs("dynamic_swarm", num_robots=5)
    rec = tp.SceneDataset(td, "train")[1]
    a = tp.augment_scene(rec, np.random.default_rng(seed))
    b = jp.augment_scene(rec, np.random.default_rng(seed))
    assert sorted(a) == sorted(b) == ["depth", "images", "positions", "seg"]
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    static = {k: v for k, v in rec.items() if k != "positions"}
    a = tp.augment_scene(static, np.random.default_rng(seed))
    assert "positions" not in a
    assert np.array_equal(a["images"], jp.augment_scene(
        static, np.random.default_rng(seed))["images"])


@pytest.mark.parametrize("name", ["dynamic_swarm", "multitask_batched"])
def test_augmented_batches_match_jax(name):
    """Two epochs of augmented, shuffled batches: each scene's draws come
    from (seed + 1, epoch, scene) on both sides."""
    jd, td = _cfgs(name, num_robots=4, scenes_per_batch=2, augment=True)
    jit = iter(jp.make_dataset(jd, "train").repeat())
    tit = iter(tp.make_dataset(td, "train").repeat())
    plain = next(iter(tp.make_dataset(dataclasses.replace(td, augment=False),
                                      "train")))
    for i in range(6):
        a, b = next(tit), next(jit)
        for key in ("images", "depth", "seg"):
            assert np.array_equal(a[key], b[key]), (i, key)
        assert_graph_equal(a["graph"], b["graph"])
        if i == 0:
            assert not np.array_equal(a["images"], plain["images"])


@pytest.mark.parametrize("name", ["two_robot_mean", "dynamic_swarm"])
def test_local_batch_matches_jax(name):
    """node_range batches: the same rows and the same whole-batch graph as
    the JAX package's, for a range inside one scene's rows and one across
    scenes, with the augmentation's flip replayed for scenes not rendered."""
    jd, td = _cfgs(name, scenes_per_batch=3, augment=True)
    V = tp.make_dataset(td, "train").max_nodes
    n = td.num_robots
    for lo, hi in ((V // 2, V), (1, n + 1)):
        jit = jp.make_dataset(jd, "train", node_range=(lo, hi))
        tit = tp.make_dataset(td, "train", node_range=(lo, hi))
        full = next(iter(tp.make_dataset(td, "train")))
        a, b = next(iter(tit)), next(iter(jit))
        assert a["node_range"] == b["node_range"] == (lo, hi)
        for key in ("images", "depth", "seg"):
            assert np.array_equal(a[key], b[key]), key
            assert np.array_equal(a[key], full[key][lo:hi]), key
        assert_graph_equal(a["graph"], b["graph"])
        assert_graph_equal(a["graph"], full["graph"])


def test_train_iterator_passes_node_range():
    _, td = _cfgs("dynamic_swarm", scenes_per_batch=2, prefetch=0)
    it = tp.make_train_iterator(td, start_batch=1, node_range=(0, 5))
    full = tp.make_train_iterator(td, start_batch=1)
    a, b = next(it), next(full)
    assert a["images"].shape[0] == 5
    assert np.array_equal(a["images"], b["images"][:5])


def test_transform_iterator_state_aligns_with_consumption():
    """The producer runs ahead; get_state() is the inner state as of the
    batch last handed to the consumer."""
    class Counting:
        def __init__(self):
            self.i = 0

        def __next__(self):
            self.i += 1
            return {"n": self.i}

        def get_state(self):
            return self.i

    inner = Counting()
    it = tp.TransformIterator(inner, lambda b: {**b, "seen": True}, depth=3)
    got = [next(it) for _ in range(3)]
    assert [b["n"] for b in got] == [1, 2, 3]
    assert all(b["seen"] for b in got)
    deadline = time.monotonic() + 5.0
    while inner.i <= 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert inner.i > 3  # it ran ahead
    assert it.get_state() == 3  # the state follows the consumer
    it.close()


def test_transform_iterator_reraises_errors():
    """A producer error, and the end of the stream, are raised again on
    every later next(), promptly."""
    def gen():
        yield {"n": 1}
        raise RuntimeError("boom")

    it = tp.TransformIterator(gen(), lambda b: b)
    assert next(it)["n"] == 1
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
    done = tp.TransformIterator(iter([{"n": 1}]), lambda b: b)
    assert next(done)["n"] == 1
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(done)
    bad = tp.TransformIterator(iter([{"n": 1}]), lambda b: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        next(bad)


@pytest.mark.parametrize("close_inner", [True, False])
def test_transform_iterator_close_cascades_and_joins(close_inner):
    """close() stops and joins the producer, and closes the inner iterator
    unless it is the caller's."""
    class Inner:
        def __init__(self):
            self.closed = False
            self.i = 0

        def __next__(self):
            self.i += 1
            time.sleep(0.001)
            return {"n": self.i}

        def close(self):
            self.closed = True

    inner = Inner()
    it = tp.TransformIterator(inner, lambda b: b, depth=1,
                              close_inner=close_inner)
    assert next(it)["n"] == 1
    it.close()
    assert inner.closed == close_inner
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
