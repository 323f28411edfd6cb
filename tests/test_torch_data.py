"""The port's synthetic scenes and batches are identical to the JAX
package's for the same seed and index (renderer and graph builder pinned
to numpy on both sides; tests/test_torch_native.py holds the native ones)."""

import dataclasses

import numpy as np
import pytest

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


def test_train_iterator_refuses_what_is_not_ported():
    _, td = _cfgs("dynamic_swarm")
    with pytest.raises(NotImplementedError, match="queue A item 9"):
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
