"""The port's synthetic scenes and batches are identical to the JAX
package's for the same seed and index (renderer pinned to numpy on both
sides: the native renderer draws its noise from another RNG)."""

import dataclasses

import numpy as np
import pytest

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data import pipeline as jp
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data import pipeline as tp

from tests.test_torch_graph import assert_graph_equal


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


def test_renderer_native_not_ported():
    td = _cfgs("dynamic_swarm", )[1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.SceneDataset(dataclasses.replace(td, renderer="native"))


def test_pad_nodes_matches_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert np.array_equal(tp._pad_nodes(a, 5), jp._pad_nodes(a, 5))
    assert tp._pad_nodes(a, 2) is a
