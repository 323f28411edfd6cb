"""The reference's frozen scene generator against the program's training
stream: the same geometry, depth and labels bit for bit, frames within one
rounding, and the checked batches that the reference makes for itself."""

import numpy as np
import pytest
import torch

from perfbench.reference import render
from perfbench.reference.graph import train_batch_scenes, train_scene_seed

ONE_ROUNDING = 6e-8  # float32 spacing below 1


def _spec(robots: int, mobility: float, size):
    from mrp_gnn_tpu_torch.data.synthetic import SceneSpec
    return SceneSpec(num_robots=robots, image_size=size, num_classes=6,
                     max_baseline=0.25 * max(robots - 1, 1),
                     mobility=mobility * 0.25)


@pytest.mark.parametrize("robots,mobility,size", [
    (32, 1.5, (64, 64)), (193, 0.0, (64, 64)), (8, 1.5, (16, 16))])
@pytest.mark.parametrize("seed,scene", [(0, 0), (2 * (2**40 + 17), 511)])
def test_scenes_are_the_native_renderers(robots, mobility, size, seed, scene):
    from mrp_gnn_tpu_torch.data import native
    if not native.is_available():
        pytest.skip("the native renderer does not build here")
    prog = native.render_scene_native(_spec(robots, mobility, size), seed,
                                      scene)
    world = render.scene_world(robots, mobility, seed, scene, size, 6)
    images, depth, seg = render.render_scenes(
        [(world, render.noise_seed(seed, scene))], size)
    np.testing.assert_array_equal(world["offsets"], prog["positions"])
    np.testing.assert_array_equal(depth, prog["depth"])
    np.testing.assert_array_equal(seg, prog["seg"])
    assert images.dtype == np.float32 and seg.dtype == np.int32
    assert np.abs(images - prog["images"]).max() <= ONE_ROUNDING


def test_noise_streams_differ_by_robot_and_scene():
    a = render.render_scenes([(render.scene_world(3, 0.0, 5, 0, (8, 8)),
                               render.noise_seed(10, 0))], (8, 8))[0]
    b = render.render_scenes([(render.scene_world(3, 0.0, 5, 0, (8, 8)),
                               render.noise_seed(10, 1))], (8, 8))[0]
    assert not np.array_equal(a, b)
    assert not np.array_equal(a[0], a[1])


@pytest.mark.parametrize("config", ["dynamic_swarm", "dense_swarm"])
def test_checked_batches_are_the_programs(tmp_path, config):
    """The batches that the training driver's reference renders are the
    program's first batches of the same stream."""
    from mrp_gnn_tpu_torch.data import native
    from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
    from perfbench import cells
    from perfbench.drivers import ref_graph
    from perfbench.tests.tiny import tiny_root
    if not native.is_available():
        pytest.skip("the native renderer does not build here")
    root = tiny_root(tmp_path)
    doc = cells.load("configs", config, root)
    seed = 2**33 + 7
    cfg = cells.port_config(doc, seed)
    d = doc["data"]
    stream = train_scene_seed(seed)
    it = make_train_iterator(cfg.data)
    try:
        for index in range(2):
            batch = next(it)
            scenes = train_batch_scenes(d["num_train_scenes"],
                                        d["scenes_per_batch"], seed, index)
            made = [(render.scene_world(d["num_robots"], d["mobility"],
                                        stream, int(s), tuple(d["image_size"]),
                                        d["num_seg_classes"]),
                     render.noise_seed(stream, int(s))) for s in scenes]
            images, depth, seg = render.render_scenes(made,
                                                      tuple(d["image_size"]))
            real = len(images)
            np.testing.assert_array_equal(np.asarray(batch["depth"])[:real],
                                          depth)
            np.testing.assert_array_equal(np.asarray(batch["seg"])[:real], seg)
            assert np.abs(np.asarray(batch["images"])[:real]
                          - images).max() <= ONE_ROUNDING
            assert not np.asarray(batch["images"])[real:].any()
            positions = ([w["offsets"] for w, _ in made]
                         if d["connectivity"] == "radius" else None)
            g = ref_graph(d, positions)
            assert g.num_edges == int(batch["graph"].n_edges)
            assert int(g.node_mask.sum()) == int(batch["graph"].n_nodes)
    finally:
        it.close()
