"""The port's multi-worker loader (``data/grain_pipeline.py``, on
``torch.utils.data.DataLoader``) against the JAX package's grain loader
and the builtin pipeline: the unshuffled stream bit for bit (static and
dynamic topology, across epoch boundaries), the shuffled stream as the
builtin pipeline's, the same batches from 0 and 2 worker processes, and
exact O(1) seeks. The numpy renderer and graph builder on both sides."""

import dataclasses
import json

import numpy as np
import pytest

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data import disk as tdisk
from mrp_gnn_tpu_torch.data import pipeline as tp
from mrp_gnn_tpu_torch.data.grain_pipeline import make_grain_iterator

from tests.test_torch_graph import assert_graph_equal


def _cfgs(name="two_robot_mean", **kw):
    kw = dict(dict(image_size=(16, 16), scenes_per_batch=2,
                   num_robots=4 if name == "dynamic_swarm" else 2,
                   num_train_scenes=5, num_eval_scenes=4, renderer="numpy",
                   graph_builder="numpy"), **kw)
    return [dataclasses.replace(get(name).data, **kw)
            for get in (jget_config, tget_config)]


def _assert_batches_equal(a, b, tag=""):
    for key in ("images", "depth", "seg"):
        assert a[key].dtype == b[key].dtype, (tag, key)
        assert np.array_equal(a[key], b[key]), (tag, key)
    assert_graph_equal(a["graph"], b["graph"])


@pytest.mark.parametrize("name", ["two_robot_mean", "dynamic_swarm"])
def test_unshuffled_stream_matches_jax_grain(name):
    """6 batches of 2 over 5 scenes: batches 2 and 4 span two epochs."""
    pytest.importorskip("grain")
    from mrp_gnn_tpu.data.grain_pipeline import make_grain_iterator as jmake
    jd, td = _cfgs(name)
    j = jmake(jd, "train", shuffle=False)
    t = make_grain_iterator(td, "train", shuffle=False, workers=0)
    try:
        for i in range(6):
            _assert_batches_equal(next(t), next(j), i)
    finally:
        t.close()


def test_bounded_stream_matches_jax_grain():
    """num_epochs: the stream ends after num_epochs * scenes // batch."""
    pytest.importorskip("grain")
    from mrp_gnn_tpu.data.grain_pipeline import make_grain_iterator as jmake
    jd, td = _cfgs()
    got = list(make_grain_iterator(td, "eval", num_epochs=2, workers=0))
    want = list(jmake(jd, "eval", num_epochs=2))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_batches_equal(a, b, i)


@pytest.mark.parametrize("augment", [False, True])
def test_shuffled_stream_is_the_builtin_order(augment):
    """With whole epochs of batches (6 scenes, batches of 2), the shuffled,
    augmented stream is the builtin pipeline's, epoch after epoch."""
    _, td = _cfgs("dynamic_swarm", augment=augment, num_train_scenes=6)
    t = make_grain_iterator(td, "train", workers=0)
    builtin = iter(tp.make_dataset(td, "train").repeat())
    try:
        for i in range(6):
            _assert_batches_equal(next(t), next(builtin), i)
    finally:
        t.close()


def test_workers_give_the_same_batches():
    """Each batch is a function of its position: 2 spawned worker
    processes give the batches of the in-process loader, shuffled and
    augmented, across an epoch boundary."""
    _, td = _cfgs("dynamic_swarm", augment=True)
    a = make_grain_iterator(td, "train", workers=0)
    b = make_grain_iterator(td, "train", workers=2)
    try:
        for i in range(4):
            _assert_batches_equal(next(b), next(a), i)
        assert a.get_state() == b.get_state() == json.dumps({"batch": 4})
    finally:
        a.close()
        b.close()


def test_set_state_seeks_exactly():
    """set_state and skip land on the batch a sequential read gives, and
    make_train_iterator seeks by data_state, else by start_batch."""
    _, td = _cfgs(loader="grain")
    seq = make_grain_iterator(td, "train", workers=0)
    for _ in range(3):
        next(seq)
    state = seq.get_state()
    want = [next(seq) for _ in range(2)]
    seq.close()
    sought = make_grain_iterator(td, "train", workers=0)
    sought.set_state(state)
    skipped = make_grain_iterator(td, "train", workers=0)
    skipped.skip(3)
    resumed = tp.make_train_iterator(td, data_state=state)
    restarted = tp.make_train_iterator(td, start_batch=3)
    for it in (sought, skipped, resumed, restarted):
        for i, w in enumerate(want):
            _assert_batches_equal(next(it), w, i)
        assert it.get_state() == json.dumps({"batch": 5})
        it.close()


def test_reads_on_disk_scenes(tmp_path):
    """dataset_root through the loader: the unshuffled batches of the
    folder are the synthetic scenes' (npy is lossless)."""
    _, td = _cfgs("multitask_batched", num_robots=3)
    tdisk.export_scenes(td, str(tmp_path), "train", fmt="npy")
    disk = make_grain_iterator(dataclasses.replace(
        td, dataset_root=str(tmp_path)), "train", shuffle=False, workers=0)
    synth = make_grain_iterator(td, "train", shuffle=False, workers=0)
    for i in range(3):
        _assert_batches_equal(next(disk), next(synth), i)
    disk.close()
    synth.close()
