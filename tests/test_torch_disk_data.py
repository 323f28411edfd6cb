"""The port's on-disk dataset (``data/disk.py``) against the JAX package's:
the same folders (written by ``export_scenes`` of either package) read to
the same records, resized and refused the same way, and batched by
``make_dataset`` into the same batches. The numpy renderer on both sides;
PNG cases need PIL."""

import dataclasses
import os

import numpy as np
import pytest

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data import disk as jdisk
from mrp_gnn_tpu.data import pipeline as jp
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data import disk as tdisk
from mrp_gnn_tpu_torch.data import pipeline as tp

from tests.test_torch_graph import assert_graph_equal


def _cfgs(**kw):
    return [dataclasses.replace(
        get("multitask_batched").data, image_size=(16, 16), num_robots=3,
        scenes_per_batch=2, num_train_scenes=4, num_eval_scenes=2,
        renderer="numpy", graph_builder="numpy", **kw)
        for get in (jget_config, tget_config)]


def _fmt(fmt):
    if fmt == "png":
        pytest.importorskip("PIL")
    return fmt


def _assert_records_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_export_writes_the_jax_files(tmp_path, fmt):
    jd, td = _cfgs()
    assert tdisk.export_scenes(td, str(tmp_path / "t"), "train",
                               fmt=_fmt(fmt)) == 4
    assert jdisk.export_scenes(jd, str(tmp_path / "j"), "train", fmt=fmt) == 4
    files = sorted(os.listdir(tmp_path / "t" / "train" / "scene_00002"))
    assert files == sorted(os.listdir(tmp_path / "j" / "train" / "scene_00002"))
    for f in files:
        got = (tmp_path / "t" / "train" / "scene_00002" / f).read_bytes()
        want = (tmp_path / "j" / "train" / "scene_00002" / f).read_bytes()
        assert got == want, f


@pytest.mark.parametrize("fmt", ["npy", "png"])
@pytest.mark.parametrize("image_size", [(16, 16), (8, 12)])
def test_disk_records_match_jax(tmp_path, fmt, image_size):
    """One folder read by both packages, at its own size and resized."""
    jd, td = _cfgs()
    jdisk.export_scenes(jd, str(tmp_path), "eval", fmt=_fmt(fmt))
    jd, td = (dataclasses.replace(d, image_size=image_size) for d in (jd, td))
    tds = tdisk.DiskSceneDataset(td, "eval", root=str(tmp_path))
    jds = jdisk.DiskSceneDataset(jd, "eval", root=str(tmp_path))
    assert len(tds) == len(jds) == 2
    for idx in range(2):
        rec = tds[idx]
        assert rec["images"].shape == (3, *image_size, 3)
        _assert_records_equal(rec, jds[idx])


def test_disk_fallbacks_and_errors_match_jax(tmp_path):
    jd, td = _cfgs()
    root = str(tmp_path)
    tdisk.export_scenes(td, root, "train", num_scenes=2, fmt="npy")
    scene = tmp_path / "train" / "scene_00001"
    os.remove(scene / "depth_0.npy")  # the background depth
    os.remove(scene / "seg_2.npy")    # zeros
    a = tdisk.DiskSceneDataset(td, "train", root=root)[1]
    _assert_records_equal(a, jdisk.DiskSceneDataset(jd, "train",
                                                    root=root)[1])
    assert (a["depth"][0] == 15.0).all() and (a["seg"][2] == 0).all()
    os.remove(scene / "rgb_1.npy")
    for ds in (tdisk.DiskSceneDataset(td, "train", root=root),
               jdisk.DiskSceneDataset(jd, "train", root=root)):
        with pytest.raises(FileNotFoundError, match="missing rgb_1"):
            ds[1]
    for mod, d in ((tdisk, td), (jdisk, jd)):
        with pytest.raises(FileNotFoundError, match="split dir missing"):
            mod.DiskSceneDataset(d, "eval", root=root)
        os.makedirs(tmp_path / "empty" / "eval", exist_ok=True)
        with pytest.raises(FileNotFoundError, match="no scene dirs"):
            mod.DiskSceneDataset(d, "eval", root=str(tmp_path / "empty"))


@pytest.mark.parametrize("augment", [False, True])
def test_disk_batches_match_jax(tmp_path, augment):
    """make_dataset with dataset_root: the same shuffled (and augmented)
    batches as the JAX package's, and, unaugmented, the synthetic
    pipeline's batches (npy is lossless)."""
    jd, td = _cfgs(augment=augment)
    tdisk.export_scenes(td, str(tmp_path), "train", fmt="npy")
    jd, td = (dataclasses.replace(d, dataset_root=str(tmp_path))
              for d in (jd, td))
    jit = iter(jp.make_dataset(jd, "train").repeat())
    tit = iter(tp.make_dataset(td, "train").repeat())
    synth = iter(tp.make_dataset(dataclasses.replace(td, dataset_root=""),
                                 "train").repeat())
    for i in range(3):
        a, b, s = next(tit), next(jit), next(synth)
        for key in ("images", "depth", "seg"):
            assert np.array_equal(a[key], b[key]), (i, key)
            if not augment:
                assert np.array_equal(a[key], s[key]), (i, key)
        assert_graph_equal(a["graph"], b["graph"])
