"""train() with the data layer and the batch placement of this port, on the
CPU: records bit for bit with the producer thread in the stream and with a
caller's iterator of the same batches, accumulation through the stacker as
through ``_microbatches``, a worker-loader run that saves its stream
position and resumes exactly, augmentation and on-disk scenes, and the CLI
flags. One intra-op thread where records are compared bit for bit (torch's
CPU kernels are not bit-reproducible across runs otherwise)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data import disk as tdisk
from mrp_gnn_tpu_torch.data import pipeline as tp

from torch_small import small

TIMING = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")


def _terms(records):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in records]


def _cfg(**train):
    return small(get_config("dynamic_swarm"), log_every=1, **train)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _first(it, n):
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.usefixtures("one_thread")
def test_producer_stream_keeps_the_records():
    """The loop's own stream (a producer thread places each batch) and a
    caller's iterator of the same batches give the same records; the
    caller's iterator is not closed."""
    cfg = _cfg()
    _, own = TT.train(cfg, num_steps=3, device="cpu")
    batches = _first(tp.make_train_iterator(cfg.data), 3)

    class Caller:
        closed = False

        def __init__(self):
            self._it = iter(batches)

        def __next__(self):
            return next(self._it)

        def close(self):
            self.closed = True

    theirs_it = Caller()
    _, theirs = TT.train(cfg, num_steps=3, data_iter=theirs_it, device="cpu")
    assert _terms(own) == _terms(theirs) and len(own) == 3
    assert not theirs_it.closed


def test_batch_placer_passes_cpu_batches():
    batch = next(iter(tp.make_dataset(_cfg().data, "train")))
    assert TT.BatchPlacer("cpu")(batch) is batch
    images, depth, seg, graph = TT.batch_to_device(batch, "cpu")
    assert np.array_equal(images.numpy(), batch["images"])
    assert graph.ell_src.data_ptr() == batch["graph"].ell_src.data_ptr()


@pytest.mark.usefixtures("one_thread")
def test_accumulation_through_the_stacker_matches_microbatches():
    """accum 2: train() groups on the stacker's producer thread; the same
    steps taken on _microbatches' groups give the same terms."""
    cfg = _cfg(grad_accum_steps=2)
    batches = _first(tp.make_train_iterator(cfg.data), 4)
    _, records = TT.train(cfg, num_steps=2, data_iter=iter(batches),
                          device="cpu")
    state = TT.create_train_state(cfg, "cpu")
    step = TT.make_train_step(cfg, state.model, state.optimizer)
    want = []
    for group in TT._microbatches(iter(batches), 2):
        state, terms = step(state, *TT.batch_to_device(group, "cpu"))
        want.append({"step": state.step,
                     **{k: float(v) for k, v in terms.items()}})
    assert _terms(records) == want


def test_stacker_state_follows_the_groups():
    class Counting:
        def __init__(self):
            self.i = 0

        def __next__(self):
            self.i += 1
            z = np.full((2,), self.i, np.float32)
            return {"images": z, "depth": z, "seg": z, "graph": "g"}

        def get_state(self):
            return self.i

    inner = Counting()
    st = TT._MicrobatchStacker(inner, 3)
    try:
        g = next(st)
        assert g["images"].shape == (3, 2) and g["graph"] == "g"
        assert np.array_equal(g["images"][:, 0], [1, 2, 3])
        assert st.get_state() == 3
        next(st)
        assert st.get_state() == 6
    finally:
        st.close()
    assert not st._groups._thread.is_alive()


@pytest.mark.usefixtures("one_thread")
def test_worker_loader_run_resumes_exactly(tmp_path):
    """loader="grain": each checkpoint carries the stream position of the
    batches the loop took; a run resumed from step 2 gives the straight
    run's records for steps 3 and 4."""
    def cfg(d):
        c = _cfg(checkpoint_dir=str(tmp_path / d), checkpoint_every=2)
        return c.replace(data=dataclasses.replace(c.data, loader="grain"),
                         train=dataclasses.replace(c.train, steps=4))

    _, straight = TT.train(cfg("a"), device="cpu")
    with open(tmp_path / "a" / "data_state_2.json") as f:
        assert json.load(f) == {"batch": 2}
    TT.train(cfg("b"), num_steps=2, device="cpu")
    _, resumed = TT.train(cfg("b"), device="cpu")
    assert [r["step"] for r in resumed] == [3, 4]
    assert _terms(resumed) == _terms(straight)[2:]


@pytest.mark.parametrize("source", ["augment", "dataset_root"])
def test_augmented_and_disk_runs_train(tmp_path, source):
    cfg = _cfg()
    if source == "augment":
        data = dataclasses.replace(cfg.data, augment=True)
    else:
        tdisk.export_scenes(cfg.data, str(tmp_path), "train", fmt="npy")
        # on-disk records carry no positions: a static radius topology
        data = dataclasses.replace(cfg.data, dataset_root=str(tmp_path),
                                   mobility=0.0)
    _, records = TT.train(cfg.replace(data=data), num_steps=2, device="cpu")
    assert len(records) == 2
    assert all(np.isfinite(r["total"]) for r in records)


def test_train_cli_takes_dataset_root_and_augment(tmp_path, monkeypatch,
                                                  capsys):
    data = dataclasses.replace(get_config("single_robot_depth").data,
                               num_train_scenes=8)
    tdisk.export_scenes(data, str(tmp_path), "train", fmt="npy")
    seen = []
    real = TT.train
    monkeypatch.setattr(TT, "train",
                        lambda cfg, **kw: seen.append(cfg) or real(cfg, **kw))
    TT.main(["--config", "single_robot_depth", "--steps", "2",
             "--dataset_root", str(tmp_path), "--augment",
             "--device", "cpu"])
    assert seen[0].data.dataset_root == str(tmp_path)
    assert seen[0].data.augment
    assert "final loss" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "train"))[-1] == "scene_00007"
