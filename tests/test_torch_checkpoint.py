"""The port's checkpoints and resume, on CPU.

- ``CheckpointManager``: a round trip of the model, ``AdamW`` (moments and
  count), step and best tracking, bit for bit; the newest 3 kept; no
  partial file ever visible under a checkpoint's name; the data-state
  sidecar under the JAX package's name; an empty directory gives None.
- ``train()``: ``config.json`` is ``dataclasses.asdict(cfg)``; 4 straight
  steps against 2 steps, a checkpoint, a new ``train()`` call and 2 more,
  on the port's own stream with the prefetch thread on: the records and
  the parameters bit for bit equal. Both runs use one intra-op thread:
  with 8, torch's CPU kernels gave one straight 4-step run in four a
  depth loss a few ulps off the others (the same with oneDNN off), so
  bit-equality across runs needs the single thread on the CPU, as it
  needs deterministic cuDNN on the card.
- The stream's resume: ``BatchIterator.fast_forward`` and
  ``make_train_iterator(start_batch=)`` give the JAX package's batches
  bit for bit for the same seed and offset.
- ``Predictor.from_checkpoint``: the outputs of a Predictor on the saved
  model, bit for bit; an empty directory raises.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from mrp_gnn_tpu.config import get_config as jax_config
from mrp_gnn_tpu.data import pipeline as jp
from mrp_gnn_tpu_torch import checkpoint as TC
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data import pipeline as tp
from mrp_gnn_tpu_torch.serving import Predictor
from torch_small import small


def _cfg(**train):
    return small(get_config("dynamic_swarm"), **train)


def _stepped_state(cfg, steps=2):
    """A state after ``steps`` real updates, so the moments are not 0."""
    state = TT.create_train_state(cfg, "cpu")
    step = TT.make_train_step(cfg, state.model, state.optimizer)
    it = iter(tp.make_dataset(cfg.data, "train"))
    for _ in range(steps):
        state, _ = step(state, *TT.batch_to_device(next(it), "cpu"))
    return state


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count
    assert (a.step, a.best_rmse, a.best_step) == (b.step, b.best_rmse,
                                                  b.best_step)


def test_save_restore_round_trip(tmp_path):
    cfg = _cfg()
    state = _stepped_state(cfg)
    state.best_rmse, state.best_step = 1.25, 2
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    other_cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=5))
    fresh = TT.create_train_state(other_cfg, "cpu")
    assert not torch.equal(fresh.model.encoder.stem.Conv_0.weight,
                           state.model.encoder.stem.Conv_0.weight)
    assert mgr.restore_latest(fresh) is fresh
    _assert_same_state(fresh, state)
    assert fresh.optimizer.count == 2 and fresh.step == 2
    assert all(m.abs().sum() > 0 for m in fresh.optimizer.mu)
    # the restored moments are the optimizer's own tensors, updated in place
    assert fresh.optimizer.mu[0] is not state.optimizer.mu[0]
    assert mgr.latest_step == 2


def test_keeps_the_newest_three(tmp_path):
    state = TT.create_train_state(_cfg(), "cpu")
    mgr = TC.CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        state.step = step
        mgr.save(step, state, data_state=f'{{"step": {step}}}')
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"ckpt_{s}.pt" for s in (3, 4, 5)]
        + [f"data_state_{s}.json" for s in (3, 4, 5)])
    assert mgr.latest_step == 5
    assert TC.CheckpointManager(str(tmp_path), max_to_keep=3).latest_step == 5


def test_no_partial_file_is_visible(tmp_path, monkeypatch):
    state = TT.create_train_state(_cfg(), "cpu")
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    real_save = torch.save
    seen = []

    def checking_save(obj, f):
        # while the bytes are written, the checkpoint's own name is absent
        seen.append(sorted(os.listdir(tmp_path)))
        real_save(obj, f)

    monkeypatch.setattr(TC.torch, "save", checking_save)
    mgr.save(2, state)
    assert seen == [["ckpt_1.pt", f"ckpt_2.pt.tmp-{os.getpid()}"]]

    def failing_save(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(TC.torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, state)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.pt", "ckpt_2.pt"]
    assert mgr.latest_step == 2
    monkeypatch.setattr(TC.torch, "save", real_save)
    assert mgr.restore_latest(TT.create_train_state(_cfg(), "cpu")) is not None


def test_data_state_sidecar(tmp_path):
    state = TT.create_train_state(_cfg(), "cpu")
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(3, state, data_state='{"epoch": 1, "index": 7}')
    with open(tmp_path / "data_state_3.json") as f:
        assert f.read() == '{"epoch": 1, "index": 7}'
    assert mgr.latest_data_state() == '{"epoch": 1, "index": 7}'
    mgr.save(4, state)
    assert mgr.latest_data_state() is None


def test_an_empty_directory_gives_none(tmp_path):
    state = TT.create_train_state(_cfg(), "cpu")
    for d in (tmp_path, tmp_path / "missing"):
        mgr = TC.CheckpointManager(str(d))
        assert mgr.restore_latest(state) is None
        assert mgr.latest_step is None and mgr.latest_data_state() is None
        mgr.close()
    assert not (tmp_path / "missing").exists()
    assert state.step == 0 and math.isinf(state.best_rmse)


def test_config_json_beside_the_checkpoints(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path / "ck"))
    TT.train(cfg, num_steps=1, device="cpu")
    with open(tmp_path / "ck" / "config.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_1.pt", "config.json"]


def _terms(records):
    timing = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")
    return [{k: v for k, v in r.items() if k not in timing} for r in records]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
def test_resumed_run_is_bit_equal_to_a_straight_run(tmp_path):
    kw = dict(log_every=1, eval_every=2, checkpoint_every=2)
    straight_cfg = _cfg(checkpoint_dir=str(tmp_path / "a"), **kw)
    assert straight_cfg.data.prefetch > 0  # the prefetch thread is on
    straight, recs = TT.train(straight_cfg, num_steps=4, device="cpu")
    cfg = _cfg(checkpoint_dir=str(tmp_path / "b"), **kw)
    _, first = TT.train(cfg, num_steps=2, device="cpu")
    resumed, rest = TT.train(cfg, num_steps=4, device="cpu")
    assert rest[0]["step"] == 3  # started after the step-2 checkpoint
    assert first[-1] == {"step": 2, "best_eval_rmse": first[-2]["eval_rmse"],
                         "best_eval_step": 2}
    assert _terms(first[:-1] + rest) == _terms(recs)
    assert recs[-1]["best_eval_step"] in (2, 4)
    assert resumed.step == straight.step == 4
    _assert_same_state(resumed, straight)


@pytest.mark.parametrize("offset", [4, 7])
def test_fast_forward_matches_jax(offset):
    """6 train scenes in batches of 2: 3 batches an epoch, so offset 4 is
    epoch 1 after one batch and 7 is epoch 2 after one."""
    kw = dict(num_train_scenes=6, scenes_per_batch=2, num_robots=4,
              image_size=(16, 16), renderer="numpy", graph_builder="numpy")
    jd = dataclasses.replace(jax_config("dynamic_swarm").data, **kw)
    td = dataclasses.replace(get_config("dynamic_swarm").data, **kw)
    jit, tit = jp.make_dataset(jd, "train"), tp.make_dataset(td, "train")
    jit.fast_forward(offset)
    tit.fast_forward(offset)
    assert (tit._epoch, tit._skip_batches) == (jit._epoch, jit._skip_batches)
    streams = [(tit.repeat(), jit.repeat()),
               (tp.make_train_iterator(td, start_batch=offset),
                jp.make_train_iterator(jd, start_batch=offset))]
    try:
        for t_stream, j_stream in streams:
            for _ in range(4):  # across the next epoch boundary
                a, b = next(t_stream), next(j_stream)
                for key in ("images", "depth", "seg"):
                    assert np.array_equal(a[key], np.asarray(b[key])), key
                assert np.array_equal(a["graph"].ell_src.numpy(),
                                      np.asarray(b["graph"].ell_src))
    finally:
        for it in streams[1]:
            it.close()


def test_predictor_from_checkpoint(tmp_path):
    cfg = _cfg()
    state = _stepped_state(cfg, steps=1)
    TC.CheckpointManager(str(tmp_path)).save(1, state)
    batch = next(iter(tp.make_dataset(cfg.data, "eval", shuffle=False)))
    got = Predictor.from_checkpoint(cfg, str(tmp_path), device="cpu",
                                    graph=batch["graph"])(batch["images"])
    want = Predictor(cfg, state.model, graph=batch["graph"],
                     device="cpu")(batch["images"])
    assert sorted(got) == sorted(want) == ["depth", "seg"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "empty"), device="cpu")
