"""The port's training loop features, on CPU, checked as
``tests/test_train_features.py`` checks the JAX package's: periodic eval
with best tracking, TensorBoard scalars (read back from the event file),
the restart-on-divergence and debug options of the CLI.
"""

import glob

import numpy as np
import pytest
import torch

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from torch_small import small

EVAL_KEYS = ("eval_eval_batches", "eval_rmse", "eval_abs_rel",
             "eval_delta1", "eval_delta2", "eval_delta3", "eval_miou")


def test_periodic_eval_and_best_tracking():
    cfg = small(get_config("dynamic_swarm"), log_every=1, eval_every=3)
    state, records = TT.train(cfg, num_steps=6, device="cpu")
    evals = [r for r in records if "eval_rmse" in r]
    assert [e["step"] for e in evals] == [3, 6]
    for e in evals:
        assert all(np.isfinite(e[k]) for k in EVAL_KEYS)
        assert len(e["eval_iou_per_class"]) == cfg.model.num_seg_classes
    best = [r for r in records if "best_eval_rmse" in r]
    assert len(best) == 1 and best[0] is records[-1]
    assert best[0]["best_eval_rmse"] == min(e["eval_rmse"] for e in evals)
    assert best[0]["best_eval_step"] in (3, 6)
    assert (state.best_rmse, state.best_step) == (
        best[0]["best_eval_rmse"], best[0]["best_eval_step"])


def test_tensorboard_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    cfg = small(get_config("dynamic_swarm"), log_every=1, eval_every=2,
                tensorboard_dir=str(tmp_path))
    _, records = TT.train(cfg, num_steps=2, device="cpu")
    files = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert len(files) == 1
    ea = EventAccumulator(files[0])
    ea.Reload()
    tags = set(ea.Tags()["scalars"])
    train_keys = {"depth_l1", "seg_ce", "total", "grad_norm", "wall_s",
                  "step_time_s", "views_per_s", "edges_per_s"}
    assert tags == train_keys | set(EVAL_KEYS)  # lists are not scalars
    total = [(e.step, e.value) for e in ea.Scalars("total")]
    want = [(r["step"], r["total"]) for r in records if "total" in r]
    assert [s for s, _ in total] == [s for s, _ in want] == [1, 2]
    # event files hold float32 scalars
    np.testing.assert_allclose([v for _, v in total], [v for _, v in want],
                               rtol=1e-7)
    assert [e.step for e in ea.Scalars("eval_rmse")] == [2]


def test_cli_auto_restart_on_divergence(tmp_path, capsys):
    args = ["--config", "single_robot_depth", "--steps", "8",
            "--lr", "1e18", "--log_every", "1", "--train_scenes", "8",
            "--device", "cpu"]
    with pytest.raises(FloatingPointError):
        TT.main(args + ["--checkpoint_dir", str(tmp_path / "ck"),
                        "--max_restarts", "1"])
    out = capsys.readouterr().out
    assert "restart 1/1 with lr=5e+17" in out
    with pytest.raises(FloatingPointError):  # no checkpoints: no restart
        TT.main(args + ["--max_restarts", "1"])
    assert "restart" not in capsys.readouterr().out


def test_cli_debug_mode(capsys):
    TT.main(["--config", "single_robot_depth", "--steps", "1",
             "--train_scenes", "8", "--debug", "--device", "cpu"])
    assert "debug mode: autograd anomaly detection on, graph validated" in \
        capsys.readouterr().out
    assert not torch.is_anomaly_enabled()  # switched off again at exit
