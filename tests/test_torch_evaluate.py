"""The port's evaluation against the JAX package's, on CPU.

- ``evaluate()`` on the same flax weights moved into torch, on a small
  ``dynamic_swarm`` (``tests/torch_small.py``) whose eval split of 6
  scenes in batches of 4 ends with a partial batch. JAX runs its default
  CPU route (XLA); the port runs its plain ops ("xla") and the kernels'
  plain versions ("pallas"). Tolerances: ``eval_batches`` equal; rmse and
  abs_rel within 1e-5 relative; delta1-3, mIoU and the per-class IoU
  within 1e-4 absolute (a few flipped pixels of the 6,144: f32 sums of the
  fusion in another order move a prediction across a class or a delta
  boundary).
- The partial final batch changes no metric (1e-5 relative), as
  ``tests/test_train_features.py::test_eval_partial_batch_invariance``
  checks JAX's.
- ``save_panels``: the same files and bit-equal pixels as JAX's.
- The CLI: restores a checkpoint, refuses an empty directory and the
  on-disk dataset.
"""

import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from mrp_gnn_tpu import train as JT
from mrp_gnn_tpu.config import get_config as jax_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jax_dataset
from mrp_gnn_tpu.evaluate import evaluate as jax_evaluate
from mrp_gnn_tpu.utils.viz import save_panels as jax_save_panels
from mrp_gnn_tpu_torch import evaluate as TE
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.utils.viz import save_panels
from torch_small import small

REL = 1e-5
ABS = 1e-4
EVAL6 = dict(num_eval_scenes=6, scenes_per_batch=4)


def _pair(impl):
    jcfg = small(jax_config("dynamic_swarm"), impl="xla", data=EVAL6)
    tcfg = small(get_config("dynamic_swarm"), impl=impl, data=EVAL6)
    sample = next(iter(jax_dataset(jcfg.data, "eval", shuffle=False)))
    state, _ = JT.create_train_state(jcfg, jax.random.PRNGKey(0), sample)
    params = jax.tree.map(np.asarray, state.params)
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model,
                                                     ops_impl=impl), params)
    return jcfg, tcfg, state.params, model


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_evaluate_matches_jax(impl):
    jcfg, tcfg, params, model = _pair(impl)
    want = jax_evaluate(jcfg, params)
    got = TE.evaluate(tcfg, model)
    assert sorted(got) == sorted(want)
    assert got["eval_batches"] == want["eval_batches"] == 2
    for k in ("rmse", "abs_rel"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    for k in ("delta1", "delta2", "delta3", "miou"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ABS,
                                   err_msg=k)
    np.testing.assert_allclose(got["iou_per_class"], want["iou_per_class"],
                               rtol=0, atol=ABS)
    assert model.training  # evaluate restores the model's mode


def test_eval_partial_batch_invariance():
    cfg = small(get_config("dynamic_swarm"), data=EVAL6)
    cfg_b = small(get_config("dynamic_swarm"),
                  data=dict(num_eval_scenes=6, scenes_per_batch=2))
    model = TT.create_train_state(cfg, "cpu").model
    ra, rb = TE.evaluate(cfg, model), TE.evaluate(cfg_b, model)
    assert (ra["eval_batches"], rb["eval_batches"]) == (2, 3)
    for k in ("rmse", "abs_rel", "delta1"):
        np.testing.assert_allclose(ra[k], rb[k], rtol=REL, err_msg=k)


def test_evaluate_refuses_a_parallel_context():
    cfg = small(get_config("dynamic_swarm"))
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        TE.evaluate(cfg, TT.create_train_state(cfg, "cpu").model,
                    pctx=object())


def _panel_inputs():
    rng = np.random.default_rng(0)
    V, H, W, K = 5, 12, 10, 6
    images = rng.uniform(-0.1, 1.1, size=(V, H, W, 3)).astype(np.float32)
    outputs = {"depth": rng.uniform(0.1, 12.0, size=(V, H, W)).astype(np.float32),
               "seg_logits": rng.normal(size=(V, H, W, K)).astype(np.float32)}
    targets = {"depth": rng.uniform(0.0, 10.0, size=(V, H, W)).astype(np.float32),
               "seg": rng.integers(0, K, size=(V, H, W)).astype(np.int32)}
    node_mask = np.array([True, False, True, True, False])
    return images, outputs, targets, node_mask


@pytest.mark.parametrize("heads", ["depth_and_seg", "depth"])
def test_save_panels_matches_jax(tmp_path, heads):
    images, outputs, targets, node_mask = _panel_inputs()
    if heads == "depth":
        outputs.pop("seg_logits")
    got = save_panels(str(tmp_path / "t"), images, outputs, targets,
                      node_mask, 0.1, 10.0, max_views=2)
    want = jax_save_panels(str(tmp_path / "j"), images, outputs, targets,
                           node_mask, 0.1, 10.0, max_views=2)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["view_000.png", "view_002.png"]
    for a, b in zip(got, want):
        pa, pb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert pa.shape == pb.shape and pa.dtype == np.uint8
        np.testing.assert_array_equal(pa, pb)


def test_evaluate_dumps_panels(tmp_path):
    cfg = small(get_config("dynamic_swarm"))
    TE.evaluate(cfg, TT.create_train_state(cfg, "cpu").model,
                dump_dir=str(tmp_path))
    assert len(os.listdir(tmp_path)) == 8  # max_views of the first batch


def test_cli_restores_and_refuses(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    TT.main(["--config", "single_robot_depth", "--steps", "2",
             "--train_scenes", "8", "--checkpoint_dir", ck,
             "--device", "cpu"])
    capsys.readouterr()
    TE.main(["--config", "single_robot_depth", "--checkpoint_dir", ck,
             "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[eval] restored step 2"
    res = json.loads(out[-1])
    assert res["eval_batches"] == 8 and np.isfinite(res["rmse"])
    assert "miou" not in res  # single_robot_depth has no seg head
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TE.main(["--config", "single_robot_depth", "--checkpoint_dir",
                 str(tmp_path / "empty"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="dataset split dir missing"):
        TE.main(["--config", "single_robot_depth", "--dataset_root",
                 str(tmp_path), "--device", "cpu"])
