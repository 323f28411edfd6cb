"""The port's Predictor (on the CPU) against the JAX Predictor with the
Pallas backend in interpret mode, on a reduced dynamic_swarm: 2 scenes x 8
robots (V 16, plan tile 16), radius 2, mobility 1.5, 16x16 images, encoder
channels (8, 16). The graph comes from the dynamic builder, so the fusion
layer takes the fused attention path on both sides.

Tolerance: depth 1e-4 m (f32; convolutions sum in another order), seg
argmax equal on at least 99.9% of pixels (a near-tie may flip).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jmake_dataset
from mrp_gnn_tpu.models import MultiRobotPerceptionNet as JNet
from mrp_gnn_tpu.serving import Predictor as JPredictor
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset as tmake_dataset
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp
from mrp_gnn_tpu_torch.serving import Predictor


def _reduced(get_config):
    cfg = get_config("dynamic_swarm")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(8, 16)),
        data=dataclasses.replace(cfg.data, image_size=(16, 16), num_robots=8,
                                 scenes_per_batch=2, comm_radius=2,
                                 num_eval_scenes=4, renderer="numpy",
                                 graph_builder="numpy"),
        parallel=dataclasses.replace(cfg.parallel, ops_impl="pallas"))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _reduced(jget_config), _reduced(tget_config)
    jbatch = next(iter(jmake_dataset(jcfg.data, "eval", shuffle=False)))
    tbatch = next(iter(tmake_dataset(tcfg.data, "eval", shuffle=False)))
    assert tbatch["graph"].scene_stride == 0 and bsp.supports(tbatch["graph"])
    params = JNet(jcfg.model).init(jax.random.PRNGKey(0), jbatch["images"],
                                   jbatch["graph"])
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                             jax.tree.map(np.asarray, params))
    jpred = JPredictor(jcfg, params, graph=jbatch["graph"])
    tpred = Predictor(tcfg, model, graph=tbatch["graph"], device="cpu")
    return jpred, tpred, tbatch["images"]


def test_predictor_matches_jax(pair):
    jpred, tpred, images = pair
    want, got = jpred(images), tpred(images)
    assert sorted(got) == sorted(want) == ["depth", "seg"]
    assert got["seg"].dtype == np.asarray(want["seg"]).dtype == np.int32
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)
    assert float((got["seg"] == np.asarray(want["seg"])).mean()) >= 0.999


def test_predict_scenes_strips_padding(pair):
    _, tpred, images = pair
    n = tpred.cfg.data.num_robots
    scenes = [images[:n], images[n:], images[:n]]  # 2 batches, one padded
    out = tpred.predict_scenes(scenes)
    assert len(out) == 3
    full = tpred(images)
    for i, s in enumerate((0, 1, 0)):
        assert out[i]["depth"].shape == (n, 16, 16)
        np.testing.assert_allclose(out[i]["depth"],
                                   full["depth"][s * n:(s + 1) * n],
                                   rtol=0, atol=1e-5)


def test_predictor_rejects_wrong_shape(pair):
    _, tpred, _ = pair
    with pytest.raises(ValueError, match="expected images"):
        tpred(np.zeros((1, 16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="each scene"):
        tpred.predict_scenes([np.zeros((3, 16, 16, 3), np.float32)])


def test_predictor_needs_cuda_unless_cpu_is_asked(pair, monkeypatch):
    _, tpred, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(tpred.cfg, tpred.model, graph=tpred.graph)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tpred.throughput(iters=1)
