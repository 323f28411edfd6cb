"""The portable export (``serving.export_predictor`` / ``load_exported``)
on the CPU: a ``torch.export`` program whose kernel forwards are the custom
ops of ``ops/library.py``.

The reduced ``dynamic_swarm`` of tests/test_torch_serving.py (2 scenes x 8
robots, radius 2, 16x16 images, encoder channels (8, 16), the fused
attention path); its mean and max variants (the SpMM and the masked max);
and a fully connected team of 130 robots in 256 node slots (ELL width 136,
the row-expanded forward), the graph of tests/test_torch_hideg.py.

Tolerances: the loaded program against the port's Predictor bit for bit
(the same ops on the same inputs); against the JAX package's export of the
same flax weights, depth 1e-4 m and seg argmax equal on at least 99.9% of
pixels, the tolerance of tests/test_torch_serving.py.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mrp_gnn_tpu.config import get_config as jget_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jmake_dataset
from mrp_gnn_tpu.models import MultiRobotPerceptionNet as JNet
from mrp_gnn_tpu.serving import Predictor as JPredictor
from mrp_gnn_tpu.serving import export_predictor as jexport_predictor
from mrp_gnn_tpu.serving import load_exported as jload_exported
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch import serving as TS
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config as tget_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset as tmake_dataset
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.fusion import default_edge_fusion
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp, library

from torch_small import small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reduced(get_config, fusion="attention", impl="pallas"):
    cfg = get_config("dynamic_swarm")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(8, 16), fusion=fusion),
        data=dataclasses.replace(cfg.data, image_size=(16, 16), num_robots=8,
                                 scenes_per_batch=2, comm_radius=2,
                                 num_eval_scenes=4, renderer="numpy",
                                 graph_builder="numpy"),
        parallel=dataclasses.replace(cfg.parallel, ops_impl=impl))


def _predictor(fusion="attention", impl="pallas", graph=None, **kw):
    cfg = _reduced(tget_config, fusion, impl)
    batch = next(iter(tmake_dataset(cfg.data, "eval", shuffle=False)))
    model = MultiRobotPerceptionNet(
        cfg.model, generator=torch.Generator().manual_seed(0), **kw)
    graph = graph if graph is not None else batch["graph"]
    images = np.random.default_rng(1).uniform(
        size=(graph.max_nodes, 16, 16, 3)).astype(np.float32)
    return TS.Predictor(cfg, model, graph=graph, device="cpu"), images


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """The JAX Predictor and the port's on the same flax weights and graph,
    each exported to a directory of its own."""
    jcfg, tcfg = _reduced(jget_config), _reduced(tget_config)
    jbatch = next(iter(jmake_dataset(jcfg.data, "eval", shuffle=False)))
    tbatch = next(iter(tmake_dataset(tcfg.data, "eval", shuffle=False)))
    params = JNet(jcfg.model).init(jax.random.PRNGKey(0), jbatch["images"],
                                   jbatch["graph"])
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                             jax.tree.map(np.asarray, params))
    jpred = JPredictor(jcfg, params, graph=jbatch["graph"])
    tpred = TS.Predictor(tcfg, model, graph=tbatch["graph"], device="cpu")
    d = tmp_path_factory.mktemp("export")
    meta = TS.export_predictor(tpred, str(d / "port.pt2"))
    jexport_predictor(jpred, str(d / "jax.hlo"), platforms=("cpu",))
    return jpred, tpred, tbatch["images"], d, meta


@pytest.mark.parametrize("impl,ops", [
    ("pallas", ["mrp_gnn_torch::fused_attention"]), ("xla", [])])
def test_exported_graph_holds_the_kernel_ops(impl, ops):
    pred, _ = _predictor(impl=impl)
    program = pred.export_program()
    assert library.op_names(program.graph_module) == ops
    assert set(library.OPS) == {"fused_attention", "expanded_forward",
                                "spmm", "masked_max"}


def test_loaded_artifact_is_the_predictor(jax_pair):
    _, tpred, images, d, _ = jax_pair
    infer = TS.load_exported(str(d / "port.pt2"), device="cpu")
    got, want = infer(images), tpred(images)
    assert sorted(got) == sorted(want) == ["depth", "seg"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert infer.input_shape == tpred.input_shape


def test_loaded_artifact_matches_the_jax_export(jax_pair):
    _, _, images, d, _ = jax_pair
    want = jload_exported(str(d / "jax.hlo"))(images)
    got = TS.load_exported(str(d / "port.pt2"), device="cpu")(images)
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)
    assert float((got["seg"] == np.asarray(want["seg"])).mean()) >= 0.999


def test_sidecar_has_the_jax_keys_and_the_route(jax_pair):
    _, _, _, d, meta = jax_pair
    with open(d / "port.pt2.json") as f:
        port = json.load(f)
    with open(d / "jax.hlo.json") as f:
        jax_meta = json.load(f)
    assert port == meta
    assert set(jax_meta) <= set(port)
    assert port["route"] == "kernels"
    assert port["ops"] == ["mrp_gnn_torch::fused_attention"]
    assert port["platforms"] == ["cpu", "cuda"]
    for k in ("config", "input_shape", "outputs"):
        assert port[k] == jax_meta[k], k


def test_fresh_process_serves_without_the_model_code(jax_pair, tmp_path):
    _, tpred, images, d, _ = jax_pair
    np.save(tmp_path / "images.npy", images)
    code = (
        "import sys, numpy as np\n"
        "from mrp_gnn_tpu_torch.serving import load_exported\n"
        f"infer = load_exported({str(d / 'port.pt2')!r}, device='cpu')\n"
        f"out = infer(np.load({str(tmp_path / 'images.npy')!r}))\n"
        f"np.save({str(tmp_path / 'depth.npy')!r}, out['depth'])\n"
        "assert 'mrp_gnn_tpu_torch.ops.library' in sys.modules\n"
        "assert not any(m.startswith('mrp_gnn_tpu_torch.models')\n"
        "               for m in sys.modules), sorted(sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert np.array_equal(np.load(tmp_path / "depth.npy"),
                          tpred(images)["depth"])


def test_load_refuses_wrong_inputs(jax_pair, tmp_path):
    _, tpred, images, d, _ = jax_pair
    infer = TS.load_exported(str(d / "port.pt2"), device="cpu")
    with pytest.raises(ValueError, match="expected images"):
        infer(images[:3])
    path = str(tmp_path / "cuda_only.pt2")
    TS.export_predictor(tpred, path, platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        TS.load_exported(path, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        tpred.export_bytes(platforms=("tpu",))


def test_load_runs_on_the_card_unless_asked(jax_pair, monkeypatch):
    _, _, _, d, _ = jax_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.load_exported(str(d / "port.pt2"))


def test_a_swapped_model_refuses_to_export():
    def swap(ops, aggregation, q, k, values, graph):
        return default_edge_fusion(ops, aggregation, q, k, values, graph)

    pred, _ = _predictor(edge_fusion_fn=swap)
    with pytest.raises(ValueError, match="edge_fusion_fn"):
        pred.export_bytes()


def _hideg_graph():
    n = 130
    edges = np.stack(np.nonzero(~np.eye(n, dtype=bool))[::-1]).astype(np.int32)
    graph = tg.batch_homogeneous(1, n, edges, max_nodes=256)
    assert bsp.supports_expanded(graph) and graph.ell_src.shape[1] > 128
    return graph


@pytest.mark.parametrize("fusion,op", [
    ("mean", "spmm"), ("max", "masked_max"), ("hideg", "expanded_forward")])
def test_each_forward_op_round_trips(fusion, op, tmp_path):
    """Rows 3, 10 and 8: the exported program calls the path's op and gives
    the Predictor's outputs bit for bit."""
    graph = _hideg_graph() if fusion == "hideg" else None
    pred, images = _predictor("attention" if fusion == "hideg" else fusion,
                              graph=graph)
    meta = TS.export_predictor(pred, str(tmp_path / "m.pt2"))
    assert meta["ops"] == [f"mrp_gnn_torch::{op}"]
    got = TS.load_exported(str(tmp_path / "m.pt2"), device="cpu")(images)
    want = pred(images)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_serving_cli_exports_a_checkpoint(tmp_path, monkeypatch, capsys):
    cfg = small(tget_config("dynamic_swarm"), impl="pallas",
                checkpoint_dir=str(tmp_path / "ck"))
    TT.train(cfg, num_steps=1, device="cpu")
    monkeypatch.setattr(TS, "get_config", lambda name: cfg)
    out = str(tmp_path / "model.pt2")
    TS.main(["--config", "dynamic_swarm", "--checkpoint_dir",
             str(tmp_path / "ck"), "--export", out, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serving] config=dynamic_swarm input=(16, "
                               "16, 16, 3) device=cpu")
    # The CLI serves the preset's static graph, a block-diagonal batch of
    # identical teams, which dispatch routes to the dense plain ops, as the
    # JAX package does.
    assert "route plain" in lines[1]
    with open(out + ".json") as f:
        assert json.load(f)["route"] == "plain"
    pred = TS.Predictor.from_checkpoint(cfg, str(tmp_path / "ck"),
                                        device="cpu")
    images = np.zeros(pred.input_shape, np.float32)
    got = TS.load_exported(out, device="cpu")(images)
    assert np.array_equal(got["depth"], pred(images)["depth"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        TS.main(["--config", "dynamic_swarm", "--checkpoint_dir",
                 str(tmp_path / "ck"), "--bench", "--device", "cpu"])


def _op_inputs(op):
    rng = np.random.default_rng(0)
    graph = _hideg_graph() if op == "expanded_forward" else \
        tg.batch_homogeneous(2, 8, np.stack(np.nonzero(
            ~np.eye(8, dtype=bool))[::-1]).astype(np.int32))
    V, dk, D = graph.max_nodes, 8, 24
    q, k = (torch.from_numpy(rng.normal(size=(V, dk)).astype(np.float32))
            for _ in range(2))
    values = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    src, mask = graph.ell_src, graph.ell_mask
    if op == "fused_attention":
        return (q, k, values, src, mask)
    if op == "expanded_forward":
        xp = graph.bsp_expanded
        src_x, mask_x = bsp.expand_ell_view(src, mask, xp.rows, xp.width)
        return (q, k, values, src_x, mask_x, xp.rows)
    if op == "spmm":
        return (mask.float() / 7, values, src, mask)
    return (values, src, mask)


@pytest.mark.parametrize("op", sorted(library.OPS))
def test_fake_impl_gives_the_real_shape(op):
    """Each registered op: its fake implementation's shape and dtype are
    the real one's (FakeTensorMode), for f32 and bf16 values, and
    torch.library.opcheck passes."""
    args = _op_inputs(op)
    for dtype in (torch.float32, torch.bfloat16):
        if op == "spmm":
            a = (args[0], args[1].to(dtype), *args[2:])
        else:
            i = 0 if op == "masked_max" else 2
            a = args[:i] + (args[i].to(dtype),) + args[i + 1:]
        real = library.OPS[op](*a)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode() as mode:
            fake = library.OPS[op](*[mode.from_tensor(x) if torch.is_tensor(x)
                                    else x for x in a])
        assert fake.shape == real.shape and fake.dtype == real.dtype == dtype
    torch.library.opcheck(library.OPS[op], args)
