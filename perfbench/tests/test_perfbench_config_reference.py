"""A configuration is judged against the plain reference that its file
names, and its work counts follow that reference's shapes.

The stand-in reference is a copy of ``reference/model.py`` with the fused
message doubled and the fusion layer's value map widened to a 3 x 3
convolution in its ``param_shapes``, registered as a module of
``perfbench.reference`` for one test at a time. A tiny ``swarm_train``
run on the CPU that names it comes out not ``correct``; one that names
"model" comes out ``correct``.
"""

import importlib.util
import json
import sys

import pytest
import torch

from perfbench import cells, run, work
from perfbench.reference import model as M
from perfbench.tests.tiny import tiny_root

STAND_IN = "doubled_message"


@pytest.fixture
def stand_in(monkeypatch):
    name = f"perfbench.reference.{STAND_IN}"
    spec = importlib.util.spec_from_file_location(name, M.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.edge_attention = lambda *a: 2.0 * M.edge_attention(*a)

    def param_shapes(model):
        shapes = M.param_shapes(model)
        for k, s in shapes.items():
            if k.endswith(".value.weight"):
                shapes[k] = s[:2] + (3, 3)
        return shapes

    mod.param_shapes = param_shapes
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


@pytest.mark.parametrize("reference,correct", [("model", True),
                                               (STAND_IN, False)])
def test_the_named_reference_decides_correct(tmp_path, stand_in, reference,
                                             correct):
    root = tiny_root(tmp_path)
    path = root / "configs" / "dynamic_swarm.json"
    doc = json.loads(path.read_text())
    doc["reference"] = reference
    path.write_text(json.dumps(doc))
    args = run.parse(["--workload", "swarm_train", "--seed", str(2**31 + 9),
                      "--seconds", "0.5", "--trace", "0"])
    res = run.execute(args, root, torch.device("cpu"))
    assert res["correct"] is correct, res["checks"]


def test_the_work_counts_follow_the_named_references_shapes(stand_in):
    model = cells.load("configs", "dynamic_swarm")["model"]
    V, E = 256, 1888
    _, C, h, w = M.fusion_input_shape(model, V)
    taps = 2 * V * h * w * C * C * (9 - 1) * model["num_fusion_layers"]
    assert work.forward_flops(stand_in, model, V, E) == (
        work.forward_flops(M, model, V, E) + taps)
    rec = {"mode": "train", "model": model, "num_nodes": V, "edges": [E],
           "window_s": 1.0}
    mfu = cells.metric_readers()["train_mfu"]
    for ref, name in ((M, "model"), (stand_in, STAND_IN)):
        assert mfu.read({**rec, "reference": name}) == (
            100.0 * work.step_flops(ref, model, V, E) / work.F32_PEAK_FLOPS)
