"""Discovery of configurations, cells, traffic and metric readers by file
name, against ``BENCHMARK.json``."""

import json
from pathlib import Path

import pytest

from perfbench import cells

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_configuration_and_cell_has_its_file(bench):
    assert sorted(c["name"] for c in bench["configs"]) == cells.names("configs")
    assert {w["name"] for w in bench["workloads"]} <= set(cells.names("workloads"))
    for w in bench["workloads"]:
        cell = cells.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert cell["traffic_doc"]["mode"] in ("train", "serve")
    for c in bench["configs"]:
        doc = cells.load("configs", c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]


def test_every_per_layer_metric_has_its_reader(bench):
    readers = cells.metric_readers()
    assert {m["name"] for m in bench["per_layer"]} <= set(readers)
    for m in bench["per_layer"]:
        mod = readers[m["name"]]
        assert mod.UNIT == m["unit"] and callable(mod.read)


@pytest.mark.parametrize("name", cells.names("configs"))
def test_configuration_files_are_the_preset_and_their_overrides(name):
    doc = cells.load("configs", name)
    cfg = cells.port_config(doc, seed=3)
    assert cfg.data.seed == 3 and cfg.name == name
    assert cfg.data.renderer == "native" and cfg.parallel.ops_impl == "auto"
    bad = json.loads(json.dumps(doc))
    bad["model"]["attention_dim"] += 1  # a change the file does not declare
    with pytest.raises(ValueError, match="attention_dim"):
        cells.port_config(bad, seed=3)


@pytest.mark.parametrize("name", cells.names("configs"))
def test_every_configuration_names_a_reference_with_the_programs_parameters(
        tmp_path, name):
    """The module that the file names has the whole interface, and its
    parameters are the program's, name for name and shape for shape, at
    the file's tiny size."""
    from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
    from perfbench.tests.tiny import tiny_root
    ref = cells.reference(cells.load("configs", name))
    assert all(callable(getattr(ref, f)) for f in cells.REFERENCE_INTERFACE)
    doc = cells.load("configs", name, tiny_root(tmp_path))
    cfg = cells.port_config(doc, seed=1)
    net = MultiRobotPerceptionNet(cfg.model, ops_impl=cfg.parallel.ops_impl)
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    have = {k: tuple(s) for k, s in ref.param_shapes(doc["model"]).items()}
    assert have == want


@pytest.mark.parametrize("reference,error", [
    (None, "must name a module"), ("model.x", "must name a module"),
    ("no_such_reference", "no reference module"),
    ("graph", "lacks")])  # a helper module, not a network
def test_a_file_without_a_sound_reference_is_refused(reference, error):
    doc = cells.load("configs", "dense_swarm")
    if reference is None:
        del doc["reference"]
    else:
        doc["reference"] = reference
    with pytest.raises(ValueError, match=error):
        cells.reference(doc)


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        cells.cell("no_such_cell")
    assert cells.names("metrics", tmp_path) == []


@pytest.mark.parametrize("name", cells.names("configs"))
def test_a_configurations_environment_is_names_and_strings(name):
    env = cells.environment(cells.load("configs", name))
    assert all(isinstance(v, str) for v in env.values())
    with pytest.raises(ValueError, match="environment"):
        cells.environment({"environment": {"OMP_NUM_THREADS": 6}})


def test_a_run_sets_the_environment_before_the_program_loads(monkeypatch):
    """The environment is in place when the program is imported: here the
    import fails, and the variable is already set."""
    import sys
    from perfbench import run
    doc = {**cells.load("configs", "dynamic_swarm"),
           "environment": {"PERFBENCH_ENV_PROBE": "set"}}
    monkeypatch.setenv("PERFBENCH_ENV_PROBE", "unset")  # undone afterwards
    monkeypatch.setattr(cells, "cell", lambda name: {"chips": 1,
                                                     "config_doc": doc})
    monkeypatch.setitem(sys.modules, "mrp_gnn_tpu_torch", None)
    with pytest.raises(SystemExit, match="not here"):
        run.main(["--workload", "swarm_train", "--seed", "1",
                  "--seconds", "1"])
    assert run.os.environ["PERFBENCH_ENV_PROBE"] == "set"
