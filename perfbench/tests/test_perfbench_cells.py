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


@pytest.mark.parametrize("name", ["dynamic_swarm", "dense_swarm"])
def test_configuration_files_are_the_preset_and_their_overrides(name):
    doc = cells.load("configs", name)
    cfg = cells.port_config(doc, seed=3)
    assert cfg.data.seed == 3 and cfg.name == name
    assert cfg.data.renderer == "native" and cfg.parallel.ops_impl == "auto"
    bad = json.loads(json.dumps(doc))
    bad["model"]["attention_dim"] = 32  # a change the file does not declare
    with pytest.raises(ValueError, match="attention_dim"):
        cells.port_config(bad, seed=3)


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        cells.cell("no_such_cell")
    assert cells.names("metrics", tmp_path) == []
