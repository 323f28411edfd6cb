"""The result line, and a run without a card. The runs here skip the look
for a card and drive the tiny cells on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny_root

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE = ["platform", "kind", "count", "memory_peak_bytes"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _execute(root, cell: str, trace: int, seed: int = 2**31 + 3) -> dict:
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.6", "--trace", str(trace)])
    return run.execute(args, root, torch.device("cpu"))


@pytest.mark.parametrize("cell,e2e", [
    ("swarm_train", {"train_views_per_s", "setup_s"}),
    ("dense_train", {"train_views_per_s", "setup_s"}),
    ("dense_serve", {"serve_p95_ms", "serve_p50_ms", "setup_s"})])
def test_untraced_line(root, cell, e2e):
    res = json.loads(json.dumps(_execute(root, cell, 0)))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res["device"]) == DEVICE
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


@pytest.mark.parametrize("cell,layer", [
    ("swarm_train", {"data_wait_ms.train", "train_mfu",
                     "fusion_roofline.train"}),
    ("dense_serve", {"predictor_host_ms.serve", "serve_forward_mfu",
                     "fusion_roofline.serve"})])
def test_traced_line_reads_the_cells_layers(root, cell, layer):
    """On the CPU there is no profile (no idle share, no busy_s); the
    readers of the spans and hook timings find what the cell has."""
    res = _execute(root, cell, 1)
    assert set(res["metrics"]) == layer
    assert res["correct"] is True
    assert list(res)[-1] == "checks"


def test_no_card_no_result():
    """Without a card the run fails and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "dense_serve", "--seed", "1", "--seconds", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of the benchmark alone fails before any run."""
    import shutil
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "dense_serve", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _profiled(mode: str) -> dict:
    return {"mode": mode, "profile": {"busy_s": 0.6, "window_s": 2.0,
                                      "calls": 60, "device_ops": [],
                                      "idle_gaps": []}}


def test_device_readers_read_the_profile():
    """The serving reader gives busy ms per request, the training one the
    idle share; each reads nothing of the other mode or without a
    profile."""
    from perfbench import cells
    readers = cells.metric_readers()
    busy, idle = readers["device_busy_ms.serve"], readers["device_idle_pct.train"]
    assert busy.read(_profiled("serve")) == pytest.approx(10.0)
    assert idle.read(_profiled("train")) == pytest.approx(70.0)
    assert busy.read(_profiled("train")) is None
    assert idle.read(_profiled("serve")) is None
    assert busy.read({"mode": "serve", "profile": None}) is None


def test_a_dynamic_topology_is_refused_for_serving(root):
    """Serving builds one Predictor on a static graph; a configuration
    whose graph changes per request is refused before any set-up."""
    from perfbench import cells
    from perfbench.drivers.serve import ServeCell
    cell = cells.cell("dense_serve", root)
    cell["config_doc"] = cells.load("configs", "dynamic_swarm", root)
    with pytest.raises(ValueError, match="dynamic topology"):
        ServeCell(cell, 1, torch.device("cpu"))
