"""What a run loads: no JAX, no JAX package; the reference none of the
program. Each check runs in a fresh interpreter and compares whole
top-level module names (``mrp_gnn_tpu_torch`` begins with
``mrp_gnn_tpu``, so a prefix test would be wrong)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

_RUN_TINY = """
import json, sys, torch
from pathlib import Path
from perfbench import calibrate, cells, knee, run
from perfbench.tests.tiny import tiny_root
root = tiny_root(Path(sys.argv[1]))
cells.metric_readers(root)
for cell in ("swarm_train", "dense_serve"):
    for t in ("0", "1"):
        args = run.parse(["--workload", cell, "--seed", "11", "--seconds",
                          "0.5", "--trace", t])
        run.execute(args, root, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE_ONLY = """
import json, sys
import perfbench.compare, perfbench.reference.graph
import perfbench.reference.model, perfbench.reference.render
import perfbench.reference.train, perfbench.work
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str, *args) -> set:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax(tmp_path):
    from perfbench.run import FORBIDDEN_MODULES
    loaded = _top_level(_RUN_TINY, str(tmp_path))
    assert "mrp_gnn_tpu_torch" in loaded  # the run drove the program
    assert not loaded & FORBIDDEN_MODULES, loaded & FORBIDDEN_MODULES


def test_reference_imports_nothing_of_the_program():
    loaded = _top_level(_REFERENCE_ONLY)
    assert "torch" in loaded
    assert not loaded & {"mrp_gnn_tpu_torch", "mrp_gnn_tpu", "jax",
                         "jaxlib", "flax", "optax"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "mrp_gnn_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "mrp_gnn_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.loaded_forbidden()
