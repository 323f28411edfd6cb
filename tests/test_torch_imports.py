"""The port imports nothing of JAX or of the JAX package.

Static on purpose (an AST scan of every import statement): the test
process has jax loaded already, so checking sys.modules would prove
nothing.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mrp_gnn_tpu"}
FILES = sorted((ROOT / "mrp_gnn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "mrp_gnn_tpu_torch/serving.py" in names
    assert "mrp_gnn_tpu_torch/ops/bsp.py" in names
    assert "mrp_gnn_tpu_torch/losses.py" in names
    assert "mrp_gnn_tpu_torch/train.py" in names
    assert "mrp_gnn_tpu_torch/data/pipeline.py" in names
    for mod in ("native", "graph_native", "_native_loader"):
        assert f"mrp_gnn_tpu_torch/data/{mod}.py" in names
    assert len(names) >= 21


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
