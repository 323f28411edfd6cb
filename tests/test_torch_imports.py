"""The port imports nothing of JAX, of the JAX package or of grain, and
nothing at module level that the card's machine lacks (PIL).

Static on purpose (an AST scan of every import statement): the test
process has jax loaded already, so checking sys.modules would prove
nothing.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "grain",
             "mrp_gnn_tpu"}
# Imported only inside the functions that need them (the .png branches of
# data/disk.py, utils/viz.py's panels): never at module level.
NOT_AT_MODULE_LEVEL = {"PIL"}
FILES = sorted((ROOT / "mrp_gnn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _run_at_import(tree):
    """Every node outside a function body: what importing the module runs."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            yield node
            stack.extend(ast.iter_child_nodes(node))


def _imported_roots(path: Path, module_level: bool = False):
    tree = ast.parse(path.read_text(), str(path))
    for node in _run_at_import(tree) if module_level else ast.walk(tree):
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
    for mod in ("native", "graph_native", "_native_loader", "disk",
                "grain_pipeline"):
        assert f"mrp_gnn_tpu_torch/data/{mod}.py" in names
    assert "mrp_gnn_tpu_torch/ops/library.py" in names
    for mod in ("__init__", "partition", "launch", "mesh", "fused", "context"):
        assert f"mrp_gnn_tpu_torch/parallel/{mod}.py" in names
    assert len(names) >= 30


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_level_imports_the_card_lacks(path):
    bad = [(line, mod) for line, mod in _imported_roots(path, True)
           if mod in NOT_AT_MODULE_LEVEL]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"
