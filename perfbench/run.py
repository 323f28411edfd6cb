"""Runs one cell of the benchmark and prints its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``mrp_gnn_tpu_torch``)
beside ``perfbench/``. The cell's files are found by name (``cells.py``);
its traffic's ``mode`` names the driver (``drivers/<mode>.py``). A run
needs as many CUDA cards as the cell asks for and fails without them.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` they are the per-layer metrics that ``metrics/*.py``
read from the traced window, and ``device`` carries ``busy_s`` and
``window_s``. Every run checks the window's outputs against the plain
reference (``compare.py``) and prints each number compared with its limit,
on standard error and under ``checks``, the line's last key. The last line
of standard output is the result.

The configuration's ``environment`` (``cells.environment``), such as the
size of the host's OpenMP pools, is set before the program loads.

Kernel and compiler caches go to directories inside the checkout; the
program's own builds already live there (``mrp_gnn_tpu_torch/ops/_build``,
``mrp_gnn_tpu_torch/data/_build``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".perfbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)

# whole top-level module names that no run may load
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "optax",
                               "mrp_gnn_tpu"})


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & FORBIDDEN_MODULES)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(chips: int):
    """The first CUDA card, or SystemExit when there are fewer than
    ``chips``: a run never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA card; this run measures the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} CUDA cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def execute(args: argparse.Namespace, root: Path, device) -> dict:
    """Runs the cell on ``device`` (the card, or what a test passes) and
    returns the result line's object."""
    from perfbench import cells
    cell = cells.cell(args.workload, root)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell['traffic_doc']['mode']}")
    readers = cells.metric_readers(root) if args.trace else {}
    seed = args.seed & 0xFFFFFFFFFFFF  # the data layer takes seeds >= 0
    return driver.run(cell, seed, args.seconds, bool(args.trace), device,
                      T_START, readers)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import cells
    cell = cells.cell(args.workload)
    # thread pools read their sizes when torch and the native helpers load
    os.environ.update(cells.environment(cell["config_doc"]))
    try:
        import mrp_gnn_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"perfbench: the program is not here ({e})")
    chips = cell["chips"]
    result = execute(args, cells.ROOT, require_cards(chips))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
