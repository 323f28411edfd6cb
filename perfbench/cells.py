"""Finds a cell's files by name, and turns a configuration file into the
program's configuration.

Layout (under ``perfbench/``, or another root that a test passes):

- ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``why`` and
  ``limits``, the limit of each number that decides ``correct``;
- ``configs/<config>.json``: the program's preset, the fields changed from
  it (``overrides``), every section of the configuration as it runs
  (``model``, ``data``, ``train``, ``parallel``), which the reference reads
  too, the plain reference's module (``reference``: the name of a module
  under ``perfbench/reference/`` with the interface of
  ``REFERENCE_INTERFACE``), and the tiny sizes that the CPU tests cut it
  to (``tiny``: ``model`` and ``data`` fields), and optionally the
  process environment of the host it runs on (``environment``: names and
  string values, put in place before the program loads);
- ``traffic/<traffic>.json``: the parameters that a driver reads, with
  ``mode`` naming the driver (``drivers/<mode>.py``);
- ``metrics/<metric>.py``: one reader a per-layer metric, with ``UNIT``
  and ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# what every reference module provides: the network (``forward(p, images,
# graph, model)``), its parameters (``param_shapes(model)``), the fusion
# layer's input (``fusion_input_shape(model, num_nodes)``) and the work
# that ``FlopCounterMode`` cannot see or that a roofline needs
# (``edge_flops(model, num_edges)``, ``fusion_work(model, num_nodes,
# num_edges, backward)``)
REFERENCE_INTERFACE = ("forward", "param_shapes", "fusion_input_shape",
                       "edge_flops", "fusion_work")


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's file, with its configuration and traffic files under
    ``config_doc`` and ``traffic_doc``."""
    doc = load("workloads", name, root)
    return {**doc, "name": name,
            "config_doc": load("configs", doc["config"], root),
            "traffic_doc": load("traffic", doc["traffic"], root)}


def names(kind: str, root: Path = ROOT) -> list:
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (Path(root) / kind).glob(
        "*" + suffix) if not p.name.startswith("_"))


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: module} for every ``metrics/<name>.py``."""
    out = {}
    for name in names("metrics", root):
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{len(out)}", Path(root) / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def environment(doc: dict) -> dict:
    """The process environment that a configuration file states for its
    host under ``environment`` (empty when it states none). Raises
    ValueError unless every name and value is a string."""
    env = doc.get("environment", {})
    if not isinstance(env, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env.items()):
        raise ValueError(f"{doc.get('name', '?')}: 'environment' must map "
                         f"names to string values, not {env!r}")
    return env


def reference(doc: dict):
    """The plain reference module that a configuration file (or a driver's
    record, which carries the name) names under ``reference``:
    ``perfbench.reference.<name>``. Raises ValueError when the key is
    missing or the module lacks a function of ``REFERENCE_INTERFACE``."""
    name = doc.get("reference")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_]\w*", name):
        raise ValueError(f"{doc.get('name', '?')}: 'reference' must name a "
                         f"module under perfbench/reference/, not {name!r}")
    try:
        mod = importlib.import_module(f"perfbench.reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"perfbench.reference.{name}":
            raise
        raise ValueError(f"{doc.get('name', '?')}: no reference module "
                         f"perfbench/reference/{name}.py") from None
    missing = [f for f in REFERENCE_INTERFACE
               if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"{doc.get('name', '?')}: reference module {name!r} "
                         f"lacks {missing}")
    return mod


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(doc: dict, seed: int):
    """The program's ``ExperimentConfig`` for a configuration file, with the
    data stream seeded by ``seed``. Raises ValueError when the file's
    sections differ from the preset by more than its ``overrides``. The
    file's other keys (``source``, ``reference``, ``tiny``,
    ``environment``...) are not the program's."""
    from mrp_gnn_tpu_torch import config as C
    preset = C.get_config(doc["preset"])
    kinds = {"model": C.ModelConfig, "data": C.DataConfig,
             "train": C.TrainConfig, "parallel": C.ParallelConfig}
    sections = {k: cls(**{f: _tuples(v) for f, v in doc[k].items()})
                for k, cls in kinds.items()}
    for k in kinds:
        want = dataclasses.asdict(getattr(preset, k))
        want.update(doc.get("overrides", {}).get(k, {}))
        have = dataclasses.asdict(sections[k])
        bad = sorted(f for f in want if _tuples(want[f]) != have[f])
        if bad:
            raise ValueError(f"{doc['name']}: {k} fields {bad} differ from "
                             f"preset {doc['preset']!r} and its overrides")
    sections["data"] = dataclasses.replace(sections["data"], seed=seed)
    return C.ExperimentConfig(name=doc["name"], **sections)
