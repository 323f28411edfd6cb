"""A copy of the benchmark's cell files at a size a CPU test run can hold.

:func:`tiny_root` writes ``configs/``, ``traffic/``, ``workloads/`` and
``metrics/`` under a directory, each configuration cut to the sizes of its
own ``tiny`` section (its ``model`` and ``data`` fields: small frames, a
narrow encoder and a few robots), each serving rate and window to a few
requests. The cells, their modes and their limits are the real ones.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import cells

TRAFFIC = {"train": {"log_every": 2, "warmup_steps": 1},
           "serve": {"rate_per_s": 20.0, "pool": 3, "sample": 4,
                     "warmup_requests": 1}}


def tiny_root(path: Path) -> Path:
    """Writes the tiny cell files under ``path`` and returns it."""
    path = Path(path)
    for kind in ("configs", "traffic", "workloads"):
        (path / kind).mkdir(parents=True, exist_ok=True)
    shutil.copytree(cells.ROOT / "metrics", path / "metrics",
                    dirs_exist_ok=True)
    for name in cells.names("configs"):
        doc = cells.load("configs", name)
        model = doc["tiny"]["model"]
        data = doc["tiny"]["data"]
        doc["model"].update(model)
        doc["data"].update(data)
        over = doc.setdefault("overrides", {})
        over.setdefault("model", {}).update(model)
        over.setdefault("data", {}).update(data)
        (path / "configs" / f"{name}.json").write_text(json.dumps(doc))
    for name in cells.names("traffic"):
        doc = cells.load("traffic", name)
        doc.update(TRAFFIC[doc["mode"]])
        (path / "traffic" / f"{name}.json").write_text(json.dumps(doc))
    for name in cells.names("workloads"):
        shutil.copy(cells.ROOT / "workloads" / f"{name}.json",
                    path / "workloads" / f"{name}.json")
    return path
