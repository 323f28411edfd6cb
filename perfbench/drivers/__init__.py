"""One driver per entry point of the program (``drivers/<mode>.py``, the
traffic file's ``mode``). Each exposes ``run(cell, seed, seconds, trace,
device, t_start, readers) -> result`` and a cell class that set-up, the
window and the check are methods of, which ``knee.py`` and ``calibrate.py``
reuse.

Helpers shared by the drivers live here.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.graph import RefGraph, full_graph, radius_graph

# keys of a traced run's "device" beyond the four of every run
_TRACE_DEVICE_KEYS = ("busy_s", "window_s")


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def free_device_memory(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def ref_graph(data: dict, positions) -> RefGraph:
    """The reference's graph of one batch: from the scenes' camera
    positions (radius connectivity) or every pair of a scene (full)."""
    n, s = data["num_robots"], data["scenes_per_batch"]
    max_nodes = data["max_nodes"] or n * s
    if data["connectivity"] == "radius":
        return radius_graph(positions, float(data["comm_radius"]), max_nodes)
    return full_graph(s, n, max_nodes)


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def per_layer(readers: dict, record: dict) -> dict:
    """Each reader's number, leaving out those that found nothing."""
    out = {}
    for name, mod in readers.items():
        v = mod.read(record)
        if v is not None and math.isfinite(v):
            out[name] = metric(float(v), mod.UNIT)
    return out


def attach_profile(result: dict, profile: dict | None) -> None:
    """Puts a traced run's profile into the result line."""
    if profile is None:
        return
    for k in _TRACE_DEVICE_KEYS:
        result["device"][k] = profile[k]
    result["breakdown"] = {"device_ops": profile["device_ops"],
                           "idle_gaps": profile["idle_gaps"]}
