"""Move flax parameters into the torch model.

``tree`` is the flax parameter tree as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives), with or without the outer
"params" key. Module names mirror the flax names, so the flax path
``encoder/stem/Conv_0/kernel`` lands in ``encoder.stem.Conv_0.weight``.
Conv kernels go HWIO -> OIHW, Dense kernels [in, out] -> [out, in],
GroupNorm "scale" -> "weight". Every flax leaf must land in a parameter of
the right shape and every parameter must be filled, or this raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: dict, prefix=()) -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def load_flax_params(model: nn.Module, tree: dict) -> nn.Module:
    if set(tree) == {"params"}:
        tree = tree["params"]
    params = dict(model.named_parameters())
    filled = set()
    for path, leaf in _flatten(tree).items():
        if path[-1] not in _LEAF:
            raise KeyError(f"flax parameter {'/'.join(path)!r} has no torch "
                           "counterpart")
        name = ".".join(path[:-1] + (_LEAF[path[-1]],))
        if name not in params:
            raise KeyError(f"flax parameter {'/'.join(path)!r} has no torch "
                           f"counterpart {name!r}")
        a = np.array(leaf, np.float32)  # a writable copy
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        p = params[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: flax shape {a.shape} does "
                             f"not fit {name} {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"torch parameters absent from the flax tree: {missing}")
    return model
