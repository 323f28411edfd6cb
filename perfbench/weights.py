"""Seeded weights, made on the device in one draw.

Every parameter comes out of one standard-normal draw from a
``torch.Generator`` seeded with the run's seed, on the run's device,
clipped to two standard deviations: a matrix or kernel is scaled to
variance 1 / fan-in (lecun-normal, as the model initialises), a vector
named ``*.bias`` is scaled by 0.1, and any other vector (a norm's scale)
is 1 plus 0.1 times its draw. The benchmark loads the same dict into the
program and hands it to the reference.
"""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def seeded_state_dict(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor of ``shapes[name]``} on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    flat.clamp_(-2.0, 2.0)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        x = part.view(shape)
        if len(shape) > 1:
            x = x * (math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD)
        elif name.endswith(".bias"):
            x = 0.1 * x
        else:
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out
