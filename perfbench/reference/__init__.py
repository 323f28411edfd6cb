"""The plain reference that decides ``correct``: the networks, their
losses and their optimizer in plain PyTorch, and frozen copies of the data
rules they need: the training stream's scenes (``render.py``) and its
graphs (``graph.py``). It imports nothing of the measured program and
takes nothing the program made; the benchmark hands it the same seeded
weights and inputs as the program.

Each configuration file names its network's module (``reference``; see
``cells.reference`` for the interface): ``model.py`` is the CNN encoder
with single-head attention fusion. The training step (``train.py``) takes
the network's ``forward``, whichever module it comes from.

:func:`numerics` fixes the precision that a reference pass runs in:
"ieee" (float32 everywhere, the configuration's precision) or "tf32" (the
control, the nearest lower precision on the card).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def numerics(precision: str = "ieee"):
    """float32 matmuls and convolutions in IEEE f32 ("ieee") or in TF32
    ("tf32"); the caller's settings come back on exit."""
    if precision not in ("ieee", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    switches = [torch.backends.cuda.matmul, torch.backends.cudnn.conv]
    saved = (torch.get_float32_matmul_precision(),
             [s.fp32_precision for s in switches])
    try:
        torch.set_float32_matmul_precision(
            "highest" if precision == "ieee" else "high")
        for s in switches:
            s.fp32_precision = precision
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        for s, v in zip(switches, saved[1]):
            s.fp32_precision = v
