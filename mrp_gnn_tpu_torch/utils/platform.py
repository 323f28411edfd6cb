"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. There
is no silent fallback: asking for the card on a machine without one raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises RuntimeError when CUDA is absent);
    anything else goes through ``torch.device`` unchanged."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
