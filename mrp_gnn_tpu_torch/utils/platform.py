"""Device selection and numerics for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. There
is no silent fallback: asking for the card on a machine without one raises.

Every entry point (``Predictor``, ``load_exported``'s callable,
``evaluate``, the train step, the ``bench_*`` functions) runs its device
work inside :func:`reference_numerics`, the port's counterpart of the JAX
CLIs' ``apply_platform_env``: IEEE f32 matmuls and convolutions (no TF32),
as the f32 reference that the port is held to, and deterministic cuDNN, so
that a resumed run is bit for bit the straight one.
"""

from __future__ import annotations

import contextlib

import torch

# The per-op precision switches of torch.backends ("ieee", "tf32", "none").
# The legacy booleans (``allow_tf32``) are never read: reading one raises
# once a caller has set its conv and rnn switches apart through these.
_FP32_SWITCHES = (("cuda", "matmul"), ("cudnn", "conv"), ("cudnn", "rnn"),
                  ("mkldnn", "matmul"), ("mkldnn", "conv"), ("mkldnn", "rnn"))


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises RuntimeError when CUDA is absent);
    anything else goes through ``torch.device`` unchanged."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _switches() -> list:
    return [getattr(getattr(torch.backends, b), op) for b, op in _FP32_SWITCHES]


@contextlib.contextmanager
def reference_numerics():
    """Run the body with f32 matmuls and convolutions in IEEE f32 (cuBLAS,
    cuDNN and oneDNN: no TF32, whatever ``set_float32_matmul_precision``
    or the ``allow_tf32`` switches say), cuDNN enabled, deterministic and
    not benchmarking; on exit the caller's exact settings come back.
    Usable as a decorator; nests.

    The settings are process-global in torch: another thread that runs
    convolutions or matmuls while a port call is inside sees them too.
    """
    cudnn = torch.backends.cudnn
    switches = _switches()
    saved = (torch.get_float32_matmul_precision(),
             [s.fp32_precision for s in switches],
             (cudnn.enabled, cudnn.deterministic, cudnn.benchmark))
    try:
        # the matmul precision first: it sets the matmul switches itself,
        # and keeps cuBLAS's legacy view of them in step
        torch.set_float32_matmul_precision("highest")
        for s in switches:
            s.fp32_precision = "ieee"
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = True, True, False
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        for s, v in zip(switches, saved[1]):
            s.fp32_precision = v
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = saved[2]
