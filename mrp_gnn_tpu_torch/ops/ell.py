"""Masked max aggregation over ELL neighbour lists: the port's counterpart
of ``mrp_gnn_tpu/ops/pallas_ell.py::ell_max``.

``masked_max`` runs ``csrc/ell_max.cu`` (replacing the TPU's
``_max_kernel``) on CUDA tensors and its plain version,
:func:`masked_max_reference`, on CPU tensors; it counts each launch in
``masked_max.launches``. :func:`ell_max` adds the gradient of the JAX
package's ``_ell_max_bwd``, in plain torch as JAX computes it in XLA.

The other kernels of ``pallas_ell.py`` (its per-row SpMM, SDDMM and softmax)
run only in the JAX package's benchmarks and are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from mrp_gnn_tpu_torch.ops import _build

_NEG = -1e30
_VALUE_TYPES = (torch.float32, torch.bfloat16)


def masked_max_reference(values: torch.Tensor, ell_src: torch.Tensor,
                         ell_mask: torch.Tensor) -> torch.Tensor:
    """out[v] = max(_NEG, max over valid j of values[ell_src[v, j]]),
    compared in f32, NaN-propagating; a row with no valid slot gives 0.
    Returns [V, D] in the values dtype."""
    cand = torch.where(ell_mask[..., None], values[ell_src.long()].float(),
                       _NEG)
    mx = torch.clamp(cand.amax(dim=1), min=_NEG)  # both propagate NaN
    return torch.where(ell_mask.any(dim=1)[:, None], mx, 0.0).to(values.dtype)


def _check_cuda(values, ell_src, ell_mask) -> None:
    dev = values.device
    if dev.type != "cuda":
        raise RuntimeError(f"no ell_max kernel for {dev}")
    if ell_src.device != dev or ell_mask.device != dev:
        raise ValueError(f"ell_src and ell_mask must be on {dev}")
    if values.dtype not in _VALUE_TYPES:
        raise TypeError(f"values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    if ell_src.dtype != torch.int32 or ell_mask.dtype != torch.bool:
        raise TypeError("ell_src must be int32 and ell_mask bool")
    if (values.dim() != 2 or ell_src.dim() != 2
            or ell_mask.shape != ell_src.shape):
        raise ValueError(f"values {tuple(values.shape)}, ell_src "
                         f"{tuple(ell_src.shape)} and ell_mask "
                         f"{tuple(ell_mask.shape)} must be [Vs, D] and one "
                         "[V, deg] shape")
    if not (values.is_contiguous() and ell_src.is_contiguous()
            and ell_mask.is_contiguous()):
        raise ValueError("values, ell_src and ell_mask must be contiguous")


def masked_max(values: torch.Tensor, ell_src: torch.Tensor,
               ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`masked_max_reference`, for
    any ELL width. CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream or raise."""
    if values.device.type == "cpu":
        return masked_max_reference(values, ell_src, ell_mask)
    _check_cuda(values, ell_src, ell_mask)
    V, deg = ell_src.shape
    out = torch.empty(V, values.shape[1], dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    vec8 = (values.shape[1] % 8 == 0 and values.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    _build.run("ell_max", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               values.data_ptr(), ell_src.data_ptr(), ell_mask.data_ptr(),
               out.data_ptr(), V, deg, values.shape[1],
               int(values.dtype == torch.bfloat16), 8 if vec8 else 1,
               values.device.index, _build.stream(values))
    masked_max.launches += 1
    return out


masked_max.launches = 0


def ell_max_backward(values, ell_src, ell_mask, out, g) -> torch.Tensor:
    """dvalues of :func:`ell_max`, the JAX package's ``_ell_max_bwd``
    (``pallas_ell.py:240-251``): each row's cotangent split equally among
    the valid slots whose value equals the max (compared in the values
    dtype), scattered onto the source rows, all in the values dtype."""
    gathered = values[ell_src.long()]                        # [V, deg, D]
    is_max = ((gathered == out[:, None, :])
              & ell_mask[..., None]).to(values.dtype)
    nmax = torch.clamp(is_max.sum(dim=1, keepdim=True), min=1.0)
    contrib = is_max / nmax * g.to(values.dtype)[:, None, :]
    return torch.zeros_like(values).index_add_(
        0, ell_src.flatten().long(), contrib.flatten(0, 1))


class EllMax(torch.autograd.Function):
    """:func:`masked_max` with the JAX package's ``_ell_max`` custom vjp."""

    @staticmethod
    def forward(ctx, values, ell_src, ell_mask):
        out = masked_max(values, ell_src, ell_mask)
        ctx.save_for_backward(values, ell_src, ell_mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return ell_max_backward(*ctx.saved_tensors, g), None, None


def ell_max(values: torch.Tensor, ell_src: torch.Tensor,
            ell_mask: torch.Tensor) -> torch.Tensor:
    """Masked max over in-neighbours (rows with no valid in-edge give 0),
    with a gradient for ``values``."""
    return EllMax.apply(values.contiguous(), ell_src, ell_mask)
