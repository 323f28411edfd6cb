"""Kernels over plain ELL neighbour lists (no tile-pair plan): the port's
counterpart of ``mrp_gnn_tpu/ops/pallas_ell.py``.

Four wrappers, each running its kernel on CUDA tensors (or raising) and
its plain version on CPU tensors, and counting each launch in
``<wrapper>.launches``:

- ``masked_max``: ``csrc/ell_max.cu``, replacing the TPU's ``_max_kernel``;
- ``spmm``: ``csrc/bsp_spmm.cu`` (the BSP SpMM, any width), replacing the
  TPU's per-row ``_spmm_kernel``;
- ``sddmm``: the single form of ``csrc/bsp_sddmm.cu``, replacing its
  ``_sddmm_kernel``;
- ``softmax``: ``csrc/ell_softmax.cu``, replacing its ``_softmax_kernel``
  (a loop and a register form, :func:`softmax_form`).

The entries :func:`ell_max`, :func:`ell_spmm`, :func:`ell_sddmm` and
:func:`ell_softmax` add the gradients of the JAX package's custom vjps, in
plain torch as JAX computes them in XLA, and keep the masking outside the
vjps as JAX does. :func:`ell_attention` composes the last three, as the JAX
package's ``dispatch._compose_ell_attention``. Dispatch does not route to
that composition (it takes the fused BSP kernels or the plain ops, as the
JAX package does); :func:`with_ell_kernels` swaps it in.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from mrp_gnn_tpu_torch.ops import _build, bsp

_NEG = -1e30
_VALUE_TYPES = (torch.float32, torch.bfloat16)
# The forms of the softmax (csrc/ell_softmax.cu), by their index there
# (whose note describes each): "loop" (a warp per row, any width) and
# "register" (a lane group per row, the row in registers; widths up to
# REGISTER_MAX_DEG). :func:`softmax_form` takes "register" wherever it
# runs, the faster form at the ell path's shape on the card (PERF.md
# section 6).
SOFTMAX_FORMS = ("loop", "register")
REGISTER_MAX_DEG = 128


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
        out = bsp._OPS.masked_max(values, ell_src, ell_mask)
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


# --- the plan-free ELL attention -------------------------------------------


def spmm(w: torch.Tensor, values: torch.Tensor, ell_src: torch.Tensor,
         ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of the per-row SpMM, same contract as
    ``bsp.spmm_reference`` (w f32 [V, deg], any width; out in the values
    dtype). Launches ``bsp_spmm.cu``, counted here and not in
    ``bsp.spmm.launches``."""
    if values.device.type == "cpu":
        return bsp.spmm_reference(w, values, ell_src, ell_mask)
    return bsp.run_spmm(spmm, w, values, ell_src, ell_mask)


spmm.launches = 0


def sddmm(q: torch.Tensor, k: torch.Tensor, ell_src: torch.Tensor,
          ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of the per-row edge dots, same contract as
    ``bsp.sddmm_reference`` (f32 [V, deg], 0 on masked slots, any width).
    Launches ``bsp_sddmm.cu``, counted here and not in
    ``bsp.sddmm.launches``."""
    if ell_src.device.type == "cpu":
        return bsp.sddmm_reference(q, k, ell_src, ell_mask)
    return bsp.run_sddmm(sddmm, q, k, ell_src, ell_mask)


sddmm.launches = 0


def softmax_form(deg: int, form: str | None = None) -> int:
    """The index in ``csrc/ell_softmax.cu`` of the softmax's form for an
    ELL width deg: ``form`` None takes "register" up to REGISTER_MAX_DEG,
    "loop" past it; a name of SOFTMAX_FORMS forces that form (the card's
    checks and A/B). Raises ValueError for an unknown form, or the register
    form past REGISTER_MAX_DEG."""
    if form is None:
        form = "register" if deg <= REGISTER_MAX_DEG else "loop"
    if form not in SOFTMAX_FORMS:
        raise ValueError(f"unknown softmax form {form!r}; one of "
                         f"{SOFTMAX_FORMS}")
    if form == "register" and deg > REGISTER_MAX_DEG:
        raise ValueError(f"the register form takes widths up to "
                         f"{REGISTER_MAX_DEG}, got {deg}")
    return SOFTMAX_FORMS.index(form)


def softmax(logits: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of the masked row softmax, same contract as
    ``bsp.masked_softmax`` (f32 [V, deg], any width; a row with no valid
    slot gives 0)."""
    if logits.device.type == "cpu":
        return bsp.masked_softmax(logits, ell_mask)
    return run_softmax(softmax, logits, ell_mask)


def run_softmax(counter, logits, ell_mask, form: str | None = None):
    """Check CUDA inputs and launch ``csrc/ell_softmax.cu`` in the form
    :func:`softmax_form` gives (``form`` forces one, for the card's checks
    and A/B of the forms), counting the launch in ``counter.launches``:
    :func:`softmax` without the plain path."""
    dev = logits.device
    if dev.type != "cuda":
        raise RuntimeError(f"no ell_softmax kernel for {dev}")
    if ell_mask.device != dev:
        raise ValueError(f"ell_mask is on {ell_mask.device}, logits on {dev}")
    if logits.dtype != torch.float32 or ell_mask.dtype != torch.bool:
        raise TypeError("logits must be float32 and ell_mask bool")
    if logits.dim() != 2 or ell_mask.shape != logits.shape:
        raise ValueError(f"logits {tuple(logits.shape)} and ell_mask "
                         f"{tuple(ell_mask.shape)} must be one [V, deg] shape")
    if not (logits.is_contiguous() and ell_mask.is_contiguous()):
        raise ValueError("logits and ell_mask must be contiguous")
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    V, deg = logits.shape
    _build.run("ell_softmax", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
               + [ctypes.c_void_p], logits.data_ptr(), ell_mask.data_ptr(),
               out.data_ptr(), V, deg, softmax_form(deg, form),
               dev.index, _build.stream(logits))
    counter.launches += 1
    return out


softmax.launches = 0


class EllSpmm(torch.autograd.Function):
    """:func:`spmm` with the JAX package's ``_ell_spmm`` custom vjp
    (``pallas_ell.py:140-146``): dw from a product in the values dtype, cast
    to f32; dvalues the scatter-add of the f32 contributions w * g, rounded
    to the values dtype. w must be f32 and 0 on masked slots."""

    @staticmethod
    def forward(ctx, w, values, ell_src, ell_mask):
        ctx.save_for_backward(w, values, ell_src)
        return spmm(w, values, ell_src, ell_mask)

    @staticmethod
    def backward(ctx, g):
        w, values, ell_src = ctx.saved_tensors
        src = ell_src.long()
        dw = dvalues = None
        if ctx.needs_input_grad[0]:
            dw = torch.einsum("vd,vjd->vj", g, values[src]).to(w.dtype)
        if ctx.needs_input_grad[1]:
            contrib = w[..., None] * g[:, None, :]
            dvalues = torch.zeros_like(values).index_add_(
                0, src.flatten(), contrib.flatten(0, 1).to(values.dtype))
        return dw, dvalues, None, None


class EllSddmm(torch.autograd.Function):
    """:func:`sddmm` with the JAX package's ``_ell_sddmm`` custom vjp
    (``pallas_ell.py:335-339``): dq = sum_j g * k[src], dk the scatter-add
    of g * q over every slot (g is 0 on masked slots: the caller masks
    outside the Function)."""

    @staticmethod
    def forward(ctx, q, k, ell_src, ell_mask):
        ctx.save_for_backward(q, k, ell_src)
        return sddmm(q, k, ell_src, ell_mask)

    @staticmethod
    def backward(ctx, g):
        q, k, ell_src = ctx.saved_tensors
        src = ell_src.long()
        dq = torch.einsum("vj,vjd->vd", g, k[src]).to(q.dtype)
        dk = torch.zeros_like(k).index_add_(
            0, src.flatten(), (g[..., None] * q[:, None, :]).flatten(0, 1))
        return dq, dk, None, None


class EllSoftmax(torch.autograd.Function):
    """:func:`softmax` with the JAX package's ``_ell_softmax`` custom vjp
    (``pallas_ell.py:391-396``): dl = alpha * (g - <alpha, g>) on the saved
    weights."""

    @staticmethod
    def forward(ctx, logits, ell_mask):
        alpha = softmax(logits, ell_mask)
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        return alpha * (g - (alpha * g).sum(dim=-1, keepdim=True)), None


def ell_spmm(weights: torch.Tensor, values: torch.Tensor,
             ell_src: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour sum with a gradient for both operands; the weights
    are masked and cast to f32 outside the Function, as at
    ``pallas_ell.py:152-156``."""
    w = torch.where(ell_mask, weights, 0.0).float()
    return EllSpmm.apply(w.contiguous(), values.contiguous(), ell_src,
                         ell_mask)


def ell_sddmm(q: torch.Tensor, k: torch.Tensor, ell_src: torch.Tensor,
              ell_mask: torch.Tensor) -> torch.Tensor:
    """Edge dots of q and k in f32, 0 on masked slots, with a gradient for
    both; the mask is applied outside the Function (``pallas_ell.py:
    345-349``), so autograd sends the Function a cotangent of 0 there."""
    logits = EllSddmm.apply(q.float().contiguous(), k.float().contiguous(),
                            ell_src, ell_mask)
    return torch.where(ell_mask, logits, 0.0)


def ell_softmax(logits: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """Masked row softmax in f32, with its gradient."""
    return EllSoftmax.apply(logits.float().contiguous(), ell_mask)


def ell_attention(q: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                  graph) -> torch.Tensor:
    """Edge attention over the batch's ELL lists through the three kernels
    (``dispatch._compose_ell_attention`` of the JAX package over
    ``pallas_ell``); any ELL width, no plan needed."""
    logits = ell_sddmm(q, k, graph.ell_src, graph.ell_mask)
    alpha = ell_softmax(logits / math.sqrt(q.shape[-1]), graph.ell_mask)
    return ell_spmm(alpha, values, graph.ell_src, graph.ell_mask)


def ell_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            values: torch.Tensor, graph) -> torch.Tensor:
    """Plain torch version of :func:`ell_attention`, made of the three
    kernels' plain versions; torch's autograd differentiates it."""
    src, mask = graph.ell_src, graph.ell_mask
    logits = bsp.sddmm_reference(q, k, src, mask) / math.sqrt(q.shape[-1])
    return bsp.spmm_reference(bsp.masked_softmax(logits, mask), values, src,
                              mask)


def with_ell_kernels(ops):
    """A copy of the ``EdgeOps`` ``ops`` whose ELL attention is
    :func:`ell_attention`, whatever plan the batch carries."""
    return dataclasses.replace(ops, ell_attention=ell_attention)
