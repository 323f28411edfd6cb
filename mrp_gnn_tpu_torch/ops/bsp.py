"""One-pass fused graph attention: the port's counterpart of
``mrp_gnn_tpu/ops/pallas_bsp.py`` for the serving path.

``bsp_attention_fused`` computes SDDMM + masked softmax + SpMM over a
batch's ELL neighbour lists in one kernel
(``csrc/bsp_fused_attention.cu``, replacing the TPU's ``_fused_kernel``).
The CUDA kernel gathers source rows straight from ``ell_src``; the
tile-pair plan only marks the batches it serves (``supports``), as in the
JAX package.

``fused_attention`` is the kernel wrapper. For CPU tensors it runs the
plain torch version (``fused_attention_reference``); for CUDA tensors it
launches the kernel or raises, and counts each launch in
``fused_attention.launches``.

Not ported yet: the backward (ROADMAP.md, queue B items 2-4) — the kernel
serves inference only, and the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mrp_gnn_tpu_torch.ops import _build

_NEG = -1e30
MAX_DEGREE = 128  # the kernel keeps a row's slots in shared memory
MAX_DK = 256      # the kernel keeps a row's query in shared memory
_KERNEL = "bsp_fused_attention"


def supports(graph) -> bool:
    """True when the batch carries a tile-pair plan within the 128-column
    degree cap: the same test as the JAX package's ``pallas_bsp.supports``."""
    return (graph.bsp_tile > 0 and graph.ell_src is not None
            and graph.bsp_pair_dst is not None
            and graph.ell_src.shape[1] <= MAX_DEGREE)


def fused_attention_reference(q_s: torch.Tensor, k: torch.Tensor,
                              values: torch.Tensor, ell_src: torch.Tensor,
                              ell_mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on the kernel's inputs.

    q_s: f32 [V, dk], already scaled by 1/sqrt(dk); k: f32 [V, dk];
    values: [V, D]; ell_src int32 / ell_mask bool [V, deg]. Returns
    [V, D] in the values dtype, summed in f32.
    """
    src = ell_src.long()
    logits = torch.einsum("vd,vjd->vj", q_s, k[src])
    x = torch.where(ell_mask, logits, _NEG)
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.where(ell_mask, torch.exp(x - torch.clamp(m, min=_NEG / 2)), 0.0)
    den = e.sum(-1, keepdim=True)
    alpha = torch.where(den > 0, e / torch.clamp(den, min=1e-30), 0.0)
    out = torch.einsum("vj,vjd->vd", alpha, values[src].float())
    return out.to(values.dtype)


def _check_cuda_inputs(q_s, k, values, ell_src, ell_mask) -> None:
    dev = values.device
    for name, t in (("q_s", q_s), ("k", k), ("ell_src", ell_src),
                    ("ell_mask", ell_mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
    if q_s.dtype != torch.float32 or k.dtype != torch.float32:
        raise TypeError("q_s and k must be float32")
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"values must be float32 or bfloat16, got {values.dtype}")
    if ell_src.dtype != torch.int32 or ell_mask.dtype != torch.bool:
        raise TypeError("ell_src must be int32 and ell_mask bool")
    V, deg = ell_src.shape
    if (q_s.dim() != 2 or q_s.shape != k.shape or q_s.shape[0] != V
            or values.dim() != 2 or values.shape[0] != V
            or ell_mask.shape != ell_src.shape):
        raise ValueError(
            f"shape mismatch: q_s {tuple(q_s.shape)}, k {tuple(k.shape)}, "
            f"values {tuple(values.shape)}, ell_src {tuple(ell_src.shape)}, "
            f"ell_mask {tuple(ell_mask.shape)}")
    if deg > MAX_DEGREE or q_s.shape[1] > MAX_DK:
        raise ValueError(f"kernel takes deg <= {MAX_DEGREE} and dk <= "
                         f"{MAX_DK}, got deg {deg}, dk {q_s.shape[1]}")
    for name, t in (("q_s", q_s), ("k", k), ("values", values),
                    ("ell_src", ell_src), ("ell_mask", ell_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t.requires_grad for t in (q_s, k, values)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "the fused attention kernel has no backward yet (ROADMAP.md, "
            "queue B items 2-4); run it under torch.no_grad()")


def _launch(lib, q_s, k, values, ell_src, ell_mask, out) -> int:
    V, deg = ell_src.shape
    D = values.shape[1]
    bf16 = values.dtype == torch.bfloat16
    per16 = 8 if bf16 else 4  # elements in a 16-byte load
    vec = per16 if (D % per16 == 0 and values.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0) else 1
    fn = lib.bsp_fused_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(q_s.data_ptr(), k.data_ptr(), values.data_ptr(),
              ell_src.data_ptr(), ell_mask.data_ptr(), out.data_ptr(),
              V, deg, q_s.shape[1], D, int(bf16), vec, values.device.index,
              torch.cuda.current_stream(values.device).cuda_stream)


def fused_attention(q_s: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                    ell_src: torch.Tensor,
                    ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`fused_attention_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise: on a failed build,
    on inputs the kernel does not take, or on a refused launch.
    """
    if values.device.type == "cpu":
        return fused_attention_reference(q_s, k, values, ell_src, ell_mask)
    if values.device.type != "cuda":
        raise RuntimeError(f"no fused attention kernel for {values.device}")
    _check_cuda_inputs(q_s, k, values, ell_src, ell_mask)
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    rc = _launch(_build.load(_KERNEL), q_s, k, values, ell_src, ell_mask, out)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def _scaled(q: torch.Tensor, k: torch.Tensor):
    """q scaled by 1/sqrt(dk) in f32 and k cast to f32, as the JAX entry
    does before its kernel (pallas_bsp.py bsp_attention_fused)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).contiguous(), k.float().contiguous()


def bsp_attention_fused(q: torch.Tensor, k: torch.Tensor,
                        values: torch.Tensor, graph) -> torch.Tensor:
    """One-pass fused edge attention over the batch's ELL lists.

    Same semantics as the plain composition ell_sddmm / sqrt(dk) ->
    ell_softmax -> ell_aggregate. q/k: [V, dk]; values [V, D] f32 or bf16.
    """
    q_s, kf = _scaled(q, k)
    return fused_attention(q_s, kf, values, graph.ell_src, graph.ell_mask)


def bsp_attention_fused_reference(q: torch.Tensor, k: torch.Tensor,
                                  values: torch.Tensor, graph) -> torch.Tensor:
    """Plain torch version of :func:`bsp_attention_fused`, on any device."""
    q_s, kf = _scaled(q, k)
    return fused_attention_reference(q_s, kf, values, graph.ell_src,
                                     graph.ell_mask)
