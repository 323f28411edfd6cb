"""Block-diagonal scene attention: the port's counterpart of
``mrp_gnn_tpu/ops/pallas_edge.py``.

For a batch of scenes that share one topology at a fixed node stride
(``graph.scene_stride`` n > 0), :func:`block_fused_attention` computes each
node's masked softmax attention over its scene and the weighted sum of the
scene's value rows in one kernel (``csrc/block_attention.cu``, replacing
the TPU's ``_attn_kernel``). Its backward (:class:`BlockAttention`) is the
JAX package's ``_block_attn_bwd`` in plain torch, batched products on
[S, n, n], as JAX computes it in XLA einsums.

The kernel rounds where the TPU kernel does, not where the einsum route
(``reference.block_fused_attention``) does: with bf16 values, q and k enter
in bf16 and the weights are rounded to bf16 before the weighted sum.
:func:`block_attention_reference` is its plain version on the kernel's
inputs. The wrapper :func:`block_attention` runs that plain version for CPU
tensors; for CUDA tensors it launches the kernel or raises, and counts each
launch in ``block_attention.launches``.

Dispatch routes the block league to the einsum route, as the JAX package
does; :func:`with_block_kernel` gives a copy of the ops with this kernel
swapped in, as ``bench.py`` swaps the TPU kernel in.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from mrp_gnn_tpu_torch.ops import _build

_NEG = -1e30
MAX_SCENE = 256  # the kernel keeps a pass's [8, n] weights in shared memory
_VALUE_TYPES = (torch.float32, torch.bfloat16)


def _scene_weights(q_s, k, valid, scene_adj, dtype) -> torch.Tensor:
    """alpha [S, n, n] of the kernel's function, f32 math rounded to
    ``dtype``: logits plus the scene bias, the source mask, the max floored
    at _NEG / 2 and a sum at most 1e-20 giving 0."""
    n = scene_adj.shape[0]
    S = q_s.shape[0] // n
    qb = q_s.float().reshape(S, n, -1)
    kb = k.float().reshape(S, n, -1)
    logits = torch.einsum("sid,sjd->sij", qb, kb)
    logits = logits + torch.where(scene_adj > 0, 0.0, _NEG)
    logits = torch.where(valid.reshape(S, 1, n), logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - torch.clamp(m, min=_NEG / 2))
    den = e.sum(dim=-1, keepdim=True)
    alpha = torch.where(den > 1e-20, e / torch.clamp(den, min=1e-30), 0.0)
    return alpha.to(dtype)


def block_attention_reference(q_s: torch.Tensor, k: torch.Tensor,
                              values: torch.Tensor, valid: torch.Tensor,
                              scene_adj: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on the kernel's inputs.

    q_s: [V, dk], already scaled by 1/sqrt(dk); k [V, dk] (both f32, or
    bf16); values [V, D] f32 or bf16; valid bool [V]; scene_adj f32 [n, n]
    (adj[dst, src]), V a multiple of n. Returns [V, D] in the values dtype:
    the weights rounded to that dtype, the weighted sum in f32.
    """
    n = scene_adj.shape[0]
    V, D = values.shape
    alpha = _scene_weights(q_s, k, valid, scene_adj, values.dtype)
    out = torch.einsum("sij,sjd->sid", alpha.float(),
                       values.float().reshape(V // n, n, D))
    return out.reshape(V, D).to(values.dtype)


def _check_cuda(q_s, k, values, valid, scene_adj) -> None:
    dev = values.device
    if dev.type != "cuda":
        raise RuntimeError(f"no block attention kernel for {dev}")
    for name, t in dict(q_s=q_s, k=k, values=values, valid=valid,
                        scene_adj=scene_adj).items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.dtype not in _VALUE_TYPES or q_s.dtype not in _VALUE_TYPES:
        raise TypeError(f"values and q_s must be float32 or bfloat16, got "
                        f"{values.dtype} and {q_s.dtype}")
    if (k.dtype != q_s.dtype or valid.dtype != torch.bool
            or scene_adj.dtype != torch.float32):
        raise TypeError("k must have q_s's dtype, valid must be bool and "
                        "scene_adj float32")
    n = scene_adj.shape[0] if scene_adj.dim() == 2 else 0
    V = values.shape[0]
    if (scene_adj.shape != (n, n) or values.dim() != 2 or q_s.dim() != 2
            or n == 0 or V % n or q_s.shape != k.shape or q_s.shape[0] != V
            or q_s.shape[1] == 0 or valid.shape != (V,)):
        raise ValueError(
            f"shape mismatch: q_s {tuple(q_s.shape)}, k {tuple(k.shape)}, "
            f"values {tuple(values.shape)}, valid {tuple(valid.shape)}, "
            f"scene_adj {tuple(scene_adj.shape)}")
    if n > MAX_SCENE:
        raise ValueError(f"the kernel takes scenes of <= {MAX_SCENE} nodes, "
                         f"got {n}")


def block_attention(q_s: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                    valid: torch.Tensor, scene_adj: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`block_attention_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise: on a failed build, on
    inputs the kernel does not take (scenes past 256 nodes among them), or
    on a refused launch. It computes no gradient itself:
    :class:`BlockAttention` carries the backward.
    """
    if values.device.type == "cpu":
        return block_attention_reference(q_s, k, values, valid, scene_adj)
    _check_cuda(q_s, k, values, valid, scene_adj)
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    V, D = values.shape
    n = scene_adj.shape[0]
    vec8 = D % 8 == 0 and values.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _build.run("block_attention", [ctypes.c_void_p] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
               + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               q_s.data_ptr(), k.data_ptr(), int(q_s.dtype == torch.bfloat16),
               values.data_ptr(), valid.data_ptr(), scene_adj.data_ptr(),
               out.data_ptr(), V // n, n, q_s.shape[1], D,
               int(values.dtype == torch.bfloat16), 8 if vec8 else 1,
               values.device.index, _build.stream(values))
    block_attention.launches += 1
    return out


block_attention.launches = 0


def block_attention_backward(q_s, k, values, valid, scene_adj, g) -> tuple:
    """(dq_s, dk, dvalues) for the output cotangent ``g``: the JAX
    package's ``_block_attn_bwd`` (``pallas_edge.py:150-190``). The weights
    are recomputed and rounded to the values dtype; dvalues and the weights'
    cotangent come from products in that dtype, the rest in f32."""
    n = scene_adj.shape[0]
    V, D = values.shape
    S = V // n
    alpha = _scene_weights(q_s, k, valid, scene_adj, values.dtype)
    gb = g.reshape(S, n, D)
    vb = values.reshape(S, n, D)
    dv = torch.einsum("sij,sid->sjd", alpha, gb).reshape(V, D)
    dalpha = torch.einsum("sid,sjd->sij", gb, vb).float()
    a32 = alpha.float()
    dlog = a32 * (dalpha - (a32 * dalpha).sum(dim=-1, keepdim=True))
    dq = torch.einsum("sij,sjd->sid", dlog, k.float().reshape(S, n, -1))
    dk = torch.einsum("sij,sid->sjd", dlog, q_s.float().reshape(S, n, -1))
    return (dq.reshape(V, -1).to(q_s.dtype), dk.reshape(V, -1).to(k.dtype),
            dv.to(values.dtype))


class BlockAttention(torch.autograd.Function):
    """:func:`block_attention` with its backward, the counterpart of the JAX
    package's ``_block_attn`` custom vjp. The forward saves only its inputs;
    the backward recomputes the weights."""

    @staticmethod
    def forward(ctx, q_s, k, values, valid, scene_adj):
        ctx.save_for_backward(q_s, k, values, valid, scene_adj)
        return block_attention(q_s, k, values, valid, scene_adj)

    @staticmethod
    def backward(ctx, g):
        return (*block_attention_backward(*ctx.saved_tensors, g), None, None)


def _kernel_inputs(q: torch.Tensor, k: torch.Tensor, values: torch.Tensor):
    """q divided by sqrt(dk) in f32, then q and k in the values dtype when
    that is bf16 and in f32 otherwise, as the JAX entry prepares them
    (``pallas_edge.py:219-221``)."""
    qk_dtype = torch.bfloat16 if values.dtype == torch.bfloat16 else torch.float32
    q_s = (q.float() / math.sqrt(q.shape[-1])).to(qk_dtype)
    return q_s.contiguous(), k.to(qk_dtype).contiguous()


def block_fused_attention(q: torch.Tensor, k: torch.Tensor,
                          values: torch.Tensor, graph) -> torch.Tensor:
    """Fused attention for a block-diagonal batch through the kernel, with a
    gradient for q, k and values. q/k: [V, dk]; values [V, D] f32 or bf16;
    returns [V, D] in the values dtype."""
    q_s, kk = _kernel_inputs(q, k, values)
    return BlockAttention.apply(q_s, kk, values.contiguous(), graph.node_mask,
                                graph.scene_adj)


def block_fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    values: torch.Tensor, graph) -> torch.Tensor:
    """Plain torch version of :func:`block_fused_attention`; torch's
    autograd differentiates it."""
    q_s, kk = _kernel_inputs(q, k, values)
    return block_attention_reference(q_s, kk, values, graph.node_mask,
                                     graph.scene_adj)


def with_block_kernel(ops):
    """A copy of the ``EdgeOps`` ``ops`` whose block-diagonal attention is
    :func:`block_fused_attention` (``bench.py:88-91`` in the JAX package)."""
    return dataclasses.replace(ops, block_fused_attention=block_fused_attention)
