"""Backend dispatch for the graph edge ops: plain torch vs CUDA kernels.

Port of ``mrp_gnn_tpu/ops/dispatch.py`` with the same routing.
``get_ops("xla")`` returns the plain torch ops; ``get_ops("pallas")`` the
kernel backend, which routes as the JAX Pallas backend does:

- block-diagonal batches -> plain torch (dense einsums; the JAX package
  routes this league to XLA as well);
- attention, ELL with a tile-pair plan -> the fused attention kernel
  (``ops/bsp.py``), whose backward runs the SDDMM, SpMM and
  transposed-SpMM kernels;
- attention, ELL width > 128 with a row-expanded plan -> the parts kernel
  over the expanded view and its combine (``bsp.expanded_attention_fused``),
  with the same backward kernels;
- mean, ELL with a tile-pair plan -> the SpMM kernel (``bsp.bsp_mean``);
  with a row-expanded plan -> the SpMM over the expanded view
  (``bsp.expanded_mean``); the backward runs the transposed SpMM;
- max, any ELL batch -> the masked max kernel (``ell.ell_max``);
- ELL attention and mean without a plan -> the plain ELL composition.

``resolve_impl("auto", device)`` gives ``"pallas"`` for CUDA and ``"xla"``
otherwise; on CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from mrp_gnn_tpu_torch.ops import bsp as B
from mrp_gnn_tpu_torch.ops import ell as E
from mrp_gnn_tpu_torch.ops import reference as R


@dataclasses.dataclass(frozen=True)
class EdgeOps:
    sddmm: Callable
    segment_softmax: Callable
    spmm: Callable
    segment_mean_agg: Callable
    segment_max_agg: Callable | None = None
    # Dense path for block-diagonal scene batches.
    block_fused_attention: Callable | None = None
    block_mean_agg: Callable | None = None
    block_max_agg: Callable | None = None
    # ELL path: (q, k, values, graph) -> msg and (values, graph) -> msg.
    ell_attention: Callable | None = None
    ell_mean: Callable | None = None
    ell_max: Callable | None = None
    impl: str = "xla"


def _ell_attention_plain(q, k, values, graph):
    logits = R.ell_sddmm(q, k, graph.ell_src, graph.ell_mask)
    logits = logits / math.sqrt(q.shape[-1])
    alpha = R.ell_softmax(logits, graph.ell_mask)
    return R.ell_aggregate(alpha, values, graph.ell_src, graph.ell_mask, "sum")


def _ell_mean_plain(values, graph):
    ones = graph.ell_mask.to(values.dtype)
    return R.ell_aggregate(ones, values, graph.ell_src, graph.ell_mask, "mean")


def _ell_max_plain(values, graph):
    return R.ell_aggregate(None, values, graph.ell_src, graph.ell_mask, "max")


def _plain_ops() -> EdgeOps:
    return EdgeOps(R.sddmm, R.segment_softmax, R.spmm, R.segment_mean_agg,
                   R.segment_max_agg,
                   R.block_fused_attention, R.block_mean_agg, R.block_max_agg,
                   _ell_attention_plain, _ell_mean_plain, _ell_max_plain)


def _kernel_ops() -> EdgeOps:
    def ell_attention(q, k, values, graph):
        if B.supports(graph):
            return B.bsp_attention_fused(q, k, values, graph)
        if B.supports_expanded(graph):
            return B.expanded_attention_fused(q, k, values, graph)
        return _ell_attention_plain(q, k, values, graph)

    def ell_mean(values, graph):
        if B.supports(graph):
            return B.bsp_mean(values, graph)
        if B.supports_expanded(graph):
            return B.expanded_mean(values, graph)
        return _ell_mean_plain(values, graph)

    def ell_max(values, graph):
        return E.ell_max(values, graph.ell_src, graph.ell_mask)

    return EdgeOps(R.sddmm, R.segment_softmax, R.spmm, R.segment_mean_agg,
                   R.segment_max_agg,
                   R.block_fused_attention, R.block_mean_agg, R.block_max_agg,
                   ell_attention, ell_mean, ell_max, impl="pallas")


_BACKENDS = {"xla": _plain_ops, "pallas": _kernel_ops}


def resolve_impl(impl: str, device=None) -> str:
    """"auto" picks the kernels for CUDA tensors and the plain ops for any
    other device (``device`` None counts as not CUDA)."""
    if impl != "auto":
        return impl
    return "pallas" if device is not None and torch.device(device).type == "cuda" else "xla"


def get_ops(impl: str = "xla", device=None) -> EdgeOps:
    impl = resolve_impl(impl, device)
    if impl not in _BACKENDS:
        raise ValueError(f"unknown ops impl {impl!r}; choose from "
                         f"{sorted(_BACKENDS)} or 'auto'")
    return _BACKENDS[impl]()
