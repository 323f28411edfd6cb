"""The kernels' forward ops, registered with ``torch.library``.

The kernels are ctypes launches (``ops/_build.py``) that read raw pointers
and choose their forms from pointer alignment at run time, which
``torch.export`` cannot trace: its FakeTensors have no data. So each
forward that the serving path launches is a custom op under the
``mrp_gnn_torch`` namespace, whose implementation is the kernel's wrapper
(CPU tensors: the plain version; CUDA tensors: the kernel, or a raise) and
whose fake implementation gives only the output's shape and dtype:

- ``fused_attention``: :func:`bsp.fused_attention` (the one-pass ELL
  attention, ``csrc/bsp_fused_attention.cu``);
- ``expanded_forward``: :func:`bsp.expanded_forward` (attention past 128
  in-neighbours over the row-expanded view, ``csrc/bsp_fused_parts.cu``,
  both forms);
- ``spmm``: :func:`bsp.spmm` (the weighted neighbour sum,
  ``csrc/bsp_spmm.cu``);
- ``masked_max``: :func:`ell.masked_max` (``csrc/ell_max.cu``).

The autograd Functions of ``bsp`` and ``ell`` call these ops in their
forward, so training, eager serving and an exported program go through one
entry per kernel, and the wrappers count the launches as before. An
exported program that holds these ops needs this module imported to load
(``serving.load_exported`` does), and nothing of the model code. Each op
returns a fresh tensor and aliases no input. Each implementation looks its
wrapper up on the module at call time.
"""

from __future__ import annotations

import torch
from torch import Tensor

from mrp_gnn_tpu_torch.ops import bsp, ell

NAMESPACE = "mrp_gnn_torch"


@torch.library.custom_op(f"{NAMESPACE}::fused_attention", mutates_args=())
def fused_attention(q_s: Tensor, k: Tensor, values: Tensor, ell_src: Tensor,
                    ell_mask: Tensor) -> Tensor:
    return bsp.fused_attention(q_s, k, values, ell_src, ell_mask)


@fused_attention.register_fake
def _(q_s, k, values, ell_src, ell_mask):
    return values.new_empty(ell_src.shape[0], values.shape[1])


@torch.library.custom_op(f"{NAMESPACE}::expanded_forward", mutates_args=())
def expanded_forward(q_s: Tensor, k: Tensor, values: Tensor, src_x: Tensor,
                     mask_x: Tensor, rows: int) -> Tensor:
    return bsp.expanded_forward(q_s, k, values, src_x, mask_x, rows)


@expanded_forward.register_fake
def _(q_s, k, values, src_x, mask_x, rows):
    return values.new_empty(q_s.shape[0], values.shape[1])


@torch.library.custom_op(f"{NAMESPACE}::spmm", mutates_args=())
def spmm(w: Tensor, x: Tensor, ell_src: Tensor, ell_mask: Tensor) -> Tensor:
    return bsp.spmm(w, x, ell_src, ell_mask)


@spmm.register_fake
def _(w, x, ell_src, ell_mask):
    return x.new_empty(ell_src.shape[0], x.shape[1])


@torch.library.custom_op(f"{NAMESPACE}::masked_max", mutates_args=())
def masked_max(values: Tensor, ell_src: Tensor, ell_mask: Tensor) -> Tensor:
    return ell.masked_max(values, ell_src, ell_mask)


@masked_max.register_fake
def _(values, ell_src, ell_mask):
    return values.new_empty(ell_src.shape[0], values.shape[1])


OPS = {"fused_attention": fused_attention,
       "expanded_forward": expanded_forward, "spmm": spmm,
       "masked_max": masked_max}


def op_names(graph_module) -> list:
    """The names (``mrp_gnn_torch::<op>``) of this library's ops that the
    fx graph ``graph_module`` calls, sorted, each once."""
    found = set()
    for node in graph_module.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name):
            name = name()
            if name.startswith(f"{NAMESPACE}::"):
                found.add(name.split(".")[0])
    return sorted(found)
