"""Graph attention and mean aggregation over ELL neighbour lists: the
port's counterpart of ``mrp_gnn_tpu/ops/pallas_bsp.py``.

``bsp_attention_fused`` computes SDDMM + masked softmax + SpMM over a
batch's ELL neighbour lists in one kernel (``csrc/bsp_fused_attention.cu``,
replacing the TPU's ``_fused_kernel``), with a backward
(:class:`FusedAttention`) that follows the JAX package's
``_bsp_fused_bwd`` through three more kernels:

- ``sddmm`` (``csrc/bsp_sddmm.cu``; the TPU's ``_sddmm_kernel`` and, in
  the dual form, ``_sddmm2_kernel``): edge dot products;
- ``spmm`` (``csrc/bsp_spmm.cu``; ``_spmm_kernel``): weighted neighbour
  sums;
- ``spmm_t`` (``csrc/bsp_spmm_t.cu``; ``_spmm_t_kernel``): the transposed
  sums, with no float atomics; the backward runs its dual form,
  ``spmm_t2`` (``_spmm_t2_kernel``), which gives dvalues and dk from one
  launch.

The SDDMM, the transposed SpMM and the high-degree forward each have two
forms, chosen by :func:`tiled_form` from the ELL shape: per-edge (a block
per row, or per source over a source-major view of the valid slots,
:func:`source_view`) and tiled (dense blocks per pair of node tiles that
holds a valid slot, :func:`tile_pairs`), for ELL widths from TILED_MIN_DEG.
Below that width the transposed SpMM has a third, the staged form (a block
per tile of TILE sources builds its own source-major slot list in shared
memory and stages each destination row once: one launch, no view), which
:func:`spmm_t_form` takes up to STAGED_MAX_NODES nodes and an ELL width of
STAGED_MAX_DEG; past them the per-edge form and its view stay.
``_run_spmm_t(..., form=)``, a test-only argument, forces a form of
SPMM_T_FORMS.
The fused forward and the SpMM each have a row form and a vector form,
chosen by :func:`fused_form` and :func:`spmm_form` from the values' type
and width; the attention weights a block and a warp-per-row form, chosen
by :func:`weights_form` from dk and the rows' alignment.

``bsp_attention`` is the JAX package's two-kernel form: ``attention_weights``
(``csrc/bsp_weights.cu``; ``_weights_kernel``) emits alpha, with the
``_bsp_weights`` gradient (:class:`BspWeights`), and the SpMM aggregates;
:func:`with_bsp_attention` puts it on a model path. ``bsp_mean`` is the
SpMM with the JAX ``_bsp_spmm`` gradient
(:class:`WeightedAggregate`). ELL widths past 128 run over the row-expanded
view of the neighbour lists (``graph.BspExpandedPlan``, at most 128 slots
per expanded row): ``expanded_attention_fused`` through
:func:`expanded_forward` (``csrc/bsp_fused_parts.cu``, replacing the TPU's
``_fused_parts_kernel``: per-edge, ``fused_attention_parts`` and
:func:`xp_combine`, or tiled on the node view of the expanded lists, by
:func:`tiled_form`), whose backward runs the same three kernels on that
node view;
``expanded_mean`` through the SpMM. The CUDA kernels gather rows straight
from ``ell_src``; the tile-pair plans only mark the batches they serve
(``supports``, ``supports_expanded``), as in the JAX package.

Each kernel has a wrapper and a plain torch version beside it. A wrapper
runs the plain version for CPU tensors; for CUDA tensors it launches the
kernel or raises, and counts each launch in ``<wrapper>.launches``. The
SpMM and SDDMM kernels take any ELL width; the plan-free ELL path of
``ops/ell.py`` launches them through wrappers of its own.
:func:`launch_counts` gives the counts of every wrapper of the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import math

import torch

from mrp_gnn_tpu_torch.ops import _build
from mrp_gnn_tpu_torch.ops import reference as R

_NEG = -1e30
MAX_DEGREE = 128  # the fused kernels keep a row's slots in shared memory
MAX_DK = 256      # the fused kernels keep a row's query in shared memory
# The form rule of bsp_sddmm.cu, bsp_spmm_t.cu and bsp_fused_parts.cu
# (:func:`tiled_form`): node tiles of TILE (csrc/bsp_common.cuh kTile), the
# tiled form from an ELL width of TILED_MIN_DEG, while the dense [V, Vs]
# weights of the tiled transposed SpMM and forward stay within
# TILED_MAX_DENSE elements (64 MB in f32).
TILE = 64
TILED_MIN_DEG = 64
TILED_MAX_DENSE = 1 << 24
# The forms of the transposed SpMM (csrc/bsp_spmm_t.cu), by their index
# there (whose note describes each): "per-edge" (over :func:`source_view`),
# "tiled" and "staged". :func:`spmm_t_form` takes "tiled" where
# :func:`tiled_form` does, "staged" up to an ELL width of STAGED_MAX_DEG
# while the destination and source nodes stay within STAGED_MAX_NODES and
# ell_src and ell_mask are 16-byte aligned, "per-edge" otherwise: the
# faster form at each shape measured on the card (PERF.md section 6).
SPMM_T_FORMS = ("per-edge", "tiled", "staged")
STAGED_MAX_NODES = 2048
STAGED_MAX_DEG = 32
_KERNEL = "bsp_fused_attention"
# The forms of the fused forward, by their index in
# csrc/bsp_fused_attention.cu (whose note describes each): "row" (any D)
# and "vec" (16-byte value rows only). :func:`fused_form` takes "vec" for
# f32 values and "row" for bf16, the faster form of each type at the
# attention path's shapes on the card (PERF.md section 6).
FUSED_FORMS = ("row", "vec")
# The forms of the SpMM (csrc/bsp_spmm.cu), by their index there (whose
# note describes each): "row" (any D) and "vec" (16-byte rows only).
# :func:`spmm_form` takes "vec" for f32 x in 16-byte rows from a width of
# SPMM_VEC_MIN_D (one vector block's features) and "row" otherwise, the
# faster form of each at the paths' shapes on the card (PERF.md section 6).
SPMM_FORMS = ("row", "vec")
SPMM_VEC_MIN_D = 2048
# The forms of the attention weights (csrc/bsp_weights.cu), by their index
# there (whose note describes each): "block" (a block per row, any dk) and
# "rows" (a warp per row; dk a multiple of 8 in 16-byte rows).
# :func:`weights_form` takes "rows" wherever it runs, the faster form at the
# bsp2 path's shape on the card (PERF.md section 6).
WEIGHTS_FORMS = ("block", "rows")
# The CUDA sources of the port (csrc/<name>.cu); adamw.cu is the
# optimizer's (ops/adamw.py), attfuse.cu AttFuse's (ops/attfuse.py).
SOURCES = ("bsp_fused_attention", "bsp_sddmm", "bsp_spmm", "bsp_spmm_t",
           "bsp_fused_parts", "bsp_weights", "ell_max", "ell_softmax",
           "block_attention", "adamw", "attfuse")
# Launch counts by wrapper: name -> (module of mrp_gnn_tpu_torch.ops,
# wrapper). ell_spmm and ell_sddmm launch bsp_spmm.cu and bsp_sddmm.cu, and
# count apart from bsp_spmm and bsp_sddmm; bsp_spmm_t2 is the dual form of
# bsp_spmm_t.cu, counted apart from bsp_spmm_t; adamw_grad_norm and
# adamw_update are the two entry points of adamw.cu; attfuse_graph,
# attfuse_forward and attfuse_backward (two launches a call) those of
# attfuse.cu.
_WRAPPERS = {
    "bsp_fused_attention": ("bsp", "fused_attention"),
    "bsp_weights": ("bsp", "attention_weights"),
    "bsp_sddmm": ("bsp", "sddmm"),
    "bsp_spmm": ("bsp", "spmm"),
    "bsp_spmm_t": ("bsp", "spmm_t"),
    "bsp_spmm_t2": ("bsp", "spmm_t2"),
    "bsp_fused_parts": ("bsp", "fused_attention_parts"),
    "ell_max": ("ell", "masked_max"),
    "ell_sddmm": ("ell", "sddmm"),
    "ell_softmax": ("ell", "softmax"),
    "ell_spmm": ("ell", "spmm"),
    "block_attention": ("edge", "block_attention"),
    "adamw_grad_norm": ("adamw", "grad_norm"),
    "adamw_update": ("adamw", "adamw_update"),
    "attfuse_graph": ("attfuse", "graph_masks"),
    "attfuse_forward": ("attfuse", "forward"),
    "attfuse_backward": ("attfuse", "backward"),
}
KERNELS = tuple(_WRAPPERS)
_VALUE_TYPES = (torch.float32, torch.bfloat16)
# The forward ops of ``ops/library.py`` (registered when the ops package is
# imported), through which the autograd Functions launch their forwards.
_OPS = torch.ops.mrp_gnn_torch


def supports(graph) -> bool:
    """True when the batch carries a tile-pair plan within the 128-column
    degree cap: the same test as the JAX package's ``pallas_bsp.supports``."""
    return (graph.bsp_tile > 0 and graph.ell_src is not None
            and graph.bsp_pair_dst is not None
            and graph.ell_src.shape[1] <= MAX_DEGREE)


def supports_expanded(graph) -> bool:
    """True when the batch carries a row-expanded high-degree plan."""
    return (graph.bsp_tile > 0 and graph.ell_src is not None
            and graph.bsp_expanded is not None)


def _expand_rows(x: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """Row-major [V, deg] -> [V * rows, width], zero / False padded: the
    layout ``graph.build_expanded_bsp`` derives its plan from."""
    pad = rows * width - x.shape[1]
    return torch.nn.functional.pad(x, (0, pad)).reshape(-1, width)


def expand_ell_view(ell_src: torch.Tensor, ell_mask: torch.Tensor,
                    rows: int, width: int) -> tuple:
    """The [V * rows, width] view of an ELL layout (contiguous copies; pad
    columns are mask-False): node v's slots split over expanded rows
    v * rows .. v * rows + rows - 1."""
    return _expand_rows(ell_src, rows, width), _expand_rows(ell_mask, rows,
                                                            width)


# --- plain torch versions ----------------------------------------------------


def masked_softmax(logits: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over each row's valid slots, with the JAX package's guards:
    the max is floored at _NEG / 2 and a row with no valid slot gives 0."""
    x = torch.where(ell_mask, logits, _NEG)
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.where(ell_mask, torch.exp(x - torch.clamp(m, min=_NEG / 2)), 0.0)
    den = e.sum(-1, keepdim=True)
    return torch.where(den > 0, e / torch.clamp(den, min=1e-30), 0.0)


def fused_attention_reference(q_s: torch.Tensor, k: torch.Tensor,
                              values: torch.Tensor, ell_src: torch.Tensor,
                              ell_mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the fused kernel, on the kernel's inputs.

    q_s: f32 [V, dk], already scaled by 1/sqrt(dk); k: f32 [V, dk];
    values: [V, D]; ell_src int32 / ell_mask bool [V, deg]. Returns
    [V, D] in the values dtype, summed in f32.
    """
    src = ell_src.long()
    logits = torch.einsum("vd,vjd->vj", q_s, k[src])
    alpha = masked_softmax(logits, ell_mask)
    out = torch.einsum("vj,vjd->vd", alpha, values[src].float())
    return out.to(values.dtype)


def attention_weights_reference(q_s: torch.Tensor, k: torch.Tensor,
                                ell_src: torch.Tensor,
                                ell_mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the weights kernel: alpha f32 [V, deg], the
    masked softmax over each row's slots of <q_s[v], k[ell_src[v, j]]>.
    q_s f32 [V, dk], already scaled by 1/sqrt(dk); k f32 [Vs, dk]."""
    logits = torch.einsum("vd,vjd->vj", q_s, k[ell_src.long()])
    return masked_softmax(logits, ell_mask)


def sddmm_reference(a: torch.Tensor, b: torch.Tensor, ell_src: torch.Tensor,
                    ell_mask: torch.Tensor) -> torch.Tensor:
    """out[v, j] = <a[v], b[ell_src[v, j]]> in f32; 0 on masked slots."""
    out = torch.einsum("vd,vjd->vj", a.float(), b.float()[ell_src.long()])
    return torch.where(ell_mask, out, 0.0)


def spmm_reference(w: torch.Tensor, x: torch.Tensor, ell_src: torch.Tensor,
                   ell_mask: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over valid j of w[v, j] * x[ell_src[v, j]], summed in
    f32, in x's dtype."""
    wm = torch.where(ell_mask, w.float(), 0.0)
    out = torch.einsum("vj,vjd->vd", wm, x.float()[ell_src.long()])
    return out.to(x.dtype)


def spmm_t_reference(w: torch.Tensor, x: torch.Tensor, ell_src: torch.Tensor,
                     ell_mask: torch.Tensor, num_rows: int,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[s] = sum over valid (v, j) with ell_src[v, j] = s of
    w[v, j] * x[v]: [num_rows, D], summed in f32, in ``out_dtype``
    (default x's dtype)."""
    V, deg = ell_src.shape
    rows = torch.arange(V, device=x.device)[:, None].expand(V, deg)[ell_mask]
    contrib = w.float()[ell_mask][:, None] * x.float()[rows]
    out = torch.zeros(num_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, ell_src[ell_mask].long(), contrib)
    return out.to(out_dtype or x.dtype)


def source_view(ell_src: torch.Tensor, ell_mask: torch.Tensor,
                num_rows: int) -> tuple:
    """Source-major view of the valid slots, built on the tensors' device.

    Returns (offsets int32 [num_rows + 1], slots int32 [V * deg]): the
    valid slots naming source s are ``slots[offsets[s]:offsets[s + 1]]``,
    each ``v * deg + j``, in (v, j) order (a stable sort). Entries past
    ``offsets[-1]`` are the masked slots; the kernel never reads them.
    """
    key = torch.where(ell_mask, ell_src, num_rows).flatten()
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_rows + 1, device=key.device, dtype=key.dtype)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return offsets, order.to(torch.int32)


# --- kernel wrappers ---------------------------------------------------------


def tiled_form(V: int, Vs: int, deg: int) -> bool:
    """The form rule of the SDDMM, transposed SpMM and high-degree forward
    kernels, on the ELL shape alone (no host sync, and the same form for the
    single and the dual launch): the tiled form, dense blocks per
    (destination tile, source tile) pair, from an ELL width of
    TILED_MIN_DEG and while a dense [V, Vs] weight matrix fits
    TILED_MAX_DENSE elements; the per-edge form below it, where a 64 x 64
    block would be mostly empty (the transposed SpMM's per-edge side is
    :func:`spmm_t_form`'s). PERF.md section 6 gives the crossover measured
    on the card."""
    return deg >= TILED_MIN_DEG and V * Vs <= TILED_MAX_DENSE


def spmm_t_form(V: int, Vs: int, deg: int, aligned: bool = True,
                form: str | None = None) -> int:
    """The index in SPMM_T_FORMS of the transposed SpMM's form for a launch
    over ELL lists [V, deg] into Vs output rows, on the shape alone (no
    host sync; the single and the dual launch take the same form).
    ``aligned``: ell_src and ell_mask start on 16 bytes, as the staged
    form's loads need. ``form`` None takes "tiled" where
    :func:`tiled_form` does, else "staged" up to STAGED_MAX_NODES
    destination and source nodes and an ELL width of STAGED_MAX_DEG (past
    them each of its blocks reads an index that grows with V, or its chains
    grow with the width, and the per-edge form was faster on the card),
    else "per-edge"; a name of SPMM_T_FORMS forces that form (the card's
    checks and A/B). Raises ValueError for an unknown form, or "staged" on
    operands that are not aligned."""
    if form is None:
        if tiled_form(V, Vs, deg):
            form = "tiled"
        elif (aligned and max(V, Vs) <= STAGED_MAX_NODES
              and deg <= STAGED_MAX_DEG):
            form = "staged"
        else:
            form = "per-edge"
    if form not in SPMM_T_FORMS:
        raise ValueError(f"unknown transposed SpMM form {form!r}; one of "
                         f"{SPMM_T_FORMS}")
    if form == "staged" and not aligned:
        raise ValueError("the staged form needs ell_src and ell_mask "
                         "16-byte aligned")
    return SPMM_T_FORMS.index(form)


def tile_pairs(ell_src: torch.Tensor, ell_mask: torch.Tensor) -> torch.Tensor:
    """The (destination tile, source tile) pairs of TILE nodes that hold a
    valid slot, int64 [P, 2] in (dt, st) order: the blocks of work of the
    tiled forms, whose kernels flag the same pairs on the device (plain
    torch, for the tests and the timings' fill)."""
    rows = torch.arange(ell_src.shape[0], device=ell_src.device)[:, None]
    dt = rows.expand_as(ell_src)[ell_mask] // TILE
    st = ell_src[ell_mask].long() // TILE
    return torch.unique(torch.stack([dt, st], dim=1), dim=0)


def _scratch(source: str, *args) -> int:
    """Bytes of scratch for the tiled form of ``csrc/<source>.cu``, as its
    ``<source>_scratch`` entry counts them."""
    fn = getattr(_build.load(source), f"{source}_scratch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_longlong
    return int(fn(*args))


def _aligned16(*tensors) -> bool:
    """Every tensor starts on 16 bytes (the staged transposed SpMM reads
    ell_src and ell_mask 16 and 4 bytes at a time)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _vec8(*tensors) -> bool:
    """16-byte loads: every row a multiple of 8 elements, 16-byte aligned."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


def _check_cuda(kernel: str, ell_src, ell_mask,
                max_deg: int | None = MAX_DEGREE, **tensors) -> None:
    """Device, layout and index checks shared by the wrappers; ELL widths
    past ``max_deg`` raise (None: any width)."""
    dev = ell_src.device
    if dev.type != "cuda":
        raise RuntimeError(f"no {kernel} kernel for {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ell_src on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ell_mask.device != dev:
        raise ValueError(f"ell_mask is on {ell_mask.device}, ell_src on {dev}")
    if ell_src.dtype != torch.int32 or ell_mask.dtype != torch.bool:
        raise TypeError("ell_src must be int32 and ell_mask bool")
    if ell_src.dim() != 2 or ell_mask.shape != ell_src.shape:
        raise ValueError(f"ell_src {tuple(ell_src.shape)} and ell_mask "
                         f"{tuple(ell_mask.shape)} must be one [V, deg] shape")
    if not (ell_src.is_contiguous() and ell_mask.is_contiguous()):
        raise ValueError("ell_src and ell_mask must be contiguous")
    if max_deg is not None and ell_src.shape[1] > max_deg:
        raise ValueError(f"{kernel} takes deg <= {max_deg}, got "
                         f"{ell_src.shape[1]}")


def _check_cuda_inputs(q, k, values, ell_src, ell_mask,
                       kernel: str = _KERNEL,
                       max_deg: int | None = MAX_DEGREE) -> None:
    """Checks of the fused kernels: q [V, dk] with one row per ELL row; k
    [Vs, dk] and values [Vs, D] with one row per source (Vs = V for the
    square kernel, which takes q_s and k of one shape)."""
    if values.device.type != "cuda":
        what = "fused attention" if kernel == _KERNEL else kernel
        raise RuntimeError(f"no {what} kernel for {values.device}")
    _check_cuda(kernel, ell_src, ell_mask, max_deg, q=q, k=k, values=values)
    if q.dtype != torch.float32 or k.dtype != torch.float32:
        raise TypeError("q and k must be float32")
    if values.dtype not in _VALUE_TYPES:
        raise TypeError(f"values must be float32 or bfloat16, got {values.dtype}")
    rows = ell_src.shape[0] if kernel == _KERNEL else k.shape[0]
    if (q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]
            or q.shape[0] != ell_src.shape[0] or k.shape[0] != rows
            or values.dim() != 2 or values.shape[0] != rows):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"values {tuple(values.shape)}, ell_src {tuple(ell_src.shape)}")
    if q.shape[1] > MAX_DK:
        raise ValueError(f"kernel takes dk <= {MAX_DK}, got {q.shape[1]}")


def _fused_vec(values: torch.Tensor, out: torch.Tensor) -> int:
    """Features per thread of the fused kernels: 16-byte loads of values
    where D and both row starts allow, else 1."""
    per16 = 8 if values.dtype == torch.bfloat16 else 4
    return per16 if (values.shape[1] % per16 == 0
                     and values.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0) else 1


def fused_form(vec: int, bf16: bool, form: str | None = None) -> int:
    """The index in ``csrc/bsp_fused_attention.cu`` of the fused forward's
    form for a launch with ``vec`` features per load (:func:`_fused_vec`)
    and f32 (``bf16`` False) or bf16 values: ``form`` None takes "vec" for
    f32 values in 16-byte rows and "row" otherwise; a name of FUSED_FORMS
    forces that form (the card's A/B). Raises ValueError for an unknown
    form, or a form other than "row" at vec 1."""
    if form is None:
        form = "vec" if vec > 1 and not bf16 else "row"
    if form not in FUSED_FORMS:
        raise ValueError(f"unknown fused form {form!r}; one of {FUSED_FORMS}")
    if form != "row" and vec == 1:
        raise ValueError(f"the {form} form needs 16-byte value rows")
    return FUSED_FORMS.index(form)


def fused_attention(q_s: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                    ell_src: torch.Tensor,
                    ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`fused_attention_reference`.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise: on a failed build,
    on inputs the kernel does not take, or on a refused launch. It computes
    no gradient itself: :class:`FusedAttention` carries the backward.
    """
    if values.device.type == "cpu":
        return fused_attention_reference(q_s, k, values, ell_src, ell_mask)
    return run_fused_attention(fused_attention, q_s, k, values, ell_src,
                               ell_mask)


def run_fused_attention(counter, q_s, k, values, ell_src, ell_mask,
                        form: str | None = None) -> torch.Tensor:
    """Check CUDA inputs and launch ``csrc/bsp_fused_attention.cu`` in the
    form :func:`fused_form` gives (``form`` forces one, for the card's A/B
    of the forms), counting the launch in ``counter.launches``:
    :func:`fused_attention` without the plain path."""
    _check_cuda_inputs(q_s, k, values, ell_src, ell_mask)
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    V, deg = ell_src.shape
    vec = _fused_vec(values, out)
    _build.run(_KERNEL, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
               + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               q_s.data_ptr(), k.data_ptr(), values.data_ptr(),
               ell_src.data_ptr(), ell_mask.data_ptr(), out.data_ptr(), V,
               deg, q_s.shape[1], values.shape[1],
               int(values.dtype == torch.bfloat16), vec,
               fused_form(vec, values.dtype == torch.bfloat16, form),
               values.device.index, _build.stream(values))
    counter.launches += 1
    return out


fused_attention.launches = 0


def fused_attention_parts_reference(q_x: torch.Tensor, k: torch.Tensor,
                                    values: torch.Tensor, src_x: torch.Tensor,
                                    mask_x: torch.Tensor) -> tuple:
    """Plain torch version of the parts kernel: per expanded row r, the raw
    online-softmax triple of the JAX package's ``_fused_parts_kernel``.

    q_x: f32 [V * R, dk], scaled by 1/sqrt(dk) and repeated R times; k f32
    [V, dk]; values [V, D]; src_x int32 / mask_x bool [V * R, W]. Returns
    (acc f32 [V * R, D], m f32 [V * R], l f32 [V * R]): m the max of the
    row's valid logits (_NEG when it has none), l and acc the sums of
    exp(logit - max(m, _NEG / 2)) and of those weights times the value rows.
    """
    src = src_x.long()
    logits = torch.einsum("vd,vjd->vj", q_x, k[src])
    x = torch.where(mask_x, logits, _NEG)
    m = x.amax(dim=-1)
    e = torch.where(mask_x, torch.exp(x - torch.clamp(m, min=_NEG / 2)[:, None]),
                    0.0)
    acc = torch.einsum("vj,vjd->vd", e, values[src].float())
    return acc, m, e.sum(-1)


def fused_attention_parts(q_x: torch.Tensor, k: torch.Tensor,
                          values: torch.Tensor, src_x: torch.Tensor,
                          mask_x: torch.Tensor) -> tuple:
    """Kernel wrapper, same contract as
    :func:`fused_attention_parts_reference` (the per-edge form of
    ``csrc/bsp_fused_parts.cu``). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. Its count also holds the launches of
    the tiled form (:func:`expanded_forward`)."""
    if values.device.type == "cpu":
        return fused_attention_parts_reference(q_x, k, values, src_x, mask_x)
    return _run_parts(fused_attention_parts, q_x, k, values, src_x, mask_x)


fused_attention_parts.launches = 0


def _run_parts(counter, q_x, k, values, src_x, mask_x) -> tuple:
    """Check CUDA inputs and launch the per-edge form of
    ``bsp_fused_parts.cu``, counting the launch in ``counter.launches``."""
    _check_cuda_inputs(q_x, k, values, src_x, mask_x, "bsp_fused_parts")
    rows, deg = src_x.shape
    acc = torch.empty(rows, values.shape[1], dtype=torch.float32,
                      device=values.device)
    m = torch.empty(rows, dtype=torch.float32, device=values.device)
    l = torch.empty_like(m)
    _launch_parts(q_x, k, values, src_x, mask_x, acc, m, l,
                  _fused_vec(values, acc), 0, None)
    counter.launches += 1
    return acc, m, l


def _launch_parts(q, k, values, ell_src, ell_mask, out, m, l, vec: int,
                  tiled: int, scratch) -> None:
    rows, deg = ell_src.shape
    _build.run("bsp_fused_parts", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
               + [ctypes.c_longlong] + [ctypes.c_int] * 4
               + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
               q.data_ptr(), k.data_ptr(), values.data_ptr(),
               ell_src.data_ptr(), ell_mask.data_ptr(), out.data_ptr(),
               m.data_ptr() if m is not None else None,
               l.data_ptr() if l is not None else None, rows, deg,
               q.shape[1], values.shape[1],
               int(values.dtype == torch.bfloat16), vec, tiled,
               values.shape[0], scratch.data_ptr() if tiled else None,
               values.device.index, _build.stream(values))


def expanded_forward_reference(q_s: torch.Tensor, k: torch.Tensor,
                               values: torch.Tensor, src_x: torch.Tensor,
                               mask_x: torch.Tensor, rows: int,
                               tiled: bool | None = None) -> torch.Tensor:
    """Plain torch version of :func:`expanded_forward` in the form given
    (None: the form :func:`tiled_form` gives): the tiled form is
    :func:`fused_attention_reference` on the node view [V, R * W] of the
    expanded lists; the per-edge form the parts' plain version on the
    expanded view, then :func:`xp_combine`."""
    V = q_s.shape[0]
    src_n, mask_n = src_x.reshape(V, -1), mask_x.reshape(V, -1)
    if tiled is None:
        tiled = tiled_form(V, k.shape[0], src_n.shape[1])
    if tiled:
        return fused_attention_reference(q_s, k, values, src_n, mask_n)
    acc, m, l = fused_attention_parts_reference(
        q_s.repeat_interleave(rows, dim=0), k, values, src_x, mask_x)
    return xp_combine(acc, m, l, V, rows, values.dtype)


def expanded_forward(q_s: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                     src_x: torch.Tensor, mask_x: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """The forward of :class:`ExpandedFusedAttention`: out [V, D] in the
    values dtype, the attention of each node over its R * W slots of the
    row-expanded view ``src_x`` / ``mask_x`` [V * R, W]. q_s f32 [V, dk],
    already scaled by 1/sqrt(dk); k f32 [Vs, dk]; values [Vs, D].

    Two forms of ``csrc/bsp_fused_parts.cu``, chosen by :func:`tiled_form`
    on the node view [V, R * W]: per-edge (the parts kernel on the expanded
    rows, then :func:`xp_combine`) and tiled (a weights kernel writes each
    node's softmax into dense 64 x 64 tiles, a tile loop sums the value
    rows). CPU tensors take the plain version of that form
    (:func:`expanded_forward_reference`); CUDA tensors launch the kernel or
    raise, counted in ``fused_attention_parts.launches``."""
    if values.device.type == "cpu":
        return expanded_forward_reference(q_s, k, values, src_x, mask_x, rows)
    return run_expanded_forward(fused_attention_parts, q_s, k, values, src_x,
                                mask_x, rows)


def run_expanded_forward(counter, q_s, k, values, src_x, mask_x, rows: int,
                         tiled: bool | None = None) -> torch.Tensor:
    """Check CUDA inputs and launch ``bsp_fused_parts.cu`` for
    :func:`expanded_forward`, counting the launch in ``counter.launches``.
    ``tiled`` None takes the form :func:`tiled_form` gives; True or False
    forces one (the card's tests of both forms)."""
    V = q_s.shape[0]
    src_n, mask_n = src_x.reshape(V, -1), mask_x.reshape(V, -1)
    if tiled is None:
        tiled = tiled_form(V, k.shape[0], src_n.shape[1])
    if not tiled:
        acc, m, l = _run_parts(counter, q_s.repeat_interleave(rows, dim=0), k,
                               values, src_x, mask_x)
        return xp_combine(acc, m, l, V, rows, values.dtype)
    _check_cuda_inputs(q_s, k, values, src_n, mask_n, "bsp_fused_parts",
                       max_deg=None)
    deg = src_n.shape[1]
    if V * deg >= 2 ** 31 or deg == 0:
        raise ValueError(f"the tiled form takes 0 < V * deg < 2^31, got "
                         f"{V} x {deg}")
    out = torch.empty(V, values.shape[1], dtype=values.dtype,
                      device=values.device)
    scratch = torch.empty(_scratch("bsp_fused_parts", V, k.shape[0], deg),
                          dtype=torch.uint8, device=values.device)
    _launch_parts(q_s, k, values, src_n, mask_n, out, None, None,
                  8 if _vec8(values, out) else 1, 1, scratch)
    counter.launches += 1
    return out


def weights_form(dk: int, aligned: bool, form: str | None = None) -> int:
    """The index in ``csrc/bsp_weights.cu`` of the attention weights' form
    for query and key rows of width dk, 16-byte aligned or not (``aligned``
    as :func:`_vec8` gives it): ``form`` None takes "rows" where dk is a
    multiple of 8 up to MAX_DK in aligned rows, "block" otherwise; a name of
    WEIGHTS_FORMS forces that form (the card's checks and A/B). Raises
    ValueError for an unknown form, or the rows form where it does not
    run."""
    rows = aligned and dk % 8 == 0 and 0 < dk <= MAX_DK
    if form is None:
        form = "rows" if rows else "block"
    if form not in WEIGHTS_FORMS:
        raise ValueError(f"unknown weights form {form!r}; one of "
                         f"{WEIGHTS_FORMS}")
    if form == "rows" and not rows:
        raise ValueError(f"the rows form needs dk a multiple of 8 up to "
                         f"{MAX_DK} in 16-byte rows, got dk {dk}"
                         f"{'' if aligned else ', unaligned'}")
    return WEIGHTS_FORMS.index(form)


def attention_weights(q_s: torch.Tensor, k: torch.Tensor,
                      ell_src: torch.Tensor,
                      ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`attention_weights_reference`
    (``csrc/bsp_weights.cu``, the TPU's ``_weights_kernel``), for ELL
    widths up to MAX_DEGREE and dk up to MAX_DK. CPU tensors take the plain
    version; CUDA tensors launch the kernel in the form :func:`weights_form`
    gives, or raise."""
    if k.device.type == "cpu":
        return attention_weights_reference(q_s, k, ell_src, ell_mask)
    return run_attention_weights(attention_weights, q_s, k, ell_src, ell_mask)


def run_attention_weights(counter, q_s, k, ell_src, ell_mask,
                          form: str | None = None, logits: bool = False):
    """Check CUDA inputs and launch ``csrc/bsp_weights.cu`` in the form
    :func:`weights_form` gives (``form`` forces one, for the card's checks
    and A/B of the forms), counting the launch in ``counter.launches``:
    :func:`attention_weights` without the plain path. ``logits`` True (the
    rows form only; a hook of the card's tests) returns (alpha, the logits
    the kernel computed, f32 [V, deg] with 0 on masked slots)."""
    _check_cuda("bsp_weights", ell_src, ell_mask, q_s=q_s, k=k)
    if q_s.dtype != torch.float32 or k.dtype != torch.float32:
        raise TypeError("q_s and k must be float32")
    V, deg = ell_src.shape
    if (q_s.dim() != 2 or k.dim() != 2 or q_s.shape[1] != k.shape[1]
            or q_s.shape[0] != V):
        raise ValueError(f"shape mismatch: q_s {tuple(q_s.shape)}, k "
                         f"{tuple(k.shape)}, ell_src {tuple(ell_src.shape)}")
    dk = q_s.shape[1]
    if not 0 < dk <= MAX_DK:
        raise ValueError(f"kernel takes 0 < dk <= {MAX_DK}, got {dk}")
    index = weights_form(dk, _vec8(q_s, k), form)
    if logits and WEIGHTS_FORMS[index] != "rows":
        raise ValueError("only the rows form returns its logits")
    alpha = torch.empty(V, deg, dtype=torch.float32, device=k.device)
    lo = torch.empty_like(alpha) if logits else None
    if alpha.numel():
        _build.run("bsp_weights", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p],
                   q_s.data_ptr(), k.data_ptr(), ell_src.data_ptr(),
                   ell_mask.data_ptr(), alpha.data_ptr(),
                   lo.data_ptr() if logits else None, V, deg, dk, index,
                   k.device.index, _build.stream(k))
        counter.launches += 1
    return (alpha, lo) if logits else alpha


attention_weights.launches = 0


def _pair_flags(a: torch.Tensor, b: torch.Tensor) -> int:
    """bsp_sddmm's operand flags: a bf16, b bf16, 16-byte loads."""
    return (int(a.dtype == torch.bfloat16) | int(b.dtype == torch.bfloat16) << 1
            | int(_vec8(a, b)) << 2)


def _check_pair(a, b, V: int) -> None:
    if a.dtype not in _VALUE_TYPES or b.dtype not in _VALUE_TYPES:
        raise TypeError(f"operands must be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[0] != V
            or a.shape[1] != b.shape[1] or a.shape[1] == 0):
        raise ValueError(f"operands {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not fit [V={V}, d] and [Vs, d] with d > 0")


def sddmm(a1: torch.Tensor, b1: torch.Tensor, ell_src: torch.Tensor,
          ell_mask: torch.Tensor, a2: torch.Tensor | None = None,
          b2: torch.Tensor | None = None):
    """Edge dot products, :func:`sddmm_reference` of (a1, b1) and, in the
    dual form (a2 and b2 given), of (a2, b2), from one kernel launch.

    Returns out1 [V, deg] f32, or (out1, out2) in the dual form.
    """
    if ell_src.device.type == "cpu":
        out1 = sddmm_reference(a1, b1, ell_src, ell_mask)
        if a2 is None:
            return out1
        return out1, sddmm_reference(a2, b2, ell_src, ell_mask)
    return run_sddmm(sddmm, a1, b1, ell_src, ell_mask, a2, b2)


sddmm.launches = 0


def run_sddmm(counter, a1, b1, ell_src, ell_mask, a2=None, b2=None,
              tiled: bool | None = None):
    """Check CUDA inputs and launch ``bsp_sddmm.cu`` (any ELL width),
    counting the launch in ``counter.launches``: :func:`sddmm` without the
    plain path. ``tiled`` None takes the form :func:`tiled_form` gives;
    True or False forces one (the card's tests of both forms)."""
    dual = a2 is not None
    pairs = dict(a1=a1, b1=b1, **(dict(a2=a2, b2=b2) if dual else {}))
    _check_cuda("bsp_sddmm", ell_src, ell_mask, max_deg=None, **pairs)
    V, deg = ell_src.shape
    Vs = b1.shape[0]
    _check_pair(a1, b1, V)
    if dual:
        _check_pair(a2, b2, V)
        if b2.shape[0] != Vs:
            raise ValueError(f"b1 and b2 must have one row count, got {Vs} "
                             f"and {b2.shape[0]}")
    out1 = torch.empty(V, deg, dtype=torch.float32, device=a1.device)
    out2 = torch.empty_like(out1) if dual else None
    if out1.numel():
        if tiled is None:
            tiled = tiled_form(V, Vs, deg)
        d2 = a2.shape[1] if dual else 0
        scratch = (torch.empty(_scratch("bsp_sddmm", V, Vs, deg, a1.shape[1],
                                        d2), dtype=torch.uint8,
                               device=a1.device) if tiled else None)
        _build.run(
            "bsp_sddmm", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p],
            a1.data_ptr(), b1.data_ptr(), a1.shape[1], _pair_flags(a1, b1),
            a2.data_ptr() if dual else None, b2.data_ptr() if dual else None,
            d2, _pair_flags(a2, b2) if dual else 0,
            ell_src.data_ptr(), ell_mask.data_ptr(), out1.data_ptr(),
            out2.data_ptr() if dual else None, V, deg, Vs, int(tiled),
            scratch.data_ptr() if tiled else None, a1.device.index,
            _build.stream(a1))
        counter.launches += 1
    return (out1, out2) if dual else out1


def spmm_form(vec: int, D: int, bf16: bool, form: str | None = None) -> int:
    """The index in ``csrc/bsp_spmm.cu`` of the SpMM's form for a launch
    with ``vec`` features per load (8: 16-byte rows, :func:`_vec8`; else
    1), feature width D and f32 (``bf16`` False) or bf16 x: ``form`` None
    takes "vec" for f32 x in 16-byte rows from a width of SPMM_VEC_MIN_D and
    "row" otherwise; a name of SPMM_FORMS forces that form (the card's
    checks and A/B). Raises ValueError for an unknown form, or the vector
    form at vec 1."""
    if form is None:
        form = ("vec" if vec == 8 and not bf16 and D >= SPMM_VEC_MIN_D
                else "row")
    if form not in SPMM_FORMS:
        raise ValueError(f"unknown SpMM form {form!r}; one of {SPMM_FORMS}")
    if form != "row" and vec != 8:
        raise ValueError(f"the {form} form needs 16-byte rows")
    return SPMM_FORMS.index(form)


def spmm(w: torch.Tensor, x: torch.Tensor, ell_src: torch.Tensor,
         ell_mask: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`spmm_reference`, any ELL
    width."""
    if x.device.type == "cpu":
        return spmm_reference(w, x, ell_src, ell_mask)
    return run_spmm(spmm, w, x, ell_src, ell_mask)


spmm.launches = 0


def run_spmm(counter, w, x, ell_src, ell_mask, form: str | None = None):
    """Check CUDA inputs and launch ``bsp_spmm.cu`` in the form
    :func:`spmm_form` gives (``form`` forces one, for the card's checks and
    A/B of the forms), counting the launch in ``counter.launches``:
    :func:`spmm` without the plain path."""
    _check_cuda("bsp_spmm", ell_src, ell_mask, max_deg=None, w=w, x=x)
    if w.dtype != torch.float32 or x.dtype not in _VALUE_TYPES:
        raise TypeError(f"w must be float32 and x float32 or bfloat16, got "
                        f"{w.dtype} and {x.dtype}")
    V, deg = ell_src.shape
    if w.shape != ell_src.shape or x.dim() != 2:
        raise ValueError(f"w {tuple(w.shape)} must match ell_src "
                         f"{tuple(ell_src.shape)} and x be [Vs, D]")
    out = torch.empty(V, x.shape[1], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = 8 if _vec8(x, out) else 1
    bf16 = x.dtype == torch.bfloat16
    _build.run("bsp_spmm", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               w.data_ptr(), x.data_ptr(), ell_src.data_ptr(),
               ell_mask.data_ptr(), out.data_ptr(), V, deg, x.shape[1],
               int(bf16), vec, spmm_form(vec, x.shape[1], bf16, form),
               x.device.index, _build.stream(x))
    counter.launches += 1
    return out


def spmm_t(w: torch.Tensor, x: torch.Tensor, ell_src: torch.Tensor,
           ell_mask: torch.Tensor, num_rows: int,
           out_dtype: torch.dtype | None = None,
           view: tuple | None = None) -> torch.Tensor:
    """Kernel wrapper, same contract as :func:`spmm_t_reference`, in the
    form :func:`spmm_t_form` gives (the staged form at the paths' ELL
    widths and sizes, which builds no view).

    ``view``: the batch's :func:`source_view`, which only the per-edge form
    walks; built here when that form runs and it is not given (the tiled
    and staged forms need none). Counted in ``spmm_t.launches``.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return spmm_t_reference(w, x, ell_src, ell_mask, num_rows, out_dtype)
    (out,) = _run_spmm_t(spmm_t, ((w, x, out_dtype),), ell_src, ell_mask,
                         num_rows, view)
    return out


spmm_t.launches = 0


def spmm_t2_reference(w1: torch.Tensor, x1: torch.Tensor, w2: torch.Tensor,
                      x2: torch.Tensor, ell_src: torch.Tensor,
                      ell_mask: torch.Tensor, num_rows: int,
                      out1_dtype: torch.dtype | None = None,
                      out2_dtype: torch.dtype | None = None) -> tuple:
    """(spmm_t_reference of (w1, x1), spmm_t_reference of (w2, x2)): the
    plain version of the dual transposed SpMM."""
    return (spmm_t_reference(w1, x1, ell_src, ell_mask, num_rows, out1_dtype),
            spmm_t_reference(w2, x2, ell_src, ell_mask, num_rows, out2_dtype))


def spmm_t2(w1: torch.Tensor, x1: torch.Tensor, w2: torch.Tensor,
            x2: torch.Tensor, ell_src: torch.Tensor, ell_mask: torch.Tensor,
            num_rows: int, out1_dtype: torch.dtype | None = None,
            out2_dtype: torch.dtype | None = None,
            view: tuple | None = None) -> tuple:
    """Kernel wrapper, same contract as :func:`spmm_t2_reference`: both
    transposed SpMMs from one launch of the dual form of
    ``csrc/bsp_spmm_t.cu`` (the TPU's ``_spmm_t2_kernel``), in the form
    :func:`spmm_t_form` gives (over one :func:`source_view` where the
    per-edge form runs). x1 and x2 may differ in width and dtype. On CUDA
    each output has the bits of a single :func:`spmm_t` launch (both take
    the same form); counted in ``spmm_t2.launches``, apart from
    :func:`spmm_t`."""
    out1_dtype = out1_dtype or x1.dtype
    out2_dtype = out2_dtype or x2.dtype
    if x1.device.type == "cpu":
        return spmm_t2_reference(w1, x1, w2, x2, ell_src, ell_mask, num_rows,
                                 out1_dtype, out2_dtype)
    return _run_spmm_t(spmm_t2, ((w1, x1, out1_dtype), (w2, x2, out2_dtype)),
                       ell_src, ell_mask, num_rows, view)


spmm_t2.launches = 0


def _spmm_t_flags(x: torch.Tensor, out: torch.Tensor) -> int:
    """bsp_spmm_t's flags of one operand pair: x bf16, out bf16, 16-byte
    loads."""
    return (int(x.dtype == torch.bfloat16) | int(out.dtype == torch.bfloat16) << 1
            | int(_vec8(x, out)) << 2)


def _run_spmm_t(counter, pairs, ell_src, ell_mask, num_rows: int,
                view, form: str | None = None) -> list:
    """Check CUDA inputs and launch ``bsp_spmm_t.cu`` (any ELL width) for
    one (w, x, out_dtype) pair or two, counting the launch in
    ``counter.launches``. ``form`` None takes the form :func:`spmm_t_form`
    gives; a name of SPMM_T_FORMS forces one (the card's tests and A/B of
    the forms)."""
    tensors = {}
    for i, (w, x, _) in enumerate(pairs, 1):
        tensors.update({f"w{i}": w, f"x{i}": x})
    _check_cuda("bsp_spmm_t", ell_src, ell_mask, max_deg=None, **tensors)
    V, deg = ell_src.shape
    for w, x, out_dtype in pairs:
        if (w.dtype != torch.float32 or x.dtype not in _VALUE_TYPES
                or out_dtype not in _VALUE_TYPES):
            raise TypeError(f"w must be float32, x and out float32 or "
                            f"bfloat16, got {w.dtype}, {x.dtype} and "
                            f"{out_dtype}")
        if w.shape != ell_src.shape or x.dim() != 2 or x.shape[0] != V:
            raise ValueError(f"w {tuple(w.shape)} must match ell_src "
                             f"{tuple(ell_src.shape)} and x be [V, D]")
    if V * deg >= 2 ** 31:
        raise ValueError("the slot index v * deg + j must fit in int32")
    outs = [torch.empty(num_rows, x.shape[1], dtype=dt, device=x.device)
            for _, x, dt in pairs]
    if any(o.numel() == 0 for o in outs):
        if num_rows and len(pairs) > 1:
            raise ValueError("the dual form takes operands of nonzero width")
        return outs
    if V * deg == 0:
        return [o.zero_() for o in outs]
    index = spmm_t_form(V, num_rows, deg, _aligned16(ell_src, ell_mask),
                        form)
    x = pairs[0][1]
    offsets = slots = scratch = None
    if SPMM_T_FORMS[index] == "tiled":
        scratch = torch.empty(_scratch("bsp_spmm_t", V, num_rows,
                                       int(len(pairs) > 1)),
                              dtype=torch.uint8, device=x.device)
    elif SPMM_T_FORMS[index] == "per-edge":
        offsets, slots = view if view is not None else source_view(
            ell_src, ell_mask, num_rows)
        if offsets.shape != (num_rows + 1,) or slots.shape != (V * deg,):
            raise ValueError("view does not fit this batch and num_rows")
        offsets, slots = offsets.data_ptr(), slots.data_ptr()
    args = []
    for (w, x_i, _), out in zip(pairs, outs):
        args += [w.data_ptr(), x_i.data_ptr(), out.data_ptr(), x_i.shape[1],
                 _spmm_t_flags(x_i, out)]
    if len(pairs) == 1:
        args += [None, None, None, 0, 0]
    _build.run("bsp_spmm_t",
               ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]) * 2
               + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
               *args, offsets, slots, ell_src.data_ptr(), ell_mask.data_ptr(),
               V, num_rows, deg, index,
               None if scratch is None else scratch.data_ptr(),
               x.device.index, _build.stream(x))
    counter.launches += 1
    return outs


def _wrapper(name: str):
    """The wrapper counted under ``name``, looked up at call time, so a
    wrapper replaced on its module is the one counted."""
    module, attr = _WRAPPERS[name]
    return getattr(importlib.import_module(f"mrp_gnn_tpu_torch.ops.{module}"),
                   attr)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for name in KERNELS:
        _wrapper(name).launches = 0


def launch_counts() -> dict:
    """Launch count of each kernel wrapper, by its name in KERNELS."""
    return {name: _wrapper(name).launches for name in KERNELS}


# --- autograd ------------------------------------------------------------------


def _softmax_bwd(alpha: torch.Tensor, g: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """dlogits of a masked row softmax: alpha * (g - sum_j alpha_j g_j),
    0 on masked slots (plain torch; the JAX package's is XLA)."""
    dlog = alpha * (g - (alpha * g).sum(-1, keepdim=True))
    return torch.where(mask, dlog, 0.0)


def fused_attention_backward(q_s, k, values, ell_src, ell_mask, g) -> tuple:
    """(dq_s, dk, dvalues) of the fused attention for the output cotangent
    ``g``, each sparse product a kernel on CUDA.

    ``ell_src``/``ell_mask`` [V, deg]: the steps of the JAX package's
    ``_bsp_fused_bwd`` (``pallas_bsp.py:865-890``). A row-expanded view
    [V * R, W] (the high-degree path): those of ``_xp_fused_bwd``
    (``:1333-1376``), the SDDMM and the transposed SpMMs on its node view
    [V, R * W] (one reshape: the same slots, pad columns mask-False), so
    they take q_s and g as they are, where JAX repeats them R times for its
    128-column kernels; each slot gets the same dot and each source the
    same sums. dq stays on the expanded view, as in JAX (rows of W slots
    are shorter chains for the per-row SpMM), summed over each node's R
    rows. dvalues and
    dk come from one :func:`spmm_t2` launch after dlog, where the JAX
    backwards run two ``_spmm_t_kernel`` sweeps; on the card it gives the
    bits of two :func:`spmm_t` launches.
    """
    V = q_s.shape[0]
    g = g.contiguous()  # may arrive as a permuted view (models/fusion.py)
    src_x, mask_x = ell_src, ell_mask
    ell_src, ell_mask = ell_src.reshape(V, -1), ell_mask.reshape(V, -1)
    logits, dalpha = sddmm(q_s, k, ell_src, ell_mask, g, values)
    alpha = masked_softmax(logits, ell_mask)
    dlog = _softmax_bwd(alpha, dalpha, ell_mask)
    dq = spmm(dlog.reshape(src_x.shape), k, src_x, mask_x)
    if src_x.shape[0] != V:
        dq = dq.reshape(V, -1, dq.shape[1]).float().sum(dim=1)
    dvalues, dk = spmm_t2(alpha, g, dlog, q_s, ell_src, ell_mask,
                          values.shape[0], values.dtype, k.dtype)
    return dq.to(q_s.dtype), dk, dvalues


class FusedAttention(torch.autograd.Function):
    """:func:`fused_attention` with its backward, the counterpart of the
    JAX package's ``_bsp_fused`` custom vjp. The forward saves only its
    inputs; the backward recomputes the logits."""

    @staticmethod
    def forward(ctx, q_s, k, values, ell_src, ell_mask):
        ctx.save_for_backward(q_s, k, values, ell_src, ell_mask)
        return _OPS.fused_attention(q_s, k, values, ell_src, ell_mask)

    @staticmethod
    def backward(ctx, g):
        grads = fused_attention_backward(*ctx.saved_tensors, g)
        return (*grads, None, None)


class BspWeights(torch.autograd.Function):
    """:func:`attention_weights` with the JAX package's ``_bsp_weights``
    custom vjp (``pallas_bsp.py:211-228``): dlog = alpha * (g - sum alpha
    g), masked, in plain torch; dq = spmm(dlog, k); dk = spmm_t(dlog, q_s).
    The forward saves alpha."""

    @staticmethod
    def forward(ctx, q_s, k, ell_src, ell_mask):
        alpha = attention_weights(q_s, k, ell_src, ell_mask)
        ctx.save_for_backward(q_s, k, ell_src, ell_mask, alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        q_s, k, ell_src, ell_mask, alpha = ctx.saved_tensors
        dlog = _softmax_bwd(alpha, g.float(), ell_mask).contiguous()
        dq = spmm(dlog, k, ell_src, ell_mask)
        dk = spmm_t(dlog, q_s, ell_src, ell_mask, k.shape[0], k.dtype)
        return dq.to(q_s.dtype), dk, None, None


def xp_combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, V: int,
               rows: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Fold each node's R expanded-row triples (:func:`fused_attention_parts`)
    into one softmax, as the JAX package's ``_xp_combine``: rows with l == 0
    (no valid slot) carry m == _NEG and weight 0; a node with none gives 0."""
    accf = acc.reshape(V, rows, -1)
    mf = m.reshape(V, rows)
    lf = l.reshape(V, rows)
    mx = torch.clamp(mf.amax(dim=1, keepdim=True), min=_NEG / 2)
    w = torch.exp(mf - mx)                                   # [V, rows]
    num = (w[..., None] * accf).sum(dim=1)                   # [V, D]
    den = (w * lf).sum(dim=1, keepdim=True)                  # [V, 1]
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                       0.0).to(out_dtype)


class ExpandedFusedAttention(torch.autograd.Function):
    """One-pass attention over the row-expanded view
    (:func:`expanded_forward`); the counterpart of the JAX package's
    ``_xp_fused`` custom vjp, whose backward recomputes the logits."""

    @staticmethod
    def forward(ctx, q_s, k, values, src_x, mask_x, rows):
        ctx.save_for_backward(q_s, k, values, src_x, mask_x)
        return _OPS.expanded_forward(q_s, k, values, src_x, mask_x, rows)

    @staticmethod
    def backward(ctx, g):
        grads = fused_attention_backward(*ctx.saved_tensors, g)
        return (*grads, None, None, None)


class WeightedAggregate(torch.autograd.Function):
    """:func:`spmm` with the JAX package's ``_bsp_spmm`` custom vjp:
    dweights = sddmm(g, values), only when the weights need a gradient, and
    dvalues = spmm_t(weights, g). Weights must be 0 on masked slots."""

    @staticmethod
    def forward(ctx, w, values, ell_src, ell_mask):
        ctx.save_for_backward(w, values, ell_src, ell_mask)
        return _OPS.spmm(w, values, ell_src, ell_mask)

    @staticmethod
    def backward(ctx, g):
        w, values, ell_src, ell_mask = ctx.saved_tensors
        g = g.contiguous()
        dw = dvalues = None
        if ctx.needs_input_grad[0]:
            dw = sddmm(g, values, ell_src, ell_mask).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dvalues = spmm_t(w, g, ell_src, ell_mask, values.shape[0],
                             values.dtype)
        return dw, dvalues, None, None


class EdgeDot(torch.autograd.Function):
    """:func:`sddmm` with the JAX package's ``_bsp_sddmm`` custom vjp:
    da = spmm(g, b), db = spmm_t(g, a)."""

    @staticmethod
    def forward(ctx, a, b, ell_src, ell_mask):
        ctx.save_for_backward(a, b, ell_src, ell_mask)
        return sddmm(a, b, ell_src, ell_mask)

    @staticmethod
    def backward(ctx, g):
        a, b, ell_src, ell_mask = ctx.saved_tensors
        g = g.contiguous()
        da = spmm(g, b, ell_src, ell_mask).to(a.dtype)
        db = spmm_t(g, a, ell_src, ell_mask, b.shape[0], b.dtype)
        return da, db, None, None


def _scaled(q: torch.Tensor, k: torch.Tensor):
    """q scaled by 1/sqrt(dk) in f32 and k cast to f32, as the JAX entry
    does before its kernel (pallas_bsp.py bsp_attention_fused)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).contiguous(), k.float().contiguous()


def bsp_attention_fused(q: torch.Tensor, k: torch.Tensor,
                        values: torch.Tensor, graph) -> torch.Tensor:
    """One-pass fused edge attention over the batch's ELL lists, with a
    gradient for q, k and values.

    Same semantics as the plain composition ell_sddmm / sqrt(dk) ->
    ell_softmax -> ell_aggregate. q/k: [V, dk]; values [V, D] f32 or bf16.
    """
    q_s, kf = _scaled(q, k)
    return FusedAttention.apply(q_s, kf, values, graph.ell_src, graph.ell_mask)


def bsp_attention(q: torch.Tensor, k: torch.Tensor, values: torch.Tensor,
                  graph) -> torch.Tensor:
    """Edge attention in the two-kernel form of the JAX package's
    ``bsp_attention``: the weights kernel emits alpha [V, deg]
    (:class:`BspWeights`), then the SpMM aggregates the values
    (:class:`WeightedAggregate`, the ``_bsp_spmm`` vjp). Same semantics as
    :func:`bsp_attention_fused`, for ELL widths up to MAX_DEGREE."""
    q_s, kf = _scaled(q, k)
    alpha = BspWeights.apply(q_s, kf, graph.ell_src, graph.ell_mask)
    return bsp_weighted_aggregate(alpha, values, graph)


def with_bsp_attention(ops):
    """A copy of the ``EdgeOps`` ``ops`` whose ELL attention takes the
    two-kernel form :func:`bsp_attention` on batches with a tile-pair plan
    (:func:`supports`) and ``ops``' own ELL attention otherwise. Dispatch
    keeps the fused kernel, as the JAX package does."""
    inner = ops.ell_attention

    def ell_attention(q, k, values, graph):
        if supports(graph):
            return bsp_attention(q, k, values, graph)
        return inner(q, k, values, graph)

    return dataclasses.replace(ops, ell_attention=ell_attention)


def bsp_attention_fused_reference(q: torch.Tensor, k: torch.Tensor,
                                  values: torch.Tensor, graph) -> torch.Tensor:
    """Plain torch version of :func:`bsp_attention_fused` (and of
    :func:`expanded_attention_fused`, which has the same semantics), on
    any device and ELL width; torch's autograd differentiates it."""
    q_s, kf = _scaled(q, k)
    return fused_attention_reference(q_s, kf, values, graph.ell_src,
                                     graph.ell_mask)


def bsp_weighted_aggregate(weights: torch.Tensor, values: torch.Tensor,
                           graph) -> torch.Tensor:
    """out[v] = sum_j weights[v, j] * values[ell_src[v, j]], with gradients
    for both. weights must already be 0 on masked slots (a softmax output,
    or mask / deg for mean aggregation)."""
    return WeightedAggregate.apply(weights.float(), values.contiguous(),
                                   graph.ell_src, graph.ell_mask)


def _mean_weights(ell_mask: torch.Tensor) -> torch.Tensor:
    maskf = ell_mask.float()
    return maskf / torch.clamp(maskf.sum(dim=1, keepdim=True), min=1.0)


def bsp_mean(values: torch.Tensor, graph) -> torch.Tensor:
    """Mean aggregation over in-neighbours through the SpMM kernel."""
    return bsp_weighted_aggregate(_mean_weights(graph.ell_mask), values, graph)


# --- high degree: the row-expanded view ---------------------------------------


def _expand_graph(graph) -> tuple:
    xp = graph.bsp_expanded
    return (*expand_ell_view(graph.ell_src, graph.ell_mask, xp.rows, xp.width),
            xp.rows, xp.width)


def xp_weighted_aggregate(weights: torch.Tensor, values: torch.Tensor,
                          ell_src: torch.Tensor, ell_mask: torch.Tensor,
                          rows: int, width: int) -> torch.Tensor:
    """:func:`bsp_weighted_aggregate` over the [V * rows, width] view of a
    wide ELL layout: the SpMM of each expanded row, then the sum of each
    node's R partials in f32. weights [V, deg], 0 on masked slots."""
    V = ell_src.shape[0]
    src_x, mask_x = expand_ell_view(ell_src, ell_mask, rows, width)
    w_x = _expand_rows(weights.float(), rows, width)
    out_x = WeightedAggregate.apply(w_x, values.contiguous(), src_x, mask_x)
    return out_x.reshape(V, rows, -1).float().sum(dim=1).to(values.dtype)


def expanded_weighted_aggregate(weights: torch.Tensor, values: torch.Tensor,
                                graph) -> torch.Tensor:
    """:func:`xp_weighted_aggregate` on the batch's expanded plan."""
    xp = graph.bsp_expanded
    return xp_weighted_aggregate(weights, values, graph.ell_src,
                                 graph.ell_mask, xp.rows, xp.width)


def expanded_mean(values: torch.Tensor, graph) -> torch.Tensor:
    """Mean aggregation for ELL widths past 128."""
    return expanded_weighted_aggregate(_mean_weights(graph.ell_mask), values,
                                       graph)


def expanded_attention(q: torch.Tensor, k: torch.Tensor,
                       values: torch.Tensor, graph) -> torch.Tensor:
    """Edge attention for ELL widths past 128 in two sweeps, as the JAX
    package's ``expanded_attention``: the SDDMM of each expanded row, the
    masked softmax on the logits folded to [V, R * W], the SpMM, then the
    sum of each node's R partials. Same semantics as
    :func:`expanded_attention_fused`, differentiable through
    :class:`EdgeDot` and :class:`WeightedAggregate`."""
    src_x, mask_x, rows, width = _expand_graph(graph)
    V = q.shape[0]
    q_s, kf = _scaled(q, k)
    logits = EdgeDot.apply(q_s.repeat_interleave(rows, dim=0), kf, src_x,
                           mask_x).reshape(V, rows * width)
    alpha = R.ell_softmax(logits, mask_x.reshape(V, rows * width))
    out_x = WeightedAggregate.apply(alpha.reshape(-1, width),
                                    values.contiguous(), src_x, mask_x)
    return out_x.reshape(V, rows, -1).float().sum(dim=1).to(values.dtype)


def expanded_attention_fused(q: torch.Tensor, k: torch.Tensor,
                             values: torch.Tensor, graph) -> torch.Tensor:
    """One-pass edge attention for ELL widths past 128 (the dispatch path):
    :func:`expanded_forward` over the expanded view, with a gradient for q,
    k and values. Same semantics as :func:`bsp_attention_fused`."""
    src_x, mask_x, rows, _ = _expand_graph(graph)
    q_s, kf = _scaled(q, k)
    return ExpandedFusedAttention.apply(q_s, kf, values.contiguous(), src_x,
                                        mask_x, rows)
