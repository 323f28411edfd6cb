"""Clip by global norm and AdamW over every parameter leaf in two kernel
launches (``csrc/adamw.cu``), for ``train.AdamW.step`` on the card.

:func:`grad_norm` gives the norm of the per-leaf gradient norms, and
:func:`adamw_update` the clip and AdamW update in place (after the norm
kernel, when no norm is given), reading the norm from device memory, so
the step never waits for the host. Both kernels take every
leaf's pointers in one launch: :func:`plan` cuts the leaves into tables of
at most MAX_LEAVES leaves (a kernel parameter under 4 KB) and each leaf
into chunks of CHUNK elements, one block a chunk; one table holds a model
of up to MAX_LEAVES leaves, so a step takes one launch of each.

The plain version is the loop of ``train.AdamW`` (``loop_step``), which CPU leaves
take; these wrappers take CUDA leaves only (there is no CPU mode) and
raise on a leaf the kernels do not take (:func:`check_leaves`). Each
counts its launches in ``<wrapper>.launches``, read with the other
kernels' by ``bsp.launch_counts`` (as ``adamw_grad_norm`` and
``adamw_update``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mrp_gnn_tpu_torch.ops import _build

CHUNK = 2048          # elements a block takes (csrc/adamw.cu kChunk)
MAX_LEAVES = 64       # leaves a launch's table holds (csrc/adamw.cu kMaxLeaves)


@dataclasses.dataclass(frozen=True)
class Table:
    """The leaves [first, first + len(chunk0) - 1) of one launch; leaf
    first + i owns the launch's blocks [chunk0[i], chunk0[i + 1])."""
    first: int
    chunk0: tuple

    @property
    def count(self) -> int:
        return len(self.chunk0) - 1


def plan(numels, max_leaves: int = MAX_LEAVES) -> list:
    """The launches' tables for leaves of ``numels`` elements, in order:
    every leaf in exactly one table (a leaf of 0 elements owns no chunk),
    at most ``max_leaves`` leaves a table."""
    tables, first, chunk0 = [], 0, [0]
    for i, n in enumerate(numels):
        if len(chunk0) > max_leaves:
            tables.append(Table(first, tuple(chunk0)))
            first, chunk0 = i, [0]
        chunk0.append(chunk0[-1] - (-n // CHUNK))
    if len(chunk0) > 1:
        tables.append(Table(first, tuple(chunk0)))
    return tables


def _check(name: str, i: int, t: torch.Tensor, dev, shape=None,
           channels_last: bool = False) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"leaf {i}: the {name} is {t.dtype}; the fused "
                        "update takes float32 only")
    if t.device != dev:
        raise ValueError(f"leaf {i}: the {name} is on {t.device}, the "
                         f"leaves on {dev}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"leaf {i}: the {name} has shape {tuple(t.shape)}, "
                         f"its parameter {tuple(shape)}")
    if not (t.is_contiguous() or (channels_last and _channels_last(t)
                                  and t.numel() < 2 ** 31)):
        raise ValueError(f"leaf {i}: the {name} is not contiguous (strides "
                         f"{t.stride()})")


def _channels_last(t: torch.Tensor) -> bool:
    """``t`` is a 4-D tensor stored channels-last, as cuDNN gives a
    convolution's weight gradient over a channels-last input (the first
    convolution's: its input is the images' NHWC view)."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def check_leaves(params, grads, mu=None, nu=None) -> None:
    """Raises unless the kernels take these leaves: one gradient (and,
    unless None, one of each moment) a parameter, every tensor float32 on
    one CUDA device, each of its parameter's shape, the parameters and
    moments contiguous and each gradient contiguous or, 4-D, channels-last
    (what cuDNN gives a convolution's weight over the network's NHWC
    input). ``params`` None: ``grads`` alone, as the norm takes them."""
    leaves = grads if params is None else params
    if not leaves or any(x is not None and len(x) != len(leaves)
                         for x in (grads, mu, nu)):
        raise ValueError("one gradient and moment a parameter, at least one "
                         "leaf")
    dev = leaves[0].device
    for i, g in enumerate(grads):
        shape = None
        if params is not None:
            _check("parameter", i, params[i], dev)
            shape = params[i].shape
        _check("gradient", i, g, dev, shape, channels_last=True)
        for name, moment in (("mu", mu), ("nu", nu)):
            if moment is not None:
                _check(name, i, moment[i], dev, shape)
    if dev.type != "cuda":
        raise RuntimeError(f"no fused update kernel for {dev}")


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _layouts(grads):
    """(channels, pixels a channel) of each channels-last gradient, (0, 0)
    of each contiguous one, flat, as csrc/adamw.cu takes them."""
    for g in grads:
        if g.is_contiguous():
            yield from (0, 0)
        else:
            yield from (g.shape[1], g.shape[2] * g.shape[3])


def _table_args(table: Table, tensors) -> tuple:
    """The numels and chunk offsets of ``table`` as C arrays, and its slice
    of ``tensors``."""
    leaves = tensors[table.first:table.first + table.count]
    n = (ctypes.c_longlong * table.count)(*(t.numel() for t in leaves))
    chunk0 = (ctypes.c_int * len(table.chunk0))(*table.chunk0)
    return n, chunk0, leaves


def grad_norm(grads, ticket: torch.Tensor) -> torch.Tensor:
    """The norm of the per-leaf norms of ``grads``, a 0-d float32 tensor on
    their card, as ``vector_norm(stack([vector_norm(g) for g in grads]))``
    computes it, deterministically (no float atomics). ``ticket``: one
    int32 on that card, 0 at the call and left 0 (the caller keeps it from
    step to step). One launch for up to MAX_LEAVES leaves."""
    check_leaves(None, grads)
    return _grad_norm(grads, ticket)


def _grad_norm(grads, ticket: torch.Tensor) -> torch.Tensor:
    """:func:`grad_norm` of checked leaves."""
    dev = grads[0].device
    if (ticket.device != dev or ticket.dtype != torch.int32
            or ticket.numel() != 1):
        raise ValueError("ticket must be one int32 on the gradients' device")
    tables = plan([g.numel() for g in grads])
    blocks = [max(t.chunk0[-1], 1) for t in tables]
    # scratch: each launch's partial sums, then the leaves' norms, the norm
    total = sum(blocks)
    scratch = torch.empty(total + len(grads) + 1, dtype=torch.float32,
                          device=dev)
    base = scratch.data_ptr()
    offset = 0
    for k, (table, nblocks) in enumerate(zip(tables, blocks)):
        n, chunk0, leaves = _table_args(table, grads)
        _build.run("adamw", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p],
                   _pointers(leaves), n, chunk0, table.count, table.first,
                   len(grads), int(k == len(tables) - 1), base + 4 * offset,
                   base + 4 * total, ticket.data_ptr(),
                   base + 4 * (total + len(grads)), dev.index,
                   _build.stream(ticket), entry="adamw_grad_norm")
        grad_norm.launches += 1
        offset += nblocks
    return scratch[total + len(grads)]


grad_norm.launches = 0


def adamw_update(params, grads, mu, nu, norm: torch.Tensor | None = None, *,
                 ticket: torch.Tensor | None = None, lr: float, count: int,
                 max_norm: float, weight_decay: float, b1: float, b2: float,
                 eps: float) -> torch.Tensor:
    """Update k = ``count`` (1-based) of ``train.AdamW``, in place: the
    gradients clipped by ``norm``, then the moments and the parameters,
    with the bits of the loop of ``train.AdamW.step`` on the card. ``norm``
    (a float32 on the leaves' card, read there: no host sync) None: the
    norm kernel's, with ``ticket`` as :func:`grad_norm` takes it. Returns
    the norm. Raises, before any launch, on leaves that
    :func:`check_leaves` refuses. One launch of each kernel for up to
    MAX_LEAVES leaves."""
    check_leaves(params, grads, mu, nu)
    dev = params[0].device
    if norm is None:
        if ticket is None:
            raise ValueError("the norm kernel needs a ticket")
        norm = _grad_norm(grads, ticket)
    elif (norm.device != dev or norm.dtype != torch.float32
          or norm.numel() != 1):
        raise ValueError("norm must be one float32 on the parameters' device")
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for table in plan([p.numel() for p in params]):
        if table.chunk0[-1] == 0:
            continue
        n, chunk0, leaves = _table_args(table, params)
        sl = slice(table.first, table.first + table.count)
        cl = (ctypes.c_int * (2 * table.count))(*_layouts(grads[sl]))
        _build.run("adamw", [ctypes.c_void_p] * 7 + [ctypes.c_int,
                   ctypes.c_void_p] + [ctypes.c_double] * 8
                   + [ctypes.c_int, ctypes.c_void_p],
                   _pointers(leaves), _pointers(grads[sl]),
                   _pointers(mu[sl]), _pointers(nu[sl]), n, chunk0, cl,
                   table.count, norm.data_ptr(), max_norm, lr, b1, b2, eps,
                   weight_decay, c1, c2, dev.index, _build.stream(norm),
                   entry="adamw_update")
        adamw_update.launches += 1
    return norm


adamw_update.launches = 0
