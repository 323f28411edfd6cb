"""Debug-mode utilities: NaN trapping, checked calls and graph validation
(port of ``mrp_gnn_tpu/utils/debug.py``).

- enable_debug() / disable_debug(): autograd's anomaly mode on and off
  (``torch.autograd.set_detect_anomaly``), which raises at the backward op
  that produced a NaN and names the forward op behind it: the port's
  counterpart of ``jax_debug_nans``;
- checked(fn): the counterpart of checkify's float and index checks, on a
  ``TorchDispatchMode``: every aten op that ``fn`` dispatches (autograd's
  backward included) is checked for a NaN output, an integer division by
  zero and an out-of-range index, and the call raises after ``fn`` returns;
- validate_graph(graph): host-side structural checks of a GraphBatch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# Ops whose output is memory they did not write: a NaN there is no op's.
_UNWRITTEN = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.empty_permuted, aten.new_empty, aten.new_empty_strided,
              aten.resize_, aten.resize_as_, aten.set_}
# Integer division and remainder: the divisor is the second argument.
_DIVISIONS = {aten.floor_divide, aten.floor_divide_, aten.remainder,
              aten.remainder_, aten.fmod, aten.fmod_, aten.div, aten.div_}
# (self, dim, index) indexing: whether a negative index counts from the end.
_DIM_INDEXED = {aten.index_select: False, aten.gather: False,
                aten.index_add: False, aten.index_add_: False,
                aten.index_copy: False, aten.index_copy_: False,
                aten.index_fill: True, aten.index_fill_: True,
                aten.scatter: False, aten.scatter_: False,
                aten.scatter_add: False, aten.scatter_add_: False,
                aten.scatter_reduce: False, aten.scatter_reduce_: False}
# self[indices]-style indexing, negatives counting from the end.
_ADVANCED = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_, aten._unsafe_index,
             aten._unsafe_index_put}
_ERRORS = {"nan": (FloatingPointError, "produced a NaN"),
           "div": (ZeroDivisionError, "divided an integer by zero"),
           "index": (IndexError, "indexed out of range")}


def _integral(x) -> bool:
    dtype = x.dtype if torch.is_tensor(x) else torch.tensor(x).dtype
    return not (dtype.is_floating_point or dtype.is_complex)


class _Checks(TorchDispatchMode):
    """Runs each op as it is (with a safe index or divisor where one is
    bad), and records a device-side flag per check, read once at the end:
    no host sync until :meth:`throw`, and no device-side assert, which
    would leave the CUDA context unusable."""

    def __init__(self):
        super().__init__()
        self.flags, self.what = [], []  # per check: a bool tensor, (kind, op)

    def _record(self, flag: torch.Tensor, kind: str, func) -> None:
        self.flags.append(flag)
        self.what.append((kind, str(func)))

    def _safe_index(self, idx, n: int, negative: bool, func):
        """``idx`` with its out-of-range entries set to 0, after recording
        whether there were any (an empty dimension cannot be made safe:
        the error is known on the host, and raised now)."""
        if idx is None or not torch.is_tensor(idx) or not _integral(idx) \
                or idx.dtype == torch.bool or idx.numel() == 0:
            return idx
        if n == 0:
            self._record(torch.ones((), dtype=torch.bool), "index", func)
            self.throw()
        bad = (idx >= n) | (idx < (-n if negative else 0))
        self._record(bad.any(), "index", func)
        return torch.where(bad, torch.zeros_like(idx), idx)

    def _check_args(self, func, args: list, kwargs: dict) -> None:
        packet = func.overloadpacket
        if packet in _DIM_INDEXED:
            self_, dim = args[0], args[1]
            if isinstance(dim, int) and len(args) > 2:
                n = self_.shape[dim] if self_.dim() else 1
                args[2] = self._safe_index(args[2], n, _DIM_INDEXED[packet],
                                           func)
        elif packet is aten.take:
            args[1] = self._safe_index(args[1], args[0].numel(), True, func)
        elif packet is aten.embedding:
            args[1] = self._safe_index(args[1], args[0].shape[0], False, func)
        elif packet in _ADVANCED:
            self_, dim, out = args[0], 0, []
            for idx in args[1]:
                if torch.is_tensor(idx) and idx.dtype in (torch.bool,
                                                          torch.uint8):
                    out.append(idx)
                    dim += idx.dim()
                    continue
                out.append(self._safe_index(idx, self_.shape[dim], True, func)
                           if idx is not None else None)
                dim += 1
            args[1] = out
        elif packet in _DIVISIONS and len(args) > 1:
            if packet in (aten.div, aten.div_) and \
                    kwargs.get("rounding_mode") is None:
                return  # true division: a float result
            if not (_integral(args[0]) and _integral(args[1])):
                return
            d = args[1]
            if torch.is_tensor(d):
                zero = d == 0
                self._record(zero.any(), "div", func)
                args[1] = torch.where(zero, torch.ones_like(d), d)
            elif d == 0:
                self._record(torch.ones((), dtype=torch.bool), "div", func)
                args[1] = 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = list(args), dict(kwargs or {})
        self._check_args(func, args, kwargs)
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _UNWRITTEN:
            for t in tree_leaves(out):
                if torch.is_tensor(t) and (t.is_floating_point()
                                           or t.is_complex()):
                    self._record(torch.isnan(t).any(), "nan", func)
        return out

    def throw(self) -> None:
        """Raise for the first failed check, if any: one host read of the
        flags per device."""
        by_device = {}
        for i, f in enumerate(self.flags):
            by_device.setdefault(f.device, []).append(i)
        first = []
        for order in by_device.values():
            stacked = torch.stack([self.flags[i] for i in order])
            j = int(torch.where(stacked.any(), stacked.to(torch.uint8).argmax(),
                                -1))
            if j >= 0:
                first.append(order[j])
        if first:
            i = min(first)
            kind, op = self.what[i]
            exc, says = _ERRORS[kind]
            raise exc(f"checked: {op} {says} (check {i + 1} of "
                      f"{len(self.flags)})")


def checked(fn: Callable) -> Callable:
    """Wrap fn so that the returned callable raises on a NaN, an integer
    division by zero or an out-of-range index in any op that ``fn`` runs,
    as checkify's float and index checks do.

    Usage: terms = checked(train_step)(state, images, depth, seg, graph)

    The call runs ``fn`` to its end under a ``TorchDispatchMode``, then
    raises for the first op that failed a check: FloatingPointError for a
    float output holding a NaN (whatever the op's inputs held, as
    checkify's NaN check), ZeroDivisionError for an integer division or
    remainder by zero, IndexError for an out-of-range index in
    ``index_select``, ``gather``, ``take``, ``embedding``, advanced
    indexing (``index``, ``index_put``) and ``index_add`` / ``copy`` /
    ``fill`` and ``scatter*``. Where checkify's division check differs, the
    ops follow torch's own CPU kernels: a float division by zero gives an
    IEEE inf (any NaN it leads to is caught as a NaN), and an integer
    remainder by zero raises. A bad index or divisor is swapped for a safe
    one before the op runs, so a CUDA kernel never asserts and the card
    stays usable after the raise. The flags stay on the device until the
    end: one host read per device, at the end of the call.

    With no error, the results are bit for bit those of ``fn`` alone: the
    checks only read the ops' outputs. Autograd's backward inside ``fn``
    is checked too (the mode reaches the engine's ops). Kernels launched
    through ctypes (the autograd Functions of ``ops/bsp.py``, ``ell.py``,
    ``edge.py``) are not dispatched ops: a NaN one of them writes is caught
    at the first checked op whose output it reaches. The forward kernels
    of ``ops/library.py`` are custom ops and are checked themselves.
    """

    def run(*args, **kw):
        mode = _Checks()
        with mode:
            out = fn(*args, **kw)
        mode.throw()
        return out

    return run


def enable_debug() -> None:
    torch.autograd.set_detect_anomaly(True)


def disable_debug() -> None:
    torch.autograd.set_detect_anomaly(False)


def validate_graph(graph) -> None:
    """Host-side GraphBatch invariants; raises AssertionError with context."""
    src = np.asarray(graph.edge_src.cpu())
    dst = np.asarray(graph.edge_dst.cpu())
    em = np.asarray(graph.edge_mask.cpu())
    nm = np.asarray(graph.node_mask.cpu())
    V = graph.max_nodes
    assert src.shape == dst.shape == em.shape
    assert (src >= 0).all() and (src < V).all(), "edge_src out of range"
    assert (dst >= 0).all() and (dst < V).all(), "edge_dst out of range"
    assert nm[src[em]].all(), "valid edge from padded source node"
    assert nm[dst[em]].all(), "valid edge into padded destination node"
    d = dst[em]
    assert (np.diff(d) >= 0).all(), "valid edges not dst-sorted"
    if graph.ell_src is not None:
        ell_m = np.asarray(graph.ell_mask.cpu())
        assert int(ell_m.sum()) == int(em.sum()), "ELL/edge-list edge count mismatch"
    if graph.scene_stride:
        assert V % graph.scene_stride == 0, "block stride does not tile nodes"
