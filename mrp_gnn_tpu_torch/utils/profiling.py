"""Profiling: the program's span recorder, and the trace exporter (port of
``mrp_gnn_tpu/utils/profiling.py``, which has the exporter).

**The recorder.** One per process, off by default. The port marks its
work where it happens with :func:`span` and :func:`count`:

- ``train.step``, around a step of ``train.make_train_step`` (it enqueues
  the work and returns without a sync), with the children
  ``train.forward`` (the model and ``total_loss``), ``train.backward``
  (``autograd.grad``) and ``train.update`` (``AdamW.step``);
- ``data.batch``, one batch of ``data.pipeline.BatchIterator`` (render and
  concatenate, on the prefetch thread), with the child ``data.graph`` (the
  ``DynamicGraphBuilder`` call); ``data.place``, ``train.BatchPlacer``
  (on the producer thread); ``data.take``, ``TransformIterator.__next__``
  (on the consumer), and the counter ``data.starved``, counted when a take
  finds the queue empty;
- ``serve.request``, around ``serving.Predictor.__call__``, with the
  children ``serve.copy_in``, ``serve.forward`` (a device span around
  enqueueing the forward), ``serve.wait`` (a wait on the forward's end)
  and ``serve.copy_out``.
- ``fusion.attfuse``, a launch span (:func:`launch_span`: the kernel's
  launcher records its events) around each launch of AttFuse's forward
  kernel (``ops/attfuse.py``; a device span around its plain forward
  elsewhere), one per fused scale; ``fusion.attfuse_backward``, the same
  around its backward's launches (its plain backward); and the counter
  ``fusion.attfuse_slots``, the (destination slot, source slot, pixel)
  triples whose logit a call computes, the real robots' own pairs left
  out (a device tensor on the card, read at the snapshot).

Off, :func:`span` returns one shared no-op context manager after one flag
test and :func:`count` returns at once: no clock read, no CUDA event, no
profiler range. On (:func:`enable`), each span keeps in memory its name,
its start and end in nanoseconds on the clock of ``torch.profiler``'s
events (the epoch clock, ``time.time_ns``), its thread's native id, its
id, the id of the span open on its thread when it began (its parent) and
of the outermost one there (its root: the spans of one step or one request
share it), the thread's CPU nanoseconds across it, and with
``device=True`` the milliseconds between two CUDA events recorded on the
current stream at its ends, resolved once the device has passed them
(:func:`snapshot` waits for the rest). While a ``torch.profiler`` run is
active a span also opens a ``record_function`` range named
``mrp::<name>``, so that an idle gap in the profiler's trace falls inside
a named program range on the kernels' clock. Under ``torch.compile`` or
``torch.export`` tracing the recorder does nothing, so the traced graph
is the same on or off.
Records go into a buffer of :data:`CAPACITY` entries; the oldest are
dropped, and counted.

**The exporter.** :func:`trace` records the host and, on a CUDA card, the
device activity of the code under it with ``torch.profiler``, with the
recorder on, and writes a Chrome trace into ``logdir`` (view it in
Perfetto, or with TensorBoard's profiler plugin): the ``mrp::`` ranges
over the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

CAPACITY = 1 << 16   # records kept: several minutes of the busiest loop
PREFIX = "mrp::"     # the profiler ranges' prefix

_on = False


class _Off:
    """The span of a recorder that is off: shared, stateless."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def wait(self) -> None:
        pass

    def handles(self) -> tuple:
        return None, None


_OFF = _Off()


class _Buffer:
    """The records, the next id and each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: collections.deque = collections.deque(maxlen=CAPACITY)
        self.added = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def add(self, rec: dict) -> None:
        with self.lock:
            self.records.append(rec)
            self.added += 1


_buf = _Buffer()


def _cause() -> tuple:
    """(parent id, root id) for a record opened now on this thread."""
    stack = _buf.stack()
    return (stack[-1].id, stack[-1].root) if stack else (None, None)


class _Pending:
    """Device spans whose end the device may not have passed yet: resolved
    to milliseconds oldest first, as later device spans close (or by
    ``snapshot``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pairs: collections.deque = collections.deque()

    def add(self, start, end, rec: dict) -> None:
        with self.lock:
            self.pairs.append((start, end, rec))
        self.settle()

    def settle(self, block: bool = False) -> None:
        with self.lock:
            while self.pairs:
                start, end, rec = self.pairs[0]
                if block:
                    end.synchronize()
                elif not end.query():
                    return
                rec["device_ms"] = start.elapsed_time(end)
                self.pairs.popleft()


_pending = _Pending()


def _event():
    """A timing event recorded now on the current CUDA stream, or None
    where no CUDA context is up."""
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    __slots__ = ("name", "device", "launch", "id", "parent", "root", "t0",
                 "c0", "start", "end", "range", "stack")

    def __init__(self, name: str, device: bool, launch: bool = False):
        self.name, self.device, self.launch = name, device, launch

    def __enter__(self):
        self.stack = _buf.stack()
        self.id = next(_buf.ids)
        self.parent, root = _cause()
        self.root = self.id if root is None else root
        self.stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self.range.__enter__()
        self.start = _event() if self.device else None
        # a launch span's events are recorded again by the launch itself
        self.end = _event() if self.launch else None
        self.c0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        c1 = time.thread_time_ns()
        rec = {"name": self.name, "start_ns": self.t0, "end_ns": t1,
               "thread": threading.get_native_id(), "id": self.id,
               "parent": self.parent, "root": self.root,
               "cpu_ns": c1 - self.c0, "device_ms": None}
        if self.start is not None:
            if not self.launch:
                self.end = _event()
            _pending.add(self.start, self.end, rec)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.stack.pop()
        _buf.add(rec)
        return False

    def wait(self) -> None:
        """Waits for the device to reach the span's end (a device span
        that has closed); otherwise returns at once."""
        if self.end is not None:
            self.end.synchronize()

    def handles(self) -> tuple:
        """A launch span's raw start and end CUDA events (None where no
        CUDA context is up), for the launcher to record."""
        if self.start is None:
            return None, None
        return self.start.cuda_event, self.end.cuda_event


def span(name: str, device: bool = False):
    """A context manager that records ``name`` over its body while the
    recorder is on; ``device`` adds CUDA events at its ends. It gives an
    object whose ``wait()`` waits for the device to reach its end."""
    if not _on or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, device)


def launch_span(name: str):
    """A device span around one kernel launch made outside PyTorch (a
    ctypes call). Its ``handles()`` gives the raw start and end CUDA
    events (None, None while the recorder is off or no CUDA context is
    up), which the launcher records on its stream right before and after
    the launch, so that the span holds the kernel alone: no host work and
    no wait for the interpreter lock lies between its events."""
    if not _on or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, True, launch=True)


def count(name: str, n=1) -> None:
    """Records ``n`` under ``name`` now, while the recorder is on. ``n``
    is an int, or a 0-dim integer tensor whose value :func:`snapshot`
    reads (a count known on the device only costs no sync here)."""
    if not _on or torch.compiler.is_compiling():
        return
    parent, root = _cause()
    _buf.add({"name": name, "t_ns": time.time_ns(), "n": n,
              "thread": threading.get_native_id(), "parent": parent,
              "root": root})


def enable() -> None:
    """Turns the recorder on (what it holds stays)."""
    global _on
    _on = True


def disable() -> None:
    """Turns the recorder off (what it holds stays, for :func:`snapshot`)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forgets every record and the dropped count; the buffer takes
    :data:`CAPACITY` as it is now."""
    with _buf.lock:
        _buf.records = collections.deque(maxlen=CAPACITY)
        _buf.added = 0


def snapshot() -> dict:
    """What the recorder holds, oldest first:

    - ``spans``: {"name", "start_ns", "end_ns", "thread", "id", "parent",
      "root", "cpu_ns", "device_ms"} each (``device_ms`` None but for
      device spans on a card);
    - ``counts``: {"name", "t_ns", "n", "thread", "parent", "root"} each
      (``n`` an int);
    - ``dropped``: the records the bound has dropped since :func:`reset`.

    Waits for the device where a device span's end has not passed yet."""
    _pending.settle(block=True)
    with _buf.lock:
        recs = [dict(r) for r in _buf.records]
        dropped = _buf.added - len(recs)
    counts = [r for r in recs if "t_ns" in r]
    for r in counts:
        if isinstance(r["n"], torch.Tensor):
            r["n"] = int(r["n"])
    return {"spans": [r for r in recs if "t_ns" not in r],
            "counts": counts, "dropped": dropped}


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager capturing a profiler trace into logdir, with the
    recorder on (its state before is restored after)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = _on
    enable()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            yield logdir
    finally:
        if not was:
            disable()
