"""What a traced run (``--trace 1``) records, from the benchmark's own code.

- :class:`Recorder`: host spans around calls into the program's layers
  (milliseconds, one list per name; each span is also a
  ``record_function`` range named ``perfbench::<name>``, so the profiler's
  timeline can say what the host was doing in an idle gap), and device
  times at module boundaries: CUDA events recorded on the current stream by
  forward pre- and post-hooks and full backward pre- and post-hooks. The
  untraced run gets :data:`OFF`, whose spans and hooks do nothing.
- :class:`ProfileWindow`: a ``torch.profiler`` trace of a steady stretch of
  the window, after a warm-up trace that is thrown away (the first calls
  of a trace lose their device activity). It gives the device's busy
  seconds (the union of every kernel, copy and set on the card), the
  traced stretch's length on the host clock, the kernels that took most
  time, and the idle gaps summed by the host span they fall in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

BREAKDOWN_ENTRIES = 10
_SPAN_PREFIX = "perfbench::"


class _HostStamp:
    """A CPU run's stand-in for a CUDA event (host clock), so that the
    hooks' plumbing runs in tests without a card."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostStamp") -> float:
        return (end.t - self.t) * 1e3


class Recorder:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.spans_ms: dict = defaultdict(list)
        self._pairs: dict = defaultdict(list)
        self._open: dict = {}
        self._handles = []

    def reset(self) -> None:
        """Forgets what was recorded so far (the set-up's calls); call it
        with the device idle."""
        self.spans_ms.clear()
        self._pairs.clear()
        self._open.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(_SPAN_PREFIX + name):
            yield
        self.spans_ms[name].append((time.perf_counter() - t0) * 1e3)

    def _stamp(self):
        ev = (torch.cuda.Event(enable_timing=True) if self.cuda
              else _HostStamp())
        ev.record()
        return ev

    def _start(self, name: str) -> None:
        self._open[name] = self._stamp()

    def _end(self, name: str) -> None:
        start = self._open.pop(name, None)
        if start is not None:
            self._pairs[name].append((start, self._stamp()))

    def time_forward(self, module: torch.nn.Module, name: str) -> None:
        """Device time of each forward call of ``module`` under ``name``."""
        if not self.enabled:
            return
        self._handles += [
            module.register_forward_pre_hook(
                lambda m, args: self._start(name)),
            module.register_forward_hook(
                lambda m, args, out: self._end(name))]

    def time_backward(self, module: torch.nn.Module, name: str) -> None:
        """Device time of each backward pass through ``module``."""
        if not self.enabled:
            return
        self._handles += [
            module.register_full_backward_pre_hook(
                lambda m, grad_out: self._start(name)),
            module.register_full_backward_hook(
                lambda m, grad_in, grad_out: self._end(name))]

    def remove_hooks(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def device_ms(self) -> dict:
        """{name: [ms of each call]}; synchronises the device."""
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self._pairs.items()}


OFF = Recorder(False, torch.device("cpu"))


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class ProfileWindow:
    """Profiles calls ``start`` .. ``start + warm`` (thrown away) and then
    ``active`` calls; the cell's loop calls :meth:`tick` after each call."""

    def __init__(self, start: int, warm: int, active: int):
        self.start, self.warm, self.active = start, warm, active
        self.calls = 0
        self._prof = None
        self._t = None
        self.window_s = None
        self._events = None

    def tick(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        self.calls += 1
        n = self.calls - self.start
        if n == 0:
            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
            self._prof.__enter__()
        elif n == self.warm:
            torch.cuda.synchronize()
            self._prof.step()
            self._t = time.perf_counter()
        elif n == self.warm + self.active:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self._t
            self._prof.step()
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(None, None, None)
            if self.window_s is not None:
                self._events = prof.profiler.kineto_results.events()

    def close(self) -> None:
        """Ends a trace that the window cut short (it yields nothing)."""
        self.window_s = None if self._events is None else self.window_s
        self._finish()

    def result(self) -> dict | None:
        """{"busy_s", "window_s", "calls", "device_ops", "idle_gaps"} or
        None when the trace did not complete or saw no device activity."""
        if self._events is None:
            return None
        dev, spans = [], []
        by_name: dict = defaultdict(int)
        for e in self._events:
            name, a, d = e.name(), e.start_ns(), e.duration_ns()
            if e.is_user_annotation() or name.startswith(
                    (_SPAN_PREFIX, "ProfilerStep")):
                # a host range, also drawn on the device's timeline
                if (name.startswith(_SPAN_PREFIX)
                        and e.device_type() == torch.autograd.DeviceType.CPU):
                    spans.append((a, a + d, name[len(_SPAN_PREFIX):]))
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((a, a + d))
                by_name[name] += d
        if not dev:
            return None
        busy = _union_ns(dev)
        gaps: dict = defaultdict(int)
        merged = []
        for a, b in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            mid = (end + nxt) / 2
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            # the innermost span that covers the gap's middle
            label = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                     else "host, outside any span")
            gaps[label] += nxt - end
        top = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"busy_s": busy / 1e9, "window_s": self.window_s,
                "calls": self.active, "device_ops": top(by_name),
                "idle_gaps": top(gaps)}
