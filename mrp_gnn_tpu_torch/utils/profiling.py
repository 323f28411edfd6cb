"""Profiling helpers (port of ``mrp_gnn_tpu/utils/profiling.py``).

``trace(logdir)`` records the host and, on a CUDA card, the device
activity of the code under it with ``torch.profiler`` and writes a Chrome
trace into ``logdir`` (view it in Perfetto, or with TensorBoard's profiler
plugin). ``StepTimer`` is a wall-clock per-step timer.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager capturing a profiler trace into logdir."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


class StepTimer:
    """Cheap wall-clock per-step timer producing JSONL-ready records."""

    def __init__(self):
        self._t0 = None
        self.records = []

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, **extra) -> dict:
        dt = time.perf_counter() - self._t0
        rec = {"step_time_s": dt, **extra}
        self.records.append(rec)
        return rec
