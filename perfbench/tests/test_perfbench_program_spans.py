"""The readers of the program's own spans (``program_spans.py`` and the
five ``metrics/*.py`` that import it): each reads only the window's last
steps or requests of a synthetic recorder snapshot, nothing without a
profile or a recorder, and a tiny traced CPU run keeps the line's metric
sets."""

import pytest
import torch

from perfbench import cells, program_spans, run
from perfbench.tests.tiny import tiny_root

MS = 1_000_000  # ns
TRAIN = ["step_issue_ms.train", "step_cpu_pct.train",
         "data_starved_pct.train"]
SERVE = ["request_copy_ms.serve", "forward_issue_ms.serve"]


class _Snap:
    """Builds a recorder snapshot: spans laid out on a clock in ms."""

    def __init__(self):
        self.spans, self.counts, self.ids = [], [], 0

    def span(self, name, start, end, parent=None, cpu=None, device=None):
        self.ids += 1
        self.spans.append({
            "name": name, "start_ns": int(start * MS),
            "end_ns": int(end * MS), "thread": 1, "id": self.ids,
            "parent": parent, "root": parent or self.ids,
            "cpu_ns": None if cpu is None else int(cpu * MS),
            "device_ms": device})
        return self.ids

    def count(self, name, t, n=1):
        self.counts.append({"name": name, "t_ns": int(t * MS), "n": n,
                            "thread": 1, "parent": None, "root": None})

    def snapshot(self):
        return {"spans": self.spans, "counts": self.counts, "dropped": 0}


@pytest.fixture
def recorder(monkeypatch):
    snap = _Snap()
    monkeypatch.setattr(program_spans, "_program", snap)
    monkeypatch.setattr(program_spans, "_last", [None, None])
    return snap


@pytest.fixture(scope="module")
def readers():
    return cells.metric_readers()


def _profile():
    return {"busy_s": 1.0, "window_s": 2.0, "calls": 1, "device_ops": [],
            "idle_gaps": []}


def _train_record(snap: _Snap, before: int = 2, steps: int = 3) -> dict:
    """``before`` steps that the window must not read (every number
    10x), then ``steps`` (the default window's last 30, 10 and 20 ms),
    half of each on the CPU, with a forward and an update; a take before
    each step, every other one starved."""
    t = 0.0
    for i in range(before + steps):
        scale = 10 if i < before else 1
        wall = 10.0 * (i % steps + 1) * scale
        snap.span("data.take", t, t + 1)
        if i % 2:
            snap.count("data.starved", t + 0.5)
        t += 1
        step = snap.span("train.step", t, t + wall, cpu=wall / 2)
        snap.span("train.forward", t, t + 1, parent=step)
        snap.span("train.update", t + 2, t + 3, parent=step)
        t += wall
    return {"mode": "train", "steps": steps, "profile": _profile()}


def _serve_record(snap: _Snap, before: int = 2, requests: int = 4,
                  failed: int = 1) -> dict:
    """``before`` warm-up requests (every number 10x), then the window's
    ``requests - failed``: copies of 3 and 2 ms, a 4 ms forward
    enqueue."""
    t = 0.0
    for i in range(before + requests - failed):
        scale = 10 if i < before else 1
        req = snap.span("serve.request", t, t + 20)
        snap.span("serve.copy_in", t, t + 3 * scale, parent=req)
        snap.span("serve.forward", t + 3, t + 3 + 4 * scale, parent=req,
                  device=12.0)
        snap.span("serve.copy_out", t + 15, t + 15 + 2 * scale, parent=req)
        t += 34
    return {"mode": "serve", "requests": requests, "failed": failed,
            "profile": _profile()}


def test_train_readers_read_the_last_steps(recorder, readers):
    rec = _train_record(recorder)
    got = {m: readers[m].read(rec) for m in TRAIN}
    assert got == pytest.approx({
        "step_issue_ms.train": 20.0,
        "step_cpu_pct.train": 50.0,
        # the window's 2 takes (the first is before its first step)
        "data_starved_pct.train": 50.0})


def test_serve_readers_read_the_last_requests(recorder, readers):
    rec = _serve_record(recorder)
    got = {m: readers[m].read(rec) for m in SERVE}
    assert got == pytest.approx({
        "request_copy_ms.serve": 5.0,
        "forward_issue_ms.serve": 4.0})


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_nothing_without_a_profile_a_recorder_or_the_window(
        recorder, readers, monkeypatch, metric):
    train = metric in TRAIN
    rec = (_train_record if train else _serve_record)(recorder)
    assert readers[metric].read(rec) is not None
    assert readers[metric].read({**rec, "mode": "serve" if train
                                 else "train", "steps": 1}) is None
    assert readers[metric].read({**rec, "profile": None}) is None
    # more steps or requests than the recorder holds
    more = {"steps": 9} if train else {"requests": 9}
    assert readers[metric].read({**rec, **more}) is None
    monkeypatch.setattr(program_spans, "_program", None)
    assert readers[metric].read(rec) is None


def test_a_tiny_traced_run_keeps_the_lines_metrics(tmp_path):
    """Importing the helper (as loading the readers does) turns the
    program's recorder on: the run records the program's spans, and on
    the CPU (no profile) the new readers add nothing to the line."""
    import importlib

    from mrp_gnn_tpu_torch.utils import profiling
    root = tiny_root(tmp_path)
    profiling.disable()
    importlib.reload(program_spans)
    assert profiling.enabled()
    want = {"swarm_train": {"data_wait_ms.train", "train_mfu",
                            "fusion_roofline.train"},
            "dense_serve": {"predictor_host_ms.serve", "serve_forward_mfu",
                            "fusion_roofline.serve"}}
    try:
        for cell, layer in want.items():
            profiling.reset()
            args = run.parse(["--workload", cell, "--seed", str(2**31 + 5),
                              "--seconds", "0.5", "--trace", "1"])
            res = run.execute(args, root, torch.device("cpu"))
            assert set(res["metrics"]) == layer and res["correct"] is True
            names = {s["name"] for s in profiling.snapshot()["spans"]}
            assert ({"train.step", "train.backward", "train.update"}
                    if cell == "swarm_train"
                    else {"serve.request", "serve.copy_out"}) <= names
    finally:
        profiling.disable()
        profiling.reset()
