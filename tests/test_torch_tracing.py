"""The port's span recorder (``utils/profiling.py``) on the CPU: off it
records nothing, reads no clock and opens no profiler range; on, spans
carry parent, root and thread ids on the profiler's clock, from the train
step, the data stream's threads and the Predictor, whose numbers come out
bit for bit the same; device spans resolve oldest
first once the device has passed their end; ``trace`` shows the ranges;
``torch.export`` traces the same graph; the buffer keeps the newest
records and counts the rest."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import (TransformIterator,
                                             make_train_iterator)
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.serving import Predictor
from mrp_gnn_tpu_torch.utils import profiling as P
from torch_small import small

STEP_CHILDREN = ["train.forward", "train.backward", "train.update"]
SERVE_CHILDREN = ["serve.copy_in", "serve.forward", "serve.wait",
                  "serve.copy_out"]


@pytest.fixture(autouse=True)
def recorder_off():
    P.disable()
    P.reset()
    yield
    P.disable()
    P.reset()


@pytest.fixture
def one_thread():
    """CPU reductions split over threads sum in a varying order; one
    thread gives the same bits run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _by_name(snap: dict) -> dict:
    out: dict = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _ranges(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(P.PREFIX)]


def _cfg():
    return small(get_config("dynamic_swarm"))


def _train(steps: int = 2):
    """(parameters, snapshot) after ``steps`` tiny train steps from the
    seeded state, on the tiny data stream."""
    torch.manual_seed(0)
    cfg = _cfg()
    state = TT.create_train_state(cfg, "cpu")
    step = TT.make_train_step(cfg, state.model, state.optimizer)
    it = make_train_iterator(cfg.data)
    try:
        for _ in range(steps):
            state, _ = step(state, *TT.batch_to_device(next(it), "cpu"))
    finally:
        it.close()
    return ([p.detach().clone() for p in state.model.parameters()],
            P.snapshot())


def _predictor():
    cfg = _cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                encoder_channels=(8, 16)))
    model = MultiRobotPerceptionNet(
        cfg.model, generator=torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device="cpu")
    images = np.random.default_rng(1).uniform(
        size=pred.input_shape).astype(np.float32)
    return pred, images


class _Forbidden:
    """Stands in for a module or callable that the off path must not
    touch."""

    def __getattr__(self, name):
        raise AssertionError(f"touched {name}")

    def __call__(self, *a, **k):
        raise AssertionError("called")


def test_off_records_nothing_and_opens_no_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("a"), P.span("b", device=True) as s:
            P.count("c")
            torch.ones(4).sum()
            s.wait()
    assert not _ranges(prof)
    assert P.snapshot() == {"spans": [], "counts": [], "dropped": 0}


def test_off_reads_no_clock_makes_no_event_and_no_range(monkeypatch):
    """Off, a span is the one shared no-op object after the flag test: no
    clock, no CUDA event, no profiler query or range."""
    monkeypatch.setattr(P, "time", _Forbidden())
    monkeypatch.setattr(torch.cuda, "Event", _Forbidden())
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", _Forbidden())
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Forbidden())
    a, b = P.span("a"), P.span("b", device=True)
    assert a is b
    with a as s:
        s.wait()
        P.count("c", 3)


def test_nested_spans_carry_parent_root_and_thread():
    P.enable()
    with P.span("outer") as outer:
        with P.span("mid"):
            with P.span("inner", device=True) as inner:
                P.count("hits", 2)
                inner.wait()  # no card: returns at once
        with P.span("mid2"):
            pass
    t = threading.Thread(target=lambda: P.span("other").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    spans = _by_name(P.snapshot())
    o, m, i, m2 = (spans[n][0] for n in ("outer", "mid", "inner", "mid2"))
    assert o["id"] == outer.id and o["parent"] is None and o["root"] == o["id"]
    assert m["parent"] == o["id"] and m2["parent"] == o["id"]
    assert i["parent"] == m["id"]
    assert {s["root"] for s in (o, m, i, m2)} == {o["id"]}
    assert o["start_ns"] <= m["start_ns"] <= i["start_ns"] <= i["end_ns"]
    assert i["end_ns"] <= m["end_ns"] <= m2["start_ns"] <= o["end_ns"]
    assert len({o["thread"], m["thread"], i["thread"]}) == 1
    assert all(s["cpu_ns"] >= 0 and s["device_ms"] is None
               for s in (o, m, i, m2))
    other = spans["other"][0]
    assert other["thread"] != o["thread"]
    assert other["parent"] is None and other["root"] == other["id"]
    count, = P.snapshot()["counts"]
    assert (count["name"], count["n"], count["parent"], count["root"]) == (
        "hits", 2, i["id"], o["id"])


def test_a_span_that_raises_is_recorded_and_closed():
    P.enable()
    with pytest.raises(ValueError):
        with P.span("outer"):
            with P.span("fails"):
                raise ValueError
    with P.span("after"):
        pass
    spans = _by_name(P.snapshot())
    assert spans["fails"][0]["parent"] == spans["outer"][0]["id"]
    assert spans["after"][0]["parent"] is None


class _FakeEvent:
    """A CUDA timing event's stand-in: passed once ``done`` is set."""

    clock = 0.0

    def __init__(self):
        _FakeEvent.clock += 1.0
        self.t, self.done, self.waited = _FakeEvent.clock, False, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waited = self.done = True

    def elapsed_time(self, end) -> float:
        return end.t - self.t


def test_device_spans_resolve_oldest_first_once_passed(monkeypatch):
    """A device span's time is set once the device has passed its end,
    oldest first, as later device spans close; ``wait`` waits for its own
    end; ``snapshot`` waits for the rest."""
    events = []

    def event():
        events.append(_FakeEvent())
        return events[-1]

    monkeypatch.setattr(P, "_event", event)
    P.enable()
    with P.span("a", device=True):
        pass
    with P.span("b", device=True):
        pass
    with P.span("host"):
        pass
    a_end, b_end = events[1], events[3]
    b_end.done = True          # b passed, a not: nothing resolves
    with P.span("c", device=True):
        pass
    assert P._pending.pairs and len(P._pending.pairs) == 3
    a_end.done = True          # now a and b resolve, c stays
    with P.span("d", device=True) as d:
        pass
    assert [r["name"] for _, _, r in P._pending.pairs] == ["c", "d"]
    d.wait()
    assert events[7].waited and not events[5].waited
    snap = _by_name(P.snapshot())
    assert not P._pending.pairs and events[5].waited
    assert [snap[n][0]["device_ms"] for n in "abcd"] == [1.0] * 4
    assert snap["host"][0]["device_ms"] is None


def test_data_threads_record_batches_placements_and_starved_takes():
    """A producer held back: the consumer's take finds the queue empty
    (``data.starved``); the prefetch thread records ``data.batch`` with its
    ``data.graph``, the producer ``data.place``."""
    gate = threading.Event()

    class HeldBack:
        def __init__(self, it):
            self.it = it

        def __next__(self):
            gate.wait(timeout=30)
            return next(self.it)

        def close(self):
            self.it.close()

    P.enable()
    # the prefetching stream's thread renders; the producer places
    it = TransformIterator(HeldBack(make_train_iterator(_cfg().data)),
                           TT.BatchPlacer("cpu"))
    timer = threading.Timer(0.3, gate.set)
    timer.start()
    try:
        for _ in range(3):
            next(it)
    finally:
        it.close()
        timer.cancel()
    snap = P.snapshot()
    spans = _by_name(snap)
    me = threading.get_native_id()
    takes = spans["data.take"]
    assert len(takes) == 3 and {s["thread"] for s in takes} == {me}
    starved = [c for c in snap["counts"] if c["name"] == "data.starved"]
    assert starved and starved[0]["parent"] == takes[0]["id"]
    assert sum(c["n"] for c in starved) <= 3
    batch_threads = {s["thread"] for s in spans["data.batch"]}
    place_threads = {s["thread"] for s in spans["data.place"]}
    assert len(batch_threads) == 1 and len(place_threads) == 1
    assert len(batch_threads | place_threads | {me}) == 3
    assert len(spans["data.place"]) >= 3
    ids = {s["id"] for s in spans["data.batch"]}
    assert spans["data.graph"] and all(g["parent"] in ids
                                       for g in spans["data.graph"])


@pytest.mark.usefixtures("one_thread")
def test_train_step_records_its_parts_and_changes_no_bit():
    want, empty = _train()
    assert empty["spans"] == []
    P.enable()
    got, snap = _train()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    spans = _by_name(snap)
    steps = spans["train.step"]
    assert len(steps) == 2
    for step in steps:
        kids = [s for s in snap["spans"] if s["parent"] == step["id"]]
        assert [k["name"] for k in sorted(kids, key=lambda s: s["start_ns"])
                ] == STEP_CHILDREN
        assert all(k["root"] == step["id"] for k in kids)


@pytest.mark.usefixtures("one_thread")
def test_predictor_records_a_request_and_changes_no_bit():
    pred, images = _predictor()
    want = pred(images)
    assert P.snapshot()["spans"] == []
    P.enable()
    got = pred(images)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])
    snap = P.snapshot()
    spans = _by_name(snap)
    req, = spans["serve.request"]
    kids = sorted((s for s in snap["spans"] if s["parent"] == req["id"]),
                  key=lambda s: s["start_ns"])
    assert [k["name"] for k in kids] == SERVE_CHILDREN
    assert all(k["root"] == req["id"] for k in kids)


def test_spans_sit_on_the_profilers_clock():
    """A span's start and end are within 1 ms of its ``mrp::`` range's
    (after a first range: the process's first one looks its op up)."""
    P.enable()
    with profile(activities=[ProfilerActivity.CPU]), P.span("warm"):
        pass
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span("probe"):
                torch.ones(256).cumsum(0)
    ranges = sorted(_ranges(prof), key=lambda e: e.start_ns())
    spans = _by_name(P.snapshot())["probe"]
    assert len(ranges) == len(spans) == 3
    assert all(e.name() == P.PREFIX + "probe" for e in ranges)
    for s, e in zip(spans, ranges):
        assert abs(s["start_ns"] - e.start_ns()) < 1e6
        assert abs(s["end_ns"] - (e.start_ns() + e.duration_ns())) < 1e6


@pytest.mark.parametrize("was_on", [False, True])
def test_trace_shows_the_train_step_and_restores_the_recorder(tmp_path,
                                                              was_on):
    if was_on:
        P.enable()
    cfg = _cfg()
    state = TT.create_train_state(cfg, "cpu")
    step = TT.make_train_step(cfg, state.model, state.optimizer)
    it = make_train_iterator(cfg.data)
    batch = TT.batch_to_device(next(it), "cpu")
    it.close()
    with P.trace(str(tmp_path / "tr")) as logdir:
        assert P.enabled()
        step(state, *batch)
    assert P.enabled() is was_on
    name, = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mrp::train.step", "mrp::train.forward", "mrp::train.backward",
            "mrp::train.update"} <= names


def test_export_traces_the_same_graph_with_the_recorder_on():
    pred, _ = _predictor()

    def ops():
        program = pred.export_program()
        return [str(n.target) for n in program.graph.nodes
                if n.op == "call_function"]

    want = ops()
    P.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        got = ops()
    assert got == want and not any("profiler" in o for o in got)
    assert P.snapshot()["spans"] == []


def test_the_bound_drops_the_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(P, "CAPACITY", 4)
    P.reset()
    P.enable()
    for i in range(10):
        with P.span(f"s{i}"):
            pass
    P.count("c")
    snap = P.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["s7", "s8", "s9"]
    assert [c["name"] for c in snap["counts"]] == ["c"]
    assert snap["dropped"] == 7
    P.reset()
    assert P.snapshot() == {"spans": [], "counts": [], "dropped": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_device_span_times_the_stream_between_its_ends(card):
    x = torch.randn(2048, 2048, device=card)
    x @ x
    torch.cuda.synchronize()
    P.enable()
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    outer[0].record()
    with P.span("work", device=True) as s:
        for _ in range(20):
            x @ x
        outer[1].record()
    outer[2].record()
    s.wait()
    assert outer[1].query()  # the wait reached the span's end
    torch.cuda.synchronize()
    got = P.snapshot()["spans"][0]["device_ms"]
    assert 0.9 * outer[0].elapsed_time(outer[1]) <= got
    assert got <= outer[0].elapsed_time(outer[2])
