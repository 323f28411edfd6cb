"""The ``dense_attfuse`` configuration's work counts and the three readers
of AttFuse's kernels (``attfuse_roofline.train``,
``attfuse_bwd_roofline.train``, ``attfuse_pad_pct.train``)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import cells, program_spans, work
from perfbench.reference import attfuse as RA
from perfbench.reference.graph import RefGraph, full_graph
from perfbench.tests.test_perfbench_program_spans import _profile, _Snap

V, E = 512, 74112   # 2 x 193 fully connected robots in 512 slots
READERS = ("attfuse_roofline.train", "attfuse_bwd_roofline.train",
           "attfuse_pad_pct.train")


def _doc():
    return cells.load("configs", "dense_attfuse")


def test_the_cells_sizes():
    """Pinned exactly: ``train_mfu`` and the two rooflines divide by
    them. The edge block: 4 E sum P C = 4 x 74,112 x 57,344."""
    doc = _doc()
    ref, model = cells.reference(doc), doc["model"]
    assert ref.edge_flops(model, E) == 4 * 74112 * 57344 == 16999514112
    assert (work.forward_flops(ref, model, V, E),
            work.step_flops(ref, model, V, E),
            ref.fusion_work(model, V, E, False),
            ref.fusion_work(model, V, E, True)) == (
        195509092352.0, 582903398400.0, (16999514112.0, 235474432),
        (50998542336.0, 588389376))


def test_the_counter_credits_the_block_nothing():
    """The counter's pass sees the convolutions alone, graph or no graph,
    so the edges are credited once, by ``edge_flops``."""
    model = {**_doc()["model"], "image_size": [16, 16],
             "encoder_channels": [8, 16, 16]}
    p = {k: torch.randn(s) for k, s in RA.param_shapes(model).items()}
    images = torch.rand(10, 16, 16, 3)
    counts = []
    empty = RefGraph(torch.zeros(0, dtype=torch.int64),
                     torch.zeros(0, dtype=torch.int64),
                     torch.ones(10, dtype=torch.bool))
    for graph in (full_graph(2, 5, 10), empty):
        with FlopCounterMode(display=False) as fc:
            RA.forward(p, images, graph, model)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


@pytest.fixture
def recorder(monkeypatch):
    snap = _Snap()
    monkeypatch.setattr(program_spans, "_program", snap)
    monkeypatch.setattr(program_spans, "_last", [None, None])
    return snap


def _record(snap, steps=2, fwd_ms=1.0, bwd_ms=4.0, visited=126590):
    """``steps`` steps of 50 ms, each with three forward and three backward
    spans (one a scale) and three counts of ``visited`` x the scale's
    pixels; one step before them that the window must not read."""
    doc = _doc()
    t = 0.0
    for i in range(steps + 1):
        early = 10 if i == 0 else 1
        step = snap.span("train.step", t, t + 50)
        for k, pixels in enumerate((1024, 256, 64)):
            snap.span("fusion.attfuse", t + 1 + k, t + 1.5 + k, parent=step,
                      device=fwd_ms / 3 * early)
            snap.span("fusion.attfuse_backward", t + 20 + k, t + 21 + k,
                      device=bwd_ms / 3 * early)
            snap.count("fusion.attfuse_slots", t + 1 + k,
                       visited * pixels * early)
        t += 51
    return {"mode": "train", "steps": steps, "profile": _profile(),
            "edges": [E] * steps, "model": doc["model"], "num_nodes": V,
            "reference": doc["reference"]}


def test_the_readers_read_the_window(recorder):
    readers = cells.metric_readers()
    rec = _record(recorder)
    fwd, bwd = work.least_seconds(16999514112.0, 235474432), \
        work.least_seconds(2 * 16999514112.0, 588389376 - 235474432)
    got = {n: readers[n].read(rec) for n in READERS}
    assert got["attfuse_roofline.train"] == pytest.approx(
        100 * fwd / 1e-3)
    assert got["attfuse_bwd_roofline.train"] == pytest.approx(
        100 * bwd / 4e-3)
    assert got["attfuse_pad_pct.train"] == pytest.approx(
        100 * (1 - 74112 / 126590))


def test_the_readers_read_nothing_without_the_spans(recorder):
    """Another cell's window (steps, no AttFuse span or count), or no
    profile: nothing."""
    readers = cells.metric_readers()
    rec = _record(_Snap())
    recorder.span("train.step", 0, 50)
    recorder.span("train.step", 51, 101)
    for n in READERS:
        assert readers[n].read(rec) is None
    rec = _record(recorder)
    for n in READERS:
        assert readers[n].read({**rec, "profile": None}) is None


def test_host_spans_give_no_roofline(recorder):
    """A CPU run's spans carry no device time."""
    rec = _record(recorder)
    for s in recorder.spans:
        if s["name"].startswith("fusion."):
            s["device_ms"] = None
    readers = cells.metric_readers()
    assert readers["attfuse_roofline.train"].read(rec) is None
    assert readers["attfuse_bwd_roofline.train"].read(rec) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from perfbench.tests.tiny import tiny_root
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("fault", [None, "_unchanged_state",
                                   "_half_batch_loss", "_altered_depth"])
def test_the_cell_catches_the_training_faults(tiny, monkeypatch, fault):
    """The tiny ``attfuse_train`` run is ``correct``, and not with each of
    the training faults planted in the program."""
    from perfbench.tests import test_perfbench_faults as TF
    if fault is not None:
        getattr(TF, fault)(monkeypatch)
    assert TF._correct(tiny, "attfuse_train") is (fault is None)
