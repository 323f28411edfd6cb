"""The port's benchmark harness, on CPU at tiny sizes (64 nodes, D 32,
short chains, the small ``dynamic_swarm`` of ``tests/torch_small.py``,
probes shrunk): every bench runs every route and gives records with the
JAX package's keys, printed as JSON lines that parse; the encoder's FLOPs
equal an analytic count of its convolutions. CPU numbers are no
measurement of the card: the tests check the records, not their values.
"""

import json
import math

import pytest

from mrp_gnn_tpu_torch import benchmark as TB
from mrp_gnn_tpu_torch.config import get_config
from torch_small import small

EDGE_KEYS = {"bench", "path", "nodes", "edges", "feature_dim",
             "sec_per_call", "edges_per_s", "backend"}
TRAIN_KEYS = {"bench", "config", "sec_per_step", "steps_per_s",
              "nodes_per_s", "edges_per_s", "backend"}
MFU_KEYS = {"bench", "config", "stage", "sec", "flops", "logical_bytes",
            "min_bytes", "achieved_tflops", "bound", "sol_frac",
            "stream_ceiling_gbs", "matmul_ceiling_tflops", "backend"}


@pytest.fixture(autouse=True)
def tiny_probes(monkeypatch):
    monkeypatch.setattr(TB, "PROBE_MM", 64)
    monkeypatch.setattr(TB, "PROBE_CPU_ROWS", 256)


def _check_edge(recs, bench, paths):
    assert [r["path"] for r in recs] == list(paths)
    for r in recs:
        assert set(r) == EDGE_KEYS | {"launches"}
        assert r["bench"] == bench and r["backend"] == "cpu"
        assert r["nodes"] == 64 and r["edges"] == 64 * 7  # 8 teams of 8
        assert r["sec_per_call"] > 0 and r["launches"] == {}  # CPU: no launch


def test_main_runs_every_single_device_bench(capsys):
    recs = TB.main(["--what", "all", "--config", "single_robot_depth",
                    "--nodes", "64", "--feature_dim", "32", "--inner", "2",
                    "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == recs
    by = {b: [r for r in recs if r["bench"] == b]
          for b in ("fusion", "train_step", "train_edge", "mfu", "scaling",
                    "overlap", "overlap_summary")}
    assert len(recs) == sum(map(len, by.values()))
    # "all" also runs the multi-device benches, in a world of one rank
    assert [len(by[b]) for b in ("scaling", "overlap",
                                 "overlap_summary")] == [1, 2, 1]
    _check_edge(by["fusion"], "fusion", ("xla_scatter", "xla_ell",
                                         "pallas_ell", "xla_block",
                                         "pallas_block"))
    _check_edge(by["train_edge"], "train_edge", ("xla_ell", "pallas_ell"))
    assert [set(r) for r in by["train_step"]] == [TRAIN_KEYS]
    assert [r["stage"] for r in by["mfu"]] == ["encoder", "decoder", "heads",
                                               "train_step"]  # no fusion


def test_train_and_mfu_on_a_fused_config():
    cfg = small(get_config("dynamic_swarm"))
    (rec,) = TB.bench_train(cfg, inner=2, device="cpu")
    assert set(rec) == TRAIN_KEYS and rec["config"] == "dynamic_swarm"
    assert rec["nodes_per_s"] == pytest.approx(16 / rec["sec_per_step"])
    recs = TB.bench_mfu(cfg, inner=2, device="cpu")
    assert [r["stage"] for r in recs] == ["encoder", "fusion", "decoder",
                                          "heads", "train_step"]
    for r in recs:
        assert set(r) == MFU_KEYS and r["logical_bytes"] is None
        assert r["bound"] in ("matmul", "stream") and r["sol_frac"] > 0
        json.dumps(r)
    # the train step counts the backward's products too
    assert recs[-1]["flops"] > 2 * recs[0]["flops"]


def _encoder_conv_flops(V, H, W, chans, cin=3):
    """2 x multiply-adds of the encoder's 3x3 convolutions ('SAME'): the
    stem, then per stage a stride-2 conv and a residual block's two."""
    flops = 2 * V * H * W * chans[0] * cin * 9
    prev, h, w = chans[0], H, W
    for ch in chans:
        h, w = math.ceil(h / 2), math.ceil(w / 2)
        flops += 2 * V * h * w * (ch * prev + 2 * ch * ch) * 9
        prev = ch
    return flops


def test_encoder_flops_equal_an_analytic_count():
    cfg = small(get_config("dynamic_swarm"))
    recs = TB.bench_mfu(cfg, inner=1, device="cpu")
    enc = recs[0]
    assert enc["stage"] == "encoder"
    H, W = cfg.data.image_size
    V = cfg.data.scenes_per_batch * cfg.data.num_robots
    assert enc["flops"] == _encoder_conv_flops(V, H, W,
                                               cfg.model.encoder_channels)


@pytest.mark.parametrize("what", ["scaling", "overlap"])
def test_multi_device_benches_wait_for_parallelism(what):
    """Without a process group the multi-device benches run in a world of
    one rank: scaling gives its P = 1 record, overlap its two turns and
    the summary (over ranks: ``tests/test_torch_tp.py``)."""
    recs = TB.main(["--what", what, "--device", "cpu", "--inner", "2"])
    if what == "scaling":
        assert [r["devices"] for r in recs] == [1]
        assert {"edges", "edges_per_s", "efficiency", "topology",
                "exchange", "backend"} <= set(recs[0])
    else:
        assert [r["bench"] for r in recs] == ["overlap", "overlap",
                                              "overlap_summary"]
        assert recs[0]["n_exchanges"] == 2
