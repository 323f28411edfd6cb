"""Runs with the timed path broken underneath come out not ``correct``.

Each test skips the look for a card, plants one fault in the program and
drives the rest of a tiny run on the CPU: the state left unchanged by a
step, half of the batch left out (the loss the mean over the rest), an
answer altered where it is produced. The sound run beside them comes out
``correct``. One card holds each cell, so no exchange between cards can be
left out.
"""

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny_root

BUMP_M = 0.5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _correct(root, cell: str) -> bool:
    args = run.parse(["--workload", cell, "--seed", "77", "--seconds", "0.5",
                      "--trace", "0"])
    return run.execute(args, root, torch.device("cpu"))["correct"]


def _halved(mask):
    real = torch.nonzero(mask).flatten()
    out = mask.clone()
    out[real[len(real) // 2:]] = False
    return out


def _unchanged_state(monkeypatch):
    from mrp_gnn_tpu_torch import train
    monkeypatch.setattr(train.AdamW, "step",
                        lambda self, grads, norm=None: torch.zeros(()))


def _half_batch_loss(monkeypatch):
    from mrp_gnn_tpu_torch import train
    real = train.total_loss
    monkeypatch.setattr(train, "total_loss", lambda out, batch, mask, *a, **k:
                        real(out, batch, _halved(mask), *a, **k))


def _altered_depth(monkeypatch):
    from mrp_gnn_tpu_torch.models import decoder
    real = decoder.DepthHead.forward

    def forward(self, x, shard=None):
        out = real(self, x, shard)
        return torch.cat([out[:1] + BUMP_M, out[1:]])
    monkeypatch.setattr(decoder.DepthHead, "forward", forward)


def _half_batch_served(monkeypatch):
    from mrp_gnn_tpu_torch import serving
    real = serving._Forward.forward

    def forward(self, images):
        out = real(self, images)
        keep = _halved(self.graph.node_mask)[:, None, None]
        return {k: v * keep.to(v.dtype) for k, v in out.items()}
    monkeypatch.setattr(serving._Forward, "forward", forward)


def _altered_answer(monkeypatch):
    from mrp_gnn_tpu_torch import serving
    real = serving._Forward.forward

    def forward(self, images):
        out = dict(real(self, images))
        depth, seg = out["depth"].clone(), out["seg"].clone()
        depth[0, 0, 0] += BUMP_M
        seg[0, 0, 0] = (seg[0, 0, 0] + 1) % 6
        return {"depth": depth, "seg": seg}
    monkeypatch.setattr(serving._Forward, "forward", forward)


@pytest.mark.parametrize("cell", ["swarm_train", "dense_train",
                                  "dense_serve"])
def test_sound_run_is_correct(root, cell):
    assert _correct(root, cell)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch_loss,
                                   _altered_depth])
@pytest.mark.parametrize("cell", ["swarm_train", "dense_train"])
def test_training_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not _correct(root, cell)


@pytest.mark.parametrize("fault", [_half_batch_served, _altered_answer])
@pytest.mark.parametrize("cell", ["dense_serve"])
def test_serving_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not _correct(root, cell)
