"""The control on the card: the reference in TF32, the nearest precision
below the configurations' IEEE float32, put in the program's place, has to
fail the cell's limits where the program passes them. Also the planted
faults of ``calibrate.py``. At the cells' own sizes, one seed each;
``perfbench/calibrate.py`` reads a dozen.

Run on the card: ``python3 -m pytest perfbench/tests -m cuda``.
"""

import pytest

from perfbench import calibrate, cells, compare

pytestmark = pytest.mark.cuda

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fails(readings: dict, limits: dict) -> bool:
    return not compare.judge(readings, limits)[0]


@pytest.mark.parametrize("name", ["swarm_train", "dense_train"])
def test_training_control_and_faults_fail(card, name):
    cell = cells.cell(name)
    line = calibrate.train_seed(cell, SEED, card, control=True)
    assert compare.judge(line["program"], cell["limits"])[0], line
    for kind in ("control_tf32", "fault_unchanged", "fault_half_batch",
                 "fault_altered_answer"):
        assert _fails(line[kind], cell["limits"]), (kind, line)


@pytest.mark.parametrize("name", ["dense_serve"])
def test_serving_control_and_faults_fail(card, name):
    cell = cells.cell(name)
    line = calibrate.serve_seed(cell, SEED, card, 2.0, control=True)
    assert line["failed"] == 0
    assert compare.judge(line["program"], cell["limits"])[0], line
    for kind in ("control_tf32", "fault_half_batch", "fault_altered_answer"):
        assert _fails(line[kind], cell["limits"]), (kind, line)
