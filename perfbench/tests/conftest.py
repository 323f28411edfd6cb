"""Loading the metric readers imports ``perfbench/program_spans.py``,
which turns the program's recorder on for the whole process: each test
here leaves it off and empty, so that no later test runs with it on."""

import pytest

from mrp_gnn_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def program_recorder_off():
    yield
    if hasattr(profiling, "snapshot"):
        profiling.disable()
        profiling.reset()
