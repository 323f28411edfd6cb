"""The port's entry points pin their numerics (``utils.platform.
reference_numerics``), on CPU.

Each entry point starts from four caller states: torch's defaults; the
legacy TF32 switches on with cuDNN non-deterministic and benchmarking; the
new API's conv "tf32" beside rnn "ieee" (the state in which
``torch.backends.cudnn.flags()`` and the legacy reads raise); and
``torch.set_float32_matmul_precision("high")``. For ``Predictor.__call__``,
``load_exported``'s callable, ``evaluate()``, ``train()``, the step of
``make_train_step`` and ``benchmark.bench_train``:

- every convolution and matmul that the call dispatches, forward and
  backward, runs with IEEE f32 switches, cuDNN enabled, deterministic and
  not benchmarking (a dispatch mode records the settings at each op);
- the caller's exact settings are back afterwards;
- the outputs are bit for bit those of the same work outside the pin, as
  the entry points gave them before (one intra-op thread, as
  tests/test_torch_checkpoint.py needs for bit-equality on the CPU).

These settings can be set, and are read back, on a CPU build of torch.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mrp_gnn_tpu_torch import benchmark as TB
from mrp_gnn_tpu_torch import serving as TS
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset, make_train_iterator
from mrp_gnn_tpu_torch.evaluate import evaluate
from mrp_gnn_tpu_torch.utils.platform import (_FP32_SWITCHES,
                                              reference_numerics)
from torch_small import small

CPU = torch.device("cpu")
PINNED = ("ieee",) * len(_FP32_SWITCHES) + (True, True, False)
CONV = {"convolution", "conv2d"}  # conv2d: as inference mode dispatches it
NUMERIC_OPS = CONV | {"convolution_backward", "mm", "addmm", "bmm",
                      "baddbmm", "linear", "matmul"}


def _switch(b, op):
    return getattr(getattr(torch.backends, b), op)


def _settings() -> tuple:
    """What the pin sets, read through the per-op switches only."""
    c = torch.backends.cudnn
    return (tuple(_switch(b, op).fp32_precision for b, op in _FP32_SWITCHES)
            + (c.enabled, c.deterministic, c.benchmark))


def _snapshot() -> tuple:
    """Everything a caller can read back, the legacy booleans included
    (each read's value, or the exception it raises)."""
    legacy = []
    for b in (torch.backends.cuda.matmul, torch.backends.cudnn):
        try:
            legacy.append(b.allow_tf32)
        except RuntimeError as e:
            legacy.append(type(e).__name__)
    return (_settings(), torch.get_float32_matmul_precision(), tuple(legacy))


def _legacy_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True


def _mixed_new_api():
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    torch.backends.cudnn.rnn.fp32_precision = "ieee"


CALLER_STATES = {
    "defaults": lambda: None,
    "legacy_tf32": _legacy_tf32,
    "mixed_new_api": _mixed_new_api,
    "matmul_high": lambda: torch.set_float32_matmul_precision("high"),
}


@pytest.fixture(params=list(CALLER_STATES))
def caller(request):
    """Put the process in a caller state; torch's own state is back after
    the test."""
    saved = (_settings(), torch.get_float32_matmul_precision(),
             torch.get_num_threads())
    torch.set_num_threads(1)
    CALLER_STATES[request.param]()
    if request.param == "mixed_new_api":
        with pytest.raises(RuntimeError):
            torch.backends.cudnn.flags(enabled=True).__enter__()
    yield _snapshot()
    torch.set_float32_matmul_precision(saved[1])
    for (b, op), v in zip(_FP32_SWITCHES, saved[0]):
        _switch(b, op).fp32_precision = v
    c = torch.backends.cudnn
    c.enabled, c.deterministic, c.benchmark = saved[0][len(_FP32_SWITCHES):]
    torch.set_num_threads(saved[2])


class _SettingsLog(TorchDispatchMode):
    """The settings at every convolution and matmul that runs under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in NUMERIC_OPS:
            self.ops.append((name, _settings()))
        return func(*args, **(kwargs or {}))


def _pinned(call, caller_snapshot, backward=False):
    """Run ``call`` under a settings log; every logged op must have run
    pinned, a convolution (and with ``backward`` its backward) must have
    run, and the caller's settings must be back."""
    log = _SettingsLog()
    with log:
        out = call()
    assert _snapshot() == caller_snapshot
    names = {n for n, _ in log.ops}
    assert names & CONV, names
    assert "convolution_backward" in names or not backward, names
    bad = [(n, s) for n, s in log.ops if s != PINNED]
    assert not bad, bad[:3]
    return out


def _cfg(**train):
    return small(get_config("dynamic_swarm"), impl="pallas", **train)


def _predictor(cfg):
    batch = next(iter(make_dataset(cfg.data, "eval", shuffle=False)))
    model = TT.create_train_state(cfg, CPU).model
    return TS.Predictor(cfg, model, graph=batch["graph"], device=CPU), batch


def _equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_predictor_call(caller):
    pred, batch = _predictor(_cfg())
    with torch.inference_mode():
        want = {k: v.numpy() for k, v in
                pred._forward(torch.from_numpy(batch["images"])).items()}
    got = _pinned(lambda: pred(batch["images"]), caller)
    assert _equal(got, want)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A Predictor exported under torch's defaults (``torch.export`` reads
    cuDNN's legacy switch, which raises in the mixed caller state)."""
    pred, batch = _predictor(_cfg())
    art = str(tmp_path_factory.mktemp("export") / "model.pt2")
    TS.export_predictor(pred, art)
    return pred, batch, art


def test_load_exported(caller, artifact):
    pred, batch, art = artifact
    infer = TS.load_exported(art, device="cpu")
    with torch.inference_mode():
        want = {k: v.numpy() for k, v in
                infer.module(torch.from_numpy(batch["images"])).items()}
    got = _pinned(lambda: infer(batch["images"]), caller)
    assert _equal(got, want)
    assert _equal(got, pred(batch["images"]))


def test_evaluate(caller):
    cfg = _cfg()
    model = TT.create_train_state(cfg, CPU).model
    want = evaluate.__wrapped__(cfg, model)
    assert _pinned(lambda: evaluate(cfg, model), caller) == want


def _step_inputs(cfg):
    it = make_train_iterator(cfg.data)
    return [TT.batch_to_device(next(it), CPU) for _ in range(2)]


def test_train_step_forward_and_backward(caller):
    cfg = _cfg()
    batches = _step_inputs(cfg)
    runs = []
    for pinned in (False, True):
        state = TT.create_train_state(cfg, CPU)
        step = TT.make_train_step(cfg, state.model, state.optimizer)
        step = step if pinned else step.__wrapped__
        terms = []
        for b in batches:
            call = (lambda b=b: step(state, *b)[1])
            terms.append(_pinned(call, caller, backward=True) if pinned
                         else call())
        runs.append((terms, [p.detach().clone()
                             for p in state.model.parameters()]))
    (t0, p0), (t1, p1) = runs
    assert all(torch.equal(a[k], b[k]) for a, b in zip(t0, t1) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_train(caller):
    cfg = _cfg(log_every=1)
    batches = _step_inputs(cfg)
    state, records = _pinned(lambda: TT.train(cfg, num_steps=2, device=CPU),
                             caller, backward=True)
    ref = TT.create_train_state(cfg, CPU)
    raw = TT.make_train_step(cfg, ref.model, ref.optimizer).__wrapped__
    for rec, b in zip(records, batches):
        terms = raw(ref, *b)[1]
        assert {k: rec[k] for k in terms} == {k: float(v)
                                              for k, v in terms.items()}
    assert all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                 ref.model.parameters()))


def test_bench_train(caller):
    cfg = small(get_config("five_robot_attention"))
    (rec,) = _pinned(lambda: TB.bench_train(cfg, inner=2, device="cpu"),
                     caller, backward=True)
    assert rec["backend"] == "cpu" and math.isfinite(rec["sec_per_step"])


def test_the_pin_restores_on_error_and_nests(caller):
    with pytest.raises(KeyError):
        with reference_numerics():
            assert _settings() == PINNED
            with reference_numerics():
                assert _settings() == PINNED
            assert _settings() == PINNED
            raise KeyError
    assert _snapshot() == caller
