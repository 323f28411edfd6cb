"""``utils.debug.checked`` against the JAX package's (checkify), on CPU.

- The shared cases, the same numpy inputs from a seed through JAX's
  ``checked(jax.jit(f))`` and the port's ``checked(f)``: a finite ``log``
  (values within 1e-6), ``log`` of a negative, an out-of-range gather and
  an integer floor division by zero (both raise; the port with
  FloatingPointError, IndexError and ZeroDivisionError naming the op).
- Each indexing op the port checks, in range (bit for bit the unchecked
  call) and out of range (IndexError, and the process goes on).
- A small ``dynamic_swarm`` train step under ``checked``: the loss terms and
  every gradient bit for bit the unchecked step's (one intra-op thread, as
  tests/test_torch_checkpoint.py needs for bit-equality on the CPU), on
  the plain ops and on the kernels' plain versions.
- A backward that makes a NaN is caught; so is a NaN written where the
  dispatcher does not see it (as a kernel launched through ctypes writes),
  at the first checked op that reads it; the first failing op is named.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from mrp_gnn_tpu.utils import debug as jdebug
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
from mrp_gnn_tpu_torch.utils.debug import checked
from torch_small import small

SEED = 16


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(SEED)
    x = rng.uniform(0.5, 4.0, 32).astype(np.float32)
    neg = x.copy()
    neg[rng.integers(32)] = -1.0
    idx = rng.integers(0, 32, 8).astype(np.int32)
    oob = idx.copy()
    oob[3] = 32 + int(rng.integers(1, 5))
    a = rng.integers(-50, 50, 16).astype(np.int32)
    b = rng.integers(1, 7, 16).astype(np.int32)
    b0 = b.copy()
    b0[5] = 0
    return {"x": x, "neg": neg, "idx": idx, "oob": oob, "a": a, "b": b,
            "b0": b0}


def _jax(f, *args):
    return np.asarray(jdebug.checked(jax.jit(f))(*args))


def _torch(f, *args):
    return checked(f)(*(torch.from_numpy(a) for a in args))


def test_finite_log_agrees_with_jax():
    d = _inputs()
    want = _jax(jnp.log, d["x"])
    got = _torch(torch.log, d["x"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, torch.log(torch.from_numpy(d["x"])))


@pytest.mark.parametrize("case", ["log", "gather", "floor_divide"])
def test_both_raise_on_the_shared_faults(case):
    d = _inputs()
    jf, tf, args, exc, op = {
        "log": (jnp.log, torch.log, (d["neg"],), FloatingPointError,
                "aten.log"),
        "gather": (lambda x, i: x[i], lambda x, i: x[i.long()],
                   (d["x"], d["oob"]), IndexError, "aten.index"),
        "floor_divide": (jnp.floor_divide, torch.floor_divide,
                         (d["a"], d["b0"]), ZeroDivisionError,
                         "aten.floor_divide"),
    }[case]
    with pytest.raises(Exception):
        _jax(jf, *args)
    with pytest.raises(exc, match=op):
        _torch(tf, *args)


def test_in_range_cases_agree_with_jax():
    d = _inputs()
    np.testing.assert_array_equal(
        _torch(lambda x, i: x[i.long()], d["x"], d["idx"]).numpy(),
        _jax(lambda x, i: x[i], d["x"], d["idx"]))
    np.testing.assert_array_equal(
        _torch(torch.floor_divide, d["a"], d["b"]).numpy(),
        _jax(jnp.floor_divide, d["a"], d["b"]))


def _index_cases(x, i):
    """(name, fn(x, i)) for each checked indexing op on a [4, 3] x."""
    return [
        ("index_select", lambda: torch.index_select(x, 0, i)),
        ("gather", lambda: torch.gather(x, 0, i[:, None].expand(-1, 3))),
        ("take", lambda: torch.take(x, i)),
        ("embedding", lambda: torch.nn.functional.embedding(i, x)),
        ("index", lambda: x[i]),
        ("index_put", lambda: x.clone().index_put_((i,), torch.ones(3))),
        ("index_add", lambda: x.clone().index_add_(0, i, torch.ones(len(i),
                                                                    3))),
        ("index_copy", lambda: x.clone().index_copy_(
            0, i[1:2], torch.ones(1, 3))),
        ("index_fill", lambda: x.clone().index_fill_(0, i, 2.0)),
        ("scatter", lambda: torch.zeros(4, 3).scatter_(
            0, i[:, None].expand(-1, 3), x[:len(i)])),
        ("scatter_add", lambda: torch.zeros(4, 3).scatter_add(
            0, i[:, None].expand(-1, 3), x[:len(i)])),
        ("scatter_reduce", lambda: torch.zeros(4, 3).scatter_reduce(
            0, i[:, None].expand(-1, 3), x[:len(i)], "amax")),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _index_cases(None, None)])
def test_indexing_ops(name):
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(4, 3)).astype(np.float32))
    ok = dict(_index_cases(x, torch.tensor([2, 0, 3])))[name]
    assert torch.equal(checked(ok)(), ok())
    bad = dict(_index_cases(x, torch.tensor([2, 12, 0])))[name]
    with pytest.raises(IndexError, match=f"aten.{name}"):
        checked(bad)()
    # the bad index never reached a kernel: the process goes on
    assert torch.equal(checked(ok)(), ok())


def test_negative_indices_follow_the_op():
    x = torch.arange(4.0)
    assert torch.equal(checked(lambda: torch.take(x, torch.tensor([-1])))(),
                       torch.tensor([3.0]))
    assert torch.equal(checked(lambda: x[torch.tensor([-4])])(),
                       torch.tensor([0.0]))
    for fn in (lambda: x[torch.tensor([-5])],
               lambda: torch.index_select(x, 0, torch.tensor([-1]))):
        with pytest.raises(IndexError):
            checked(fn)()


@pytest.mark.parametrize("fn", [
    lambda a, b: a % b, lambda a, b: torch.fmod(a, b),
    lambda a, b: torch.div(a, b, rounding_mode="trunc"),
    lambda a, b: a.clone().floor_divide_(b), lambda a, b: a // 0])
def test_integer_division_by_zero(fn):
    a, b = torch.tensor([7, -3]), torch.tensor([2, 0])
    with pytest.raises(ZeroDivisionError):
        checked(fn)(a, b)


def test_float_division_is_left_to_the_nan_check():
    a, b = torch.tensor([1.0, 0.0]), torch.tensor([0.0, 1.0])
    assert torch.equal(checked(torch.div)(a, b), torch.tensor([np.inf, 0.0]))
    with pytest.raises(FloatingPointError, match="aten.div"):
        checked(torch.div)(b, b)  # 0 / 0


def test_nan_in_backward_is_caught():
    def f(x):
        (torch.sqrt(x) * 0).sum().backward()  # forward finite: 0 * sqrt(0)
        return x.grad

    with pytest.raises(FloatingPointError, match="backward|aten.div|aten.mul"):
        checked(f)(torch.zeros(3, requires_grad=True))
    x = torch.ones(3, requires_grad=True)
    assert torch.equal(checked(f)(x), torch.zeros(3))


def test_an_unseen_nan_is_caught_where_it_is_read():
    def f(x):
        y = torch.empty_like(x)
        with _disable_current_modes():  # a write the dispatcher never sees
            y.copy_(x)
            y[1] = float("nan")
        z = y.view(-1)  # a view computes nothing: not the op to blame
        return torch.relu(z) + 1

    with pytest.raises(FloatingPointError, match="aten.relu"):
        checked(f)(torch.ones(4))


def test_the_first_failing_op_is_named_after_the_call_ends():
    seen = []

    def f(x, i):
        y = torch.log(x)        # NaN first
        z = x[i]                # then an out-of-range index
        seen.append(True)       # the call runs to its end, as checkify's
        return y, z

    with pytest.raises(FloatingPointError, match=r"aten.log.*check 1 of"):
        checked(f)(torch.tensor([-1.0, 1.0]), torch.tensor([5]))
    assert seen == [True]
    with pytest.raises(IndexError, match="aten.index"):
        checked(f)(torch.tensor([1.0, 1.0]), torch.tensor([5]))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("fusion", ["attention", "mean"])
def test_train_step_under_checked_is_bit_for_bit(impl, fusion):
    cfg = small(get_config("dynamic_swarm"), impl=impl)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, fusion=fusion))
    batch = TT.batch_to_device(next(make_train_iterator(cfg.data)),
                               torch.device("cpu"))
    out = {}
    for name in ("plain", "checked"):
        state = TT.create_train_state(cfg, "cpu")
        step = TT.make_train_step(cfg, state.model, state.optimizer)
        grads = {}
        for n, p in state.model.named_parameters():
            p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
        _, terms = (checked(step) if name == "checked" else step)(
            state, *batch)
        out[name] = (terms, grads, [p.detach().clone() for p in
                                    state.model.parameters()])
    (t0, g0, p0), (t1, g1, p1) = out["plain"], out["checked"]
    assert sorted(t0) == sorted(t1) and sorted(g0) == sorted(g1)
    assert all(torch.equal(t0[k], t1[k]) for k in t0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
