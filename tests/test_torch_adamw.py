"""The fused clip + AdamW update (``ops/adamw.py``, ``csrc/adamw.cu``).

On the CPU: the leaf tables of :func:`adamw.plan`, the leaf check that
raises, and ``train.AdamW.step`` on CPU leaves running the loop (no
launch). On the card (marker ``cuda``; they skip here): the kernels on
the 52 leaves of dynamic_swarm's model with seeded numpy gradients, bit
for bit the loop given the same norm, the norm deterministic and within
1e-6 of the loop's, gradients contiguous or channels-last (as cuDNN gives
a convolution's), the launch counts, and the leaves they refuse. Nothing
here imports JAX, so the card runs the file with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adamw.py
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.ops import adamw, bsp
from mrp_gnn_tpu_torch.utils import profiling

CHUNK = adamw.CHUNK


# --- the leaf tables (CPU) ----------------------------------------------------

@pytest.mark.parametrize("numels,max_leaves", [
    ([5], adamw.MAX_LEAVES),
    ([0, 3, 0, 0, CHUNK, CHUNK + 1, 0], adamw.MAX_LEAVES),
    ([1] * 130, adamw.MAX_LEAVES),
    ([0] * 70, adamw.MAX_LEAVES),
    ([7 * CHUNK + 3, 1, 40 * CHUNK], adamw.MAX_LEAVES),
    # a leaf of more chunks than all the others together, in a small table
    ([3 * CHUNK, 5 * CHUNK, 2 ** 33 + 1, 1, 0, 2 * CHUNK + 1], 4),
    (list(range(0, 40 * CHUNK, 997)), 16),
], ids=["one", "zero_size", "past_max_leaves", "all_empty", "many_chunks",
        "huge_leaf", "mixed"])
def test_plan_covers_every_leaf_once(numels, max_leaves):
    tables = adamw.plan(numels, max_leaves=max_leaves)
    seen = []
    for t in tables:
        assert 1 <= t.count <= max_leaves
        assert t.chunk0[0] == 0
        for i in range(t.count):
            n = numels[t.first + i]
            assert t.chunk0[i + 1] - t.chunk0[i] == math.ceil(n / CHUNK)
        seen += range(t.first, t.first + t.count)
    assert seen == list(range(len(numels)))
    # a table closes only when it is full
    assert all(a.count == max_leaves for a in tables[:-1])


def test_plan_of_the_model_is_one_table():
    model = MultiRobotPerceptionNet(get_config("dynamic_swarm").model)
    numels = [p.numel() for p in model.parameters()]
    tables = adamw.plan(numels)
    assert (len(numels), sum(numels)) == (52, 704_711)
    assert len(tables) == 1 and tables[0].count == 52
    assert tables[0].chunk0[-1] == sum(math.ceil(n / CHUNK) for n in numels)


def test_launch_counts_list_the_optimizer_kernels():
    """The two wrappers count with the fusion kernels (``bsp.launch_counts``,
    reset by ``bsp.reset_launches``)."""
    adamw.grad_norm.launches, adamw.adamw_update.launches = 3, 4
    counts = bsp.launch_counts()
    assert (counts["adamw_grad_norm"], counts["adamw_update"]) == (3, 4)
    bsp.reset_launches()
    assert (adamw.grad_norm.launches, adamw.adamw_update.launches) == (0, 0)
    assert set(bsp.launch_counts().values()) == {0}


def test_plan_limits_match_the_source():
    src = (Path(adamw.__file__).parent / "csrc" / "adamw.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kChunk") == adamw.CHUNK
    assert const("kMaxLeaves") == adamw.MAX_LEAVES


# --- the leaf check (CPU tensors) ---------------------------------------------

def _leaves(*shapes):
    return [torch.zeros(s) for s in shapes]


@pytest.mark.parametrize("bad,exc,match", [
    ("transposed_grad", ValueError, "gradient is not contiguous"),
    ("permuted_4d_grad", ValueError, "gradient is not contiguous"),
    ("strided_mu", ValueError, "mu is not contiguous"),
    ("channels_last_param", ValueError, "parameter is not contiguous"),
    ("channels_last_nu", ValueError, "nu is not contiguous"),
    ("double_grad", TypeError, "float32 only"),
    ("bf16_param", TypeError, "float32 only"),
    ("shape", ValueError, "has shape"),
    ("count", ValueError, "one gradient and moment a parameter"),
    ("none", ValueError, "one gradient and moment a parameter"),
    ("cpu", RuntimeError, "no fused update kernel for cpu"),
    ("channels_last_grad", RuntimeError, "no fused update kernel for cpu"),
])
def test_check_leaves_raises(bad, exc, match):
    p, g, mu, nu = (_leaves((3, 4), (5,), (4, 3, 2, 2)) for _ in range(4))
    if bad == "transposed_grad":
        g[0] = torch.zeros(4, 3).t()
    elif bad == "permuted_4d_grad":  # dense, but not channels-last
        g[2] = torch.zeros(4, 2, 3, 2).permute(0, 2, 1, 3)
    elif bad == "strided_mu":
        mu[1] = torch.zeros(10)[::2]
    elif bad == "channels_last_param":
        p[2] = p[2].contiguous(memory_format=torch.channels_last)
    elif bad == "channels_last_nu":
        nu[2] = nu[2].contiguous(memory_format=torch.channels_last)
    elif bad == "channels_last_grad":  # taken: cuDNN's weight gradients
        g[2] = g[2].contiguous(memory_format=torch.channels_last)
        assert not g[2].is_contiguous()
    elif bad == "double_grad":
        g[1] = g[1].double()
    elif bad == "bf16_param":
        p[0] = p[0].bfloat16()
    elif bad == "shape":
        nu[0] = torch.zeros(12)
    elif bad == "count":
        g = g[:1]
    elif bad == "none":
        p = g = mu = nu = []
    with pytest.raises(exc, match=match):
        adamw.check_leaves(p, g, mu, nu)


def test_layouts_name_each_channels_last_gradient():
    g = [torch.zeros(4, 3, 2, 5).contiguous(memory_format=torch.channels_last),
         torch.zeros(4, 3, 2, 5), torch.zeros(7),
         torch.zeros(4, 1, 1, 1).contiguous(memory_format=torch.channels_last)]
    assert list(adamw._layouts(g)) == [3, 10, 0, 0, 0, 0, 0, 0]


def test_wrappers_refuse_cpu_leaves():
    p, g = _leaves((3, 4)), _leaves((3, 4))
    with pytest.raises(RuntimeError, match="no fused update kernel"):
        adamw.grad_norm(g, torch.zeros(1, dtype=torch.int32))
    for norm in (torch.ones(()), None):
        with pytest.raises(RuntimeError, match="no fused update kernel"):
            adamw.adamw_update(p, g, _leaves((3, 4)), _leaves((3, 4)), norm,
                               ticket=torch.zeros(1, dtype=torch.int32),
                               lr=1e-3, count=1, max_norm=1.0,
                               weight_decay=0.0, b1=TT.B1, b2=TT.B2,
                               eps=TT.EPS)


# --- AdamW.step on CPU leaves: the loop ------------------------------------------

def test_cpu_step_runs_the_loop():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in shapes]
    a = TT.AdamW([p.clone() for p in params], lambda c: 1e-2 * (c + 1),
                 max_norm=1.0, weight_decay=1e-4)
    b = TT.AdamW([p.clone() for p in params], lambda c: 1e-2 * (c + 1),
                 max_norm=1.0, weight_decay=1e-4)
    before = (adamw.grad_norm.launches, adamw.adamw_update.launches)
    profiling.reset()
    profiling.enable()
    try:
        for scale in (10.0, 0.01, 3.0):
            g = [torch.from_numpy((scale * rng.normal(size=s)).astype(
                np.float32)) for s in shapes]
            g[0] = g[0].t().contiguous().t()  # the loop takes any strides
            assert torch.equal(a.step(g), b.loop_step(g))
    finally:
        profiling.disable()
    assert (adamw.grad_norm.launches, adamw.adamw_update.launches) == before
    assert not [c for c in profiling.snapshot()["counts"]
                if c["name"] == "optim.fused_leaves"]
    profiling.reset()
    assert a.count == b.count == 3
    for x, y in zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu):
        assert torch.equal(x, y)


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused update has no CPU mode")
    return torch.device("cuda", 0)


def _model_leaves(dev):
    model = MultiRobotPerceptionNet(get_config("dynamic_swarm").model,
                                    generator=torch.Generator().manual_seed(0))
    return [p.detach().to(dev) for p in model.parameters()]


def _grads(params, norm: float, seed: int, channels_last: bool = False):
    """Seeded numpy gradients of global norm about ``norm``; with
    ``channels_last``, each 4-D one stored channels-last, as cuDNN gives a
    convolution's weight gradient over the network's NHWC input."""
    rng = np.random.default_rng(seed)
    total = sum(p.numel() for p in params)
    out = [torch.from_numpy((rng.normal(size=tuple(p.shape)) * norm
                             / math.sqrt(total)).astype(np.float32)).to(
        p.device) for p in params]
    if channels_last:
        out = [g.contiguous(memory_format=torch.channels_last)
               if g.dim() == 4 else g for g in out]
        assert sum(not g.is_contiguous() for g in out) > 10
    return out


def _pair(params, lr0=1e-3):
    sched = lambda c: lr0 * (c + 1)  # noqa: E731 (lr above 0 from update 0)
    return [TT.AdamW([p.clone() for p in params], sched, max_norm=1.0,
                     weight_decay=1e-4) for _ in range(2)]


def _loop_norm(grads):
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def _launches():
    return adamw.grad_norm.launches, adamw.adamw_update.launches


def _assert_same_state(a, b):
    for name, xs, ys in (("p", a.params, b.params), ("mu", a.mu, b.mu),
                         ("nu", a.nu, b.nu)):
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert torch.equal(x, y), f"{name} of leaf {i} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("norm", [40.0, 0.3], ids=["clip", "no_clip"])
def test_update_matches_the_loop_bit_for_bit(dev, norm, layout):
    params = _model_leaves(dev)
    assert len(params) == 52
    kernel, loop = _pair(params)
    for step in range(3):
        g = _grads(params, norm, seed=step,
                   channels_last=layout == "channels_last")
        want = _loop_norm(g)
        assert bool(want >= 1.0) == (norm > 1.0)  # the clip acts or not
        before = _launches()
        got = kernel.step(g, want.clone())
        assert _launches() == (before[0], before[1] + 1)
        loop.loop_step(g, want)
        torch.cuda.synchronize()
        assert float(got) == float(want)
        _assert_same_state(kernel, loop)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [40.0, 0.3], ids=["clip", "no_clip"])
def test_step_computes_the_norm_on_the_card(dev, norm):
    params = _model_leaves(dev)
    kernel, loop = _pair(params)
    profiling.reset()
    profiling.enable()
    try:
        for step in range(3):
            g = _grads(params, norm, seed=10 + step, channels_last=True)
            before = _launches()
            got = kernel.step(g)
            assert _launches() == (before[0] + 1, before[1] + 1)
            want = loop.loop_step(g)
            torch.cuda.synchronize()
            assert abs(float(got) - float(want)) <= 1e-6 * float(want)
            if norm < 1.0:  # no clip: the norm does not reach the update
                _assert_same_state(kernel, loop)
            else:
                for x, y in zip(kernel.params, loop.params):
                    torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    finally:
        profiling.disable()
    counts = [c["n"] for c in profiling.snapshot()["counts"]
              if c["name"] == "optim.fused_leaves"]
    profiling.reset()
    assert counts == [52, 52, 52]


@pytest.mark.cuda
def test_norm_is_deterministic(dev):
    params = _model_leaves(dev)
    g = _grads(params, 5.0, seed=3)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    before = _launches()
    norms = [adamw.grad_norm(g, ticket) for _ in range(5)]
    assert _launches() == (before[0] + 5, before[1])
    want = float(_loop_norm(g))
    for n in norms:
        assert n.shape == () and n.dtype == torch.float32
        assert torch.equal(n, norms[0])
    assert abs(float(norms[0]) - want) <= 1e-6 * want
    assert int(ticket) == 0


@pytest.mark.cuda
def test_many_leaves_empty_and_unaligned(dev):
    """130 leaves (three tables), empty ones, and gradients that are views
    of one flat buffer at offsets that are not 16-byte aligned (as the
    mesh's all-reduced gradient is cut), against the loop."""
    rng = np.random.default_rng(5)
    sizes = [int(s) for s in rng.integers(0, 3 * CHUNK, size=130)]
    sizes[3] = sizes[70] = 0
    sizes[10] = 5 * CHUNK + 3
    params = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
              for n in sizes]
    flat = torch.from_numpy(rng.normal(size=sum(sizes) + 1).astype(
        np.float32)).to(dev)
    g = list(flat[1:].split(sizes))
    assert len(adamw.plan(sizes)) == 3
    kernel, loop = _pair(params)
    for step in range(3):
        want = _loop_norm(g)
        got = adamw.grad_norm(g, torch.zeros(1, dtype=torch.int32,
                                             device=dev))
        assert abs(float(got) - float(want)) <= 1e-6 * float(want)
        before = _launches()
        kernel.step(g, want)
        assert _launches() == (before[0], before[1] + 3)
        loop.loop_step(g, want)
        _assert_same_state(kernel, loop)
        g = [x * 0.5 for x in g]


@pytest.mark.cuda
def test_card_step_refuses_what_the_kernels_do_not_take(dev):
    params = [torch.zeros(4, 3, device=dev), torch.zeros(5, device=dev)]
    opt = TT.AdamW(params, lambda c: 1e-3, max_norm=1.0, weight_decay=0.0)
    good = [torch.ones(4, 3, device=dev), torch.ones(5, device=dev)]
    before = _launches()
    with pytest.raises(ValueError, match="not contiguous"):
        opt.step([torch.ones(3, 4, device=dev).t(), good[1]])
    with pytest.raises(TypeError, match="float32 only"):
        opt.step([good[0], good[1].double()])
    with pytest.raises(ValueError, match="has shape"):
        opt.step([good[0].reshape(12), good[1]])
    assert _launches() == before and opt.count == 0
    opt.step(good)
    assert _launches() == (before[0] + 1, before[1] + 1) and opt.count == 1
