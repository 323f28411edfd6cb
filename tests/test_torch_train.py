"""The port's training step against the JAX package's, on CPU.

- The learning-rate schedule and clip + AdamW against optax.
- The slice as a whole: 3 steps of ``make_train_step`` on a small
  ``dynamic_swarm`` (16x16 images, encoder 16/32/64, 2 scenes x 8 drifting
  robots: D 256, ELL width 8, tile 16). JAX runs ``ops_impl="pallas"`` in
  interpret mode, so its fused attention and the backward's _sddmm2,
  _spmm_t and _spmm kernels run; the port runs ``ops_impl="pallas"`` on CPU
  tensors, so its FusedAttention backward runs the kernels' plain versions.
  Both start from the same flax weights (``load_flax_params``).
- Gradient accumulation over 2 microbatches (one graph each) against JAX,
  remat against no remat, and the loop's records and refusals (checkpoints,
  eval and summaries: ``test_torch_checkpoint.py``,
  ``test_torch_train_features.py``).

Tolerances. Loss terms and grad norms: 1e-5 relative (f32, sums in another
order; measured differences are under 2e-6). Parameters: 2e-5 absolute,
except ``fusion0.key.bias``, whose true gradient is 0 (a key bias adds
<q[v], b> to every logit of row v, and the row's softmax ignores a shift
shared by the row): its gradient is rounding noise on both sides, and Adam
scales each step's update to about lr whatever the gradient's size, so
the two runs may differ there by up to 2 x (sum of the learning rates).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from mrp_gnn_tpu import train as JT
from mrp_gnn_tpu.config import get_config as jax_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jax_dataset
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp

TERM_RTOL = 1e-5
PARAM_ATOL = 2e-5
ZERO_GRAD_PARAMS = ("fusion0.key.bias",)


def _small(cfg, impl="pallas", lr=1e-3, warmup=2, **train):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(16, 16), num_robots=8,
                                 scenes_per_batch=2, num_train_scenes=8,
                                 renderer="numpy", graph_builder="numpy"),
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(16, 32, 64)),
        train=dataclasses.replace(cfg.train, learning_rate=lr,
                                  warmup_steps=warmup, steps=100, **train),
        parallel=dataclasses.replace(cfg.parallel, ops_impl=impl))


def _batches(n, **train):
    jcfg = _small(jax_config("dynamic_swarm"), **train)
    tcfg = _small(get_config("dynamic_swarm"), **train)
    jb = [b for _, b in zip(range(n), jax_dataset(jcfg.data, "train"))]
    tb = [b for _, b in zip(range(n), make_dataset(tcfg.data, "train"))]
    return jcfg, tcfg, jb, tb


def _np_params(state):
    return jax.tree.map(np.asarray, state.params)


def _torch_inputs(b):
    return (torch.from_numpy(np.asarray(b["images"])),
            torch.from_numpy(np.asarray(b["depth"])),
            torch.from_numpy(np.asarray(b["seg"])), b["graph"])


def _check_terms(got, want, step):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=TERM_RTOL, err_msg=f"step {step} {k}")


def _check_params(model, jax_params, tcfg, lr_sum):
    ref = dict(load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                                jax_params).named_parameters())
    for name, p in model.named_parameters():
        atol = 2 * lr_sum if name in ZERO_GRAD_PARAMS else PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def test_schedule_matches_optax():
    cfg = get_config("dynamic_swarm")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, steps=12, warmup_steps=4, learning_rate=2e-3))
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 4, 12)
    got = [TT.warmup_cosine_lr(cfg, c) for c in range(16)]
    assert got[0] == 0.0  # the first update has lr 0
    # optax evaluates in f32: one f32 ulp at the peak lr is 2.3e-10
    np.testing.assert_allclose(got, [float(sched(c)) for c in range(16)],
                               rtol=1e-6, atol=2.5e-10)


@pytest.mark.parametrize("grad_scale", [10.0, 0.01],
                         ids=["above_clip", "below_clip"])
def test_clip_adamw_matches_optax(grad_scale):
    jcfg = _small(jax_config("dynamic_swarm"), lr=1e-2, warmup=2)
    tcfg = _small(get_config("dynamic_swarm"), lr=1e-2, warmup=2)
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.normal(size=s) / 3).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = JT.make_optimizer(jcfg)
    jp = list(params)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = TT.make_optimizer(tcfg, tp)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm > 1.0) == (grad_scale > 1)  # clip norm 1.0
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        got_norm = opt.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_three_train_steps_match_jax_pallas():
    jcfg, tcfg, jb, tb = _batches(3)
    state, jmodel = JT.create_train_state(jcfg, jax.random.PRNGKey(0), jb[0])
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model,
                                                     ops_impl="pallas"),
                             _np_params(state))
    jstep = JT.make_train_step(jcfg, jmodel, JT.make_optimizer(jcfg),
                               donate=False)
    opt = TT.make_optimizer(tcfg, model.parameters())
    tstate = TT.TrainState(model, opt)
    tstep = TT.make_train_step(tcfg, model, opt)
    for i, (a, b) in enumerate(zip(jb, tb)):
        assert np.array_equal(np.asarray(a["graph"].ell_src),
                              b["graph"].ell_src.numpy())
        assert bsp.supports(b["graph"])
        state, jterms = jstep(state, a["images"], a["depth"], a["seg"],
                              a["graph"])
        tstate, terms = tstep(tstate, *_torch_inputs(b))
        _check_terms(terms, jax.device_get(jterms), i)
    assert tstate.step == 3 and opt.count == 3
    _check_params(model, _np_params(state), tcfg,
                  sum(TT.warmup_cosine_lr(tcfg, c) for c in range(3)))


def test_grad_accumulation_matches_jax():
    """Two microbatches with a graph each (dynamic topology), one update."""
    jcfg, tcfg, jb, tb = _batches(2, grad_accum_steps=2)
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel,
                                                     ops_impl="xla"))
    stacker = JT._MicrobatchStacker(iter(jb), 2, close_inner=False)
    group = next(stacker)
    stacker.close()
    state, jmodel = JT.create_train_state(
        jcfg, jax.random.PRNGKey(1), {"images": jb[0]["images"],
                                      "graph": jb[0]["graph"]})
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model,
                                                     ops_impl="pallas"),
                             _np_params(state))
    jstep = JT.make_train_step(jcfg, jmodel, JT.make_optimizer(jcfg),
                               donate=False)
    state, jterms = jstep(state, group["images"], group["depth"],
                          group["seg"], group["graph"])
    tgroup = next(TT._microbatches(iter(tb), 2))
    assert isinstance(tgroup["graph"], list) and len(tgroup["graph"]) == 2
    opt = TT.make_optimizer(tcfg, model.parameters())
    _, terms = TT.make_train_step(tcfg, model, opt)(
        TT.TrainState(model, opt), *_torch_inputs(tgroup))
    _check_terms(terms, jax.device_get(jterms), 0)


def test_remat_gives_the_same_gradients():
    _, tcfg, _, tb = _batches(1)
    inputs = _torch_inputs(tb[0])
    norms = []
    for remat in (False, True):
        cfg = tcfg.replace(train=dataclasses.replace(tcfg.train, remat=remat))
        model = MultiRobotPerceptionNet(
            cfg.model, ops_impl="pallas",
            generator=torch.Generator().manual_seed(3))
        opt = TT.make_optimizer(cfg, model.parameters())
        grads = []
        opt.step = lambda g: grads.extend(g) or torch.tensor(0.0)
        TT.make_train_step(cfg, model, opt)(TT.TrainState(model, opt), *inputs)
        norms.append(grads)
    for a, b in zip(*norms):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_loop_records_on_cpu():
    _, tcfg, _, tb = _batches(3, log_every=1)
    seen = []
    state, records = TT.train(tcfg, num_steps=3, log_fn=seen.append,
                              data_iter=iter(tb), device="cpu")
    assert state.step == 3 and records == seen and len(records) == 3
    for r in records:
        for key in ("step", "depth_l1", "seg_ce", "total", "grad_norm",
                    "wall_s", "step_time_s", "views_per_s", "edges_per_s"):
            assert np.isfinite(r[key]), (key, r)
    assert records[0]["views_per_s"] == pytest.approx(
        16 / records[0]["step_time_s"])


def test_train_loop_halts_on_a_nonfinite_loss():
    _, tcfg, _, tb = _batches(1)
    bad = dict(tb[0], images=np.full_like(tb[0]["images"], np.nan))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        TT.train(tcfg, num_steps=2, data_iter=iter([bad, bad]), device="cpu")


@pytest.mark.parametrize("change", [
    dict(parallel=dict(data_axis_size=2)), dict(data=dict(loader="grain"))],
    ids=["mesh", "grain"])
def test_train_refuses_what_is_not_ported(change, monkeypatch):
    """Mesh axes > 1 are not ported (A11); the worker loader is, and
    refuses a process group of more than one process, as the JAX package
    refuses more than one process."""
    cfg = get_config("dynamic_swarm")
    for part, kw in change.items():
        cfg = cfg.replace(**{part: dataclasses.replace(getattr(cfg, part),
                                                       **kw)})
    if "data" in change:
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        with pytest.raises(ValueError, match="single-process only"):
            TT.train(cfg, num_steps=1, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A"):
        TT.train(cfg, num_steps=1, device="cpu")


def test_train_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.train(_small(get_config("dynamic_swarm")), num_steps=1)
