"""Tensor parallelism of the port (``parallel/tp.py``) over gloo ranks on
the CPU, against the port on one process and the JAX package.

- The sharding rule, case for case as ``tests/test_tp.py``'s, on JAX leaf
  shapes and on the port's layouts, and which leaves ``dynamic_swarm``
  shards at its widths.
- Two ranks (``tests/torch_parallel_worker.py``) on a (1, 1, 2) mesh run a
  small ``dynamic_swarm`` (``tests/torch_small.py``) from the JAX package's
  initial weights (a one-process step-0 checkpoint, which each rank
  restores and shards): the collectives at float64, the fusion layer with
  one and two heads, the first step's terms and gradients, 4 steps of
  ``train.train`` with checkpoints, a resume and ``evaluate``; and the
  scaling and overlap benches over the two ranks.
- Held against one process of the port (mesh shrunk) from the same
  checkpoint: the first step's terms and gradients within 1e-5 relative,
  4 steps' losses within the JAX tests' ``rtol=2e-4, atol=2e-5``, eval
  within 1e-4; against the JAX package's unsharded first step from the same
  weights within 1e-5 relative; the resume bit for bit; the checkpoints
  whole tensors that one process restores.

Slow tier: the (2, 2, 2) mesh and two attention heads over 8 ranks.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.evaluate import evaluate
from mrp_gnn_tpu_torch.parallel import tp
from test_torch_parallel import _jax_initial_checkpoint, spawn_ranks
from torch_parallel_worker import (first_batch, first_updates, job_config,
                                   straddling_group_norm, tuples,
                                   unsharded_fusion)
from torch_small import small

TOL = 1e-5
JOB = dict(config="dynamic_swarm", steps=4, data=dict(num_eval_scenes=4),
           parallel=dict(model_axis_size=2), bench=True)


def test_leaf_shard_dim_rule():
    """``tests/test_tp.py::test_leaf_partition_spec_rule``'s cases: the
    trailing (output-feature) dim of a JAX leaf is dim 0 of the port's."""
    assert tp.leaf_shard_dim((3, 3, 16, 32), 2) == 0   # conv HWIO
    assert tp.leaf_shard_dim((64, 128), 4) == 0        # dense (in, out)
    assert tp.leaf_shard_dim((32,), 2) == 0            # bias / scale
    assert tp.leaf_shard_dim((3, 3, 16, 1), 2) is None
    assert tp.leaf_shard_dim((2,), 2) is None
    assert tp.leaf_shard_dim((), 2) is None
    assert tp.leaf_shard_dim((64, 128), 1) is None


def test_param_shard_dim_on_the_port_layouts():
    """The same cases in the port's layouts: conv [out, in, kh, kw], dense
    [out, in], vectors."""
    assert tp.jax_shape((32, 16, 3, 3)) == (3, 3, 16, 32)
    assert tp.jax_shape((128, 64)) == (64, 128)
    assert tp.param_shard_dim((32, 16, 3, 3), 2) == 0
    assert tp.param_shard_dim((128, 64), 4) == 0
    assert tp.param_shard_dim((32,), 2) == 0
    assert tp.param_shard_dim((1, 16, 3, 3), 2) is None
    assert tp.param_shard_dim((2,), 2) is None
    assert tp.param_shard_dim((128, 64), 1) is None


@pytest.mark.parametrize("m", [2, 4])
def test_dynamic_swarm_shards_at_its_widths(m):
    """At ``dynamic_swarm``'s widths every conv, GroupNorm, query, key and
    the seg head (6 -> 3) shard over 2; the depth head (out 1) stays
    replicated, and over 4 the seg head too (6 % 4)."""
    model = TT.create_train_state(get_config("dynamic_swarm"), "cpu").model
    replicated = {n for n, p in model.named_parameters()
                  if tp.param_shard_dim(p.shape, m) is None}
    want = {"depth_head.out.weight", "depth_head.out.bias"}
    if m == 4:
        want |= {"seg_head.out.weight", "seg_head.out.bias"}
    assert replicated == want


def _jax_first_step(jcfg) -> dict:
    from mrp_gnn_tpu import train as JT
    _, records = JT.train(jcfg, num_steps=1)
    return records[0]


NOISE_DRAWS = 8


def one_process(cfg, where):
    """One process of the port from the same step-0 checkpoint: its records
    over the job's steps, and :func:`first_updates`'s gradients and
    parameters with the images as they are, then with each pixel scaled by
    1 +- 1e-7 (seeded signs, in NOISE_DRAWS draws: their own sensitivity to
    rounding). On one intra-op thread, as the ranks run: torch's
    multi-threaded CPU kernels round otherwise from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _one_process(cfg, where)
    finally:
        torch.set_num_threads(threads)


def _one_process(cfg, where):
    one = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(where)))
    images, *rest = first_batch(one)
    rng = np.random.default_rng(0)
    draws = []
    for x in [images] + [
            images * (1 + 1e-7 * torch.from_numpy(
                rng.choice([-1.0, 1.0], size=images.shape).astype(np.float32)))
            for _ in range(NOISE_DRAWS)]:
        state = TT.create_train_state(one, "cpu")
        CheckpointManager(str(where)).restore_latest(state)
        draws.append(first_updates(one, state, (x, *rest)))
        draws[-1].pop("terms")
    _, records = TT.train(one, device="cpu")
    return [r for r in records if "total" in r], draws


def run_job(job, tmp_path_factory, world, name):
    """Spawn ``world`` ranks of the job from the JAX package's initial
    weights; returns (ranks' json, ranks' arrays, config, its directory,
    one process's records, its draws of :func:`first_updates` (the first
    unperturbed), JAX's first step)."""
    from mrp_gnn_tpu.config import get_config as jax_config
    where = tmp_path_factory.mktemp(name)
    cfg = job_config(job, str(where), get_config, small)
    jcfg = small(jax_config(job["config"]), impl="xla",
                 data=tuples(job.get("data")), log_every=1)
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, **tuples(job.get("model"))))
    for d in ("ck", "one"):
        _jax_initial_checkpoint(jcfg, cfg, str(where / d))
    with open(where / "model_axis.json", "w") as f:
        json.dump(job, f)
    spawn_ranks(str(where), world=world)
    ranks = [json.load(open(where / f"rank{r}.json")) for r in range(world)]
    arrays = [dict(np.load(where / f"rank{r}.npz")) for r in range(world)]
    records, grads = one_process(cfg, where / "one")
    return ranks, arrays, cfg, where, records, grads, _jax_first_step(jcfg)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    return run_job(JOB, tmp_path_factory, 2, "tp")


def whole(ranks, arrays, m: int, prefix: str) -> dict:
    """Every parameter's ``prefix`` array, whole: a sharded leaf's rows from
    the ranks of node block 0 in model order, a replicated leaf rank 0's."""
    out = {}
    for name in ranks[0]["shapes"]:
        key = prefix + name
        if name in ranks[0]["sharded"]:
            out[key] = np.concatenate([arrays[r][key] for r in range(m)])
        else:
            out[key] = arrays[0][key]
    return out


def check_terms(got, want, keys=("total", "depth_l1", "seg_ce")):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


def _scales(want: dict, prefix: str) -> dict:
    """Each ``prefix`` array's largest element in ``want`` (1% of the
    largest of all, for a leaf whose true value is 0, the key bias's
    gradient, whose elements are rounding noise)."""
    want = {k: v for k, v in want.items() if k.startswith(prefix)}
    top = max(np.abs(w).max() for w in want.values())
    return {k: max(np.abs(w).max(), 1e-2 * top) for k, w in want.items()}


def leaf_errors(got: dict, want: dict, prefix: str) -> dict:
    """Each leaf's max |got - want| of its ``prefix`` array, relative to
    :func:`_scales`."""
    return {k[len(prefix):]: np.abs(got[k] - want[k]).max() / s
            for k, s in _scales(want, prefix).items()}


def envelope(draws: list, prefix: str) -> dict:
    """Each leaf's bound: TOL beyond the most that any two of one
    process's runs (the images as they are and the perturbed draws)
    disagree on its ``prefix`` array. The ranks against one process are
    one more such pair: each rounds otherwise, and where a ReLU gate's
    input lies within that rounding of 0 the gradient of the weights
    before it jumps."""
    scales = _scales(draws[0], prefix)
    return {k[len(prefix):]: TOL + max(np.abs(a[k] - b[k]).max()
                                       for a, b in itertools.combinations(
                                           draws, 2)) / s
            for k, s in scales.items()}


def check_leaves(got: dict, want: dict, prefix: str, tol=TOL):
    """Every leaf's ``prefix`` array within ``tol`` (one bound, or one a
    leaf) of one process's."""
    errs = leaf_errors(got, want, prefix)
    bound = tol if isinstance(tol, dict) else dict.fromkeys(errs, tol)
    bad = {n: (e, bound[n]) for n, e in errs.items() if not e <= bound[n]}
    assert not bad, bad


def test_params_are_sharded(tp_run):
    ranks = tp_run[0]
    full = dict(TT.create_train_state(tp_run[2], "cpu")
                .model.named_parameters())
    for r in ranks:
        assert r["sharded"], "no parameter ended up model-sharded"
        for name, shape in r["shapes"].items():
            want = list(full[name].shape)
            if tp.param_shard_dim(want, 2) is not None:
                want[0] //= 2
                assert name in r["sharded"]
            assert shape == want, name


def test_tp_first_step_matches_one_process(tp_run):
    """The first step's terms and gradients within 1e-5 relative of one
    process's, leaf by leaf. The parameters after the second update (the
    first with lr above 0) leaf by leaf within :func:`envelope`: AdamW's
    second update from two equal gradients is g / (|g| + 1e-8) times the
    lr, so an element whose gradient is near 1e-8 moves by a share of the
    lr when its last bits do (here 1.7e-4 of ``encoder.res2.Conv_0``'s
    largest weight, with its gradient within 1e-6)."""
    ranks, arrays, _, _, records, draws, _ = tp_run
    for r in ranks:
        check_terms(r["first"], records[0])
    check_leaves(whole(ranks, arrays, 2, "grad/"), draws[0], "grad/")
    check_leaves(whole(ranks, arrays, 2, "step2/"), draws[0], "step2/",
                 envelope(draws, "step2/"))


def test_tp_first_step_matches_jax_unsharded(tp_run):
    ranks, *_, jax_first = tp_run
    check_terms(ranks[0]["straight"][0], jax_first,
                ("total", "depth_l1", "seg_ce", "grad_norm"))


def test_tp_matches_unsharded_training(tp_run):
    ranks, *_, records, _, _ = tp_run
    for r in ranks:
        assert [x["step"] for x in r["straight"]] == [1, 2, 3, 4]
        np.testing.assert_allclose([x["total"] for x in r["straight"]],
                                   [x["total"] for x in records],
                                   rtol=2e-4, atol=2e-5)
        assert r["straight"] == ranks[0]["straight"]
    check_terms(ranks[0]["straight"][0], records[0],
                ("total", "depth_l1", "seg_ce", "grad_norm"))


def test_tp_replicated_params_equal_across_ranks(tp_run):
    assert len({r["replicated_digest"] for r in tp_run[0]}) == 1


def test_tp_resume_is_bit_for_bit(tp_run):
    for r in tp_run[0]:
        assert [x["step"] for x in r["resumed"]] == [3, 4]
        assert r["resumed"] == r["straight"][2:]


def test_tp_checkpoint_restores_into_one_process(tp_run):
    """The run's last checkpoint holds whole tensors (rank 0 gathered the
    shards and the moments), equal to the final parameters; one process
    restores it and evaluates as the ranks did."""
    ranks, _, cfg, where, *_ = tp_run
    final = torch.load(where / "final.pt", weights_only=True)
    state = TT.create_train_state(cfg, "cpu")
    assert CheckpointManager(str(where / "ck")).restore_latest(state)
    assert state.step == 4
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), final[name]), name
    for mu, p in zip(state.optimizer.mu, state.model.parameters()):
        assert mu.shape == p.shape
    want = evaluate(cfg, state.model)
    for r in ranks:
        got = r["eval"]
        assert got["eval_batches"] == want["eval_batches"]
        for k in ("rmse", "abs_rel", "delta1", "miou"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_tp_collectives_backward(tp_run):
    """float64, against autograd of the unsharded op: the gather followed
    by a loss every rank computes alike (counted once) gives this rank's
    slice of the gradient; ``enter`` followed by a loss of each rank's own
    gives the sum of their gradients."""
    arrays = tp_run[1]

    def seeded(seed):
        return torch.tensor(np.random.default_rng(seed).normal(
            size=(3, 8, 2, 2)))

    x = seeded(1).requires_grad_()
    (x * seeded(2)).sum().backward()
    gathered = x.grad
    x = seeded(1).requires_grad_()
    sum((x * seeded(10 + j)).sum() for j in range(2)).backward()
    entered = x.grad
    for j, a in enumerate(arrays):
        np.testing.assert_array_equal(a["gather/y"], seeded(1).numpy())
        np.testing.assert_allclose(a["gather/dx"],
                                   gathered[:, 4 * j:4 * (j + 1)].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(a["enter/dx"], entered.numpy(),
                                   rtol=1e-12)


def test_tp_group_norm_straddling_shards(tp_run):
    """3 groups over 6 channels on 2 ranks (a group across the shard edge):
    the channels, scale and bias are gathered first; output, input and
    parameter gradients as the unsharded layer's."""
    arrays = tp_run[1]
    gn, x, r = straddling_group_norm()
    x = x.clone().requires_grad_()
    y = gn(x)
    (y * r).sum().backward()
    for j, a in enumerate(arrays):
        rows = slice(3 * j, 3 * (j + 1))
        for key, want in (("y", y.detach()), ("dx", x.grad[:, rows]),
                          ("dw", gn.weight.grad[rows]),
                          ("db", gn.bias.grad[rows])):
            np.testing.assert_allclose(a[f"gn/{key}"], want.numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("heads", [1, 2])
def test_tp_fusion_layer_matches_unsharded(tp_run, heads):
    """The fusion layer over the model axis (one head over both ranks'
    channels; two heads, one a rank) against the unsharded layer."""
    ranks, arrays = tp_run[0], tp_run[1]
    want = unsharded_fusion(heads)
    for j, a in enumerate(arrays):
        pre = f"fusion{heads}/"
        np.testing.assert_allclose(a[pre + "y"], want["y"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(a[pre + "dx"], want["dx"], rtol=TOL,
                                   atol=TOL)
        for name, g in want["d"].items():
            got = a[pre + "d/" + name]
            if got.shape != g.shape:  # this rank's rows of a sharded leaf
                n = got.shape[0]
                g = g[j * n:(j + 1) * n]
            np.testing.assert_allclose(got, g, rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_bench_records_over_two_ranks(tp_run):
    ranks = tp_run[0]
    scaling, overlap = ranks[0]["scaling"], ranks[0]["overlap"]
    assert [r["devices"] for r in scaling] == [1, 2]
    for rec in scaling:
        assert {"bench", "devices", "edges", "topology", "exchange",
                "edges_per_s", "efficiency", "backend"} <= set(rec)
    assert {"boundary_fraction", "recv_rows_per_shard"} <= set(scaling[1])
    assert [r.get("overlap") for r in overlap] == [True, False, None]
    for rec in overlap[:2]:
        assert rec["devices"] == 2 and rec["sec_per_call"] > 0
        assert rec["n_exchanges"] == 2 and rec["overlap_window_ms"] >= 0
    assert overlap[2]["bench"] == "overlap_summary"
    assert np.isfinite(overlap[2]["speedup_vs_serialized"])
    for r in ranks[1:]:
        assert r["scaling"] == scaling and r["overlap"] == overlap


@pytest.mark.slow
@pytest.mark.parametrize("heads", [1, 2])
def test_tp_composes_with_graph_partitioning(tmp_path_factory, heads):
    """The (2, 2, 2) mesh (attention fusion over the partitioned graph, with
    one and two heads) against one process: the first step's terms within
    1e-5 relative and 3 steps within the JAX tests' tolerance."""
    job = dict(JOB, steps=3, bench=False, model=dict(attention_heads=heads),
               data=dict(num_robots=16, num_eval_scenes=4),
               parallel=dict(data_axis_size=2, graph_axis_size=2,
                             model_axis_size=2))
    ranks, _, _, _, records, _, jax_first = run_job(
        job, tmp_path_factory, 8, f"tp222h{heads}")
    check_terms(ranks[0]["straight"][0], records[0])
    check_terms(ranks[0]["straight"][0], jax_first)
    np.testing.assert_allclose([x["total"] for x in ranks[0]["straight"]],
                               [x["total"] for x in records],
                               rtol=5e-4, atol=5e-5)
