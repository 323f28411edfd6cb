"""Spatial sharding of the port (``parallel/spatial.py``: image rows over
the model axis) over gloo ranks on the CPU, against the port on one
process and the JAX package.

Eight ranks (``tests/torch_parallel_worker.py``) on a (2, 1, 4) mesh with
``spatial_sharding`` run a small ``dynamic_swarm`` at 32 x 32 (encoder
16/32/64: 8 image rows a rank, 1 at the bottleneck; each data replica's
graph is a one-shard partitioned fusion) from the JAX package's initial
weights: the collectives at float64 (halo rows of a stride-1 and a stride-2
convolution, the group sum of GroupNorm's statistics, the pooled mean), the
fusion layer with one and two heads, the first step's terms and gradients,
4 steps of ``train.train`` with checkpoints, a resume and ``evaluate``.
Held as ``tests/test_torch_tp.py`` holds tensor parallelism. Slow tier:
``tests/test_spatial.py``'s own case, ``two_robot_mean`` at 16 x 16.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.parallel import spatial
from test_torch_tp import TOL, check_leaves, check_terms, envelope, run_job
from torch_parallel_worker import unsharded_fusion

JOB = dict(config="dynamic_swarm", steps=4,
           data=dict(num_eval_scenes=4, image_size=[32, 32]),
           model=dict(image_size=[32, 32]),
           parallel=dict(data_axis_size=2, model_axis_size=4,
                         spatial_sharding=True))
M = 4


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    return run_job(JOB, tmp_path_factory, 8, "spatial")


def test_spatial_rows_must_divide():
    """16 x 16 images over 4 shards leave half a row after the third
    stride-2 stage: refused, naming the stage and the shape; 32 x 32 and
    the JAX test's 16 x 16 with two stages divide."""
    with pytest.raises(ValueError, match=r"encoder stage down2.*2 x 2.*"
                                         r"0\.5 rows"):
        spatial.check_rows((16, 16), (16, 32, 64), 4)
    spatial.check_rows((32, 32), (16, 32, 64), 4)
    spatial.check_rows((16, 16), (8, 16), 4)


def test_spatial_batch_placement(sp_run):
    """Each rank holds its node block's 8 views and its 8 of 32 image rows;
    the parameters stay whole and equal on every rank."""
    ranks = sp_run[0]
    full = dict(TT.create_train_state(sp_run[2], "cpu")
                .model.named_parameters())
    for r in ranks:
        assert r["batch_shapes"] == [[8, 8, 32, 3], [8, 8, 32], [8, 8, 32]]
        assert r["sharded"] == []
        assert r["shapes"] == {n: list(p.shape) for n, p in full.items()}
    assert len({r["replicated_digest"] for r in ranks}) == 1


def test_spatial_first_step_matches_one_process(sp_run):
    """The terms within 1e-5 relative. The gradients, and the parameters
    after the second update (the first with lr above 0), leaf by leaf
    within :func:`test_torch_tp.envelope` of one process's runs with each
    pixel scaled by 1 +- 1e-7 (``one_process``'s draws): the row shards'
    convolutions round otherwise than the whole image's, and where a ReLU
    gate's input lies within that rounding of 0 the gradient of the weights
    before it jumps (at these weights
    ``encoder.res1.ConvBlock_0.Conv_0.weight``'s, by 3.09e-3 of its largest
    element in about a third of the draws). Tensor parallelism computes
    each output channel from the same input as one process and its
    gradients are held at 1e-5."""
    ranks, arrays, _, _, records, draws, _ = sp_run
    for r in ranks:
        check_terms(r["first"], records[0])
    for prefix in ("grad/", "step2/"):
        bound = envelope(draws, prefix)
        for a in arrays:
            check_leaves(a, draws[0], prefix, bound)


def test_spatial_first_step_matches_jax_unsharded(sp_run):
    ranks, *_, jax_first = sp_run
    check_terms(ranks[0]["straight"][0], jax_first)


def test_spatial_matches_unsharded_training(sp_run):
    ranks, *_, records, _, _ = sp_run
    for r in ranks:
        assert [x["step"] for x in r["straight"]] == [1, 2, 3, 4]
        np.testing.assert_allclose([x["total"] for x in r["straight"]],
                                   [x["total"] for x in records],
                                   rtol=2e-4, atol=2e-5)
        assert r["straight"] == ranks[0]["straight"]
    check_terms(ranks[0]["straight"][0], records[0])


def test_spatial_resume_is_bit_for_bit(sp_run):
    for r in sp_run[0]:
        assert [x["step"] for x in r["resumed"]] == [3, 4]
        assert r["resumed"] == r["straight"][2:]


def test_spatial_eval_matches_one_process(sp_run):
    import torch
    from mrp_gnn_tpu_torch.evaluate import evaluate
    ranks, _, cfg, where, *_ = sp_run
    model = TT.create_train_state(cfg, "cpu").model
    model.load_state_dict(torch.load(where / "final.pt", weights_only=True))
    want = evaluate(cfg, model)
    for r in ranks:
        got = r["eval"]
        assert got["eval_batches"] == want["eval_batches"]
        for k in ("rmse", "abs_rel", "delta1", "miou"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def _seeded(shape, seed):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape))


def _unsharded(op, loss_of):
    """(op(x), the gradient of x) for the whole seeded input x, the loss the
    sum over the model group's ranks j of ``loss_of(op(x), j)``: the
    unsharded op under the ranks' losses, by autograd."""
    x = _seeded((2, 3, 8, 4), 1).requires_grad_()
    y = op(x)
    sum(loss_of(y, j) for j in range(M)).backward()
    return y, x.grad


def test_spatial_collectives_backward(sp_run):
    """float64, on each rank of a model group, against autograd of the
    unsharded op: halo rows (their gradients go back to their owners), the
    group sum, GroupNorm's statistics and the pooled mean (their backward
    sums the ranks' gradients)."""
    arrays = sp_run[1]
    h = 8 // M
    want = {}
    for name, top, bottom in (("halo1", 1, 1), ("halo2", 0, 1)):
        rows = top + h + bottom
        y, dx = _unsharded(
            lambda x: F.pad(x, (0, 0, top, bottom)),
            lambda y, j: (y[:, :, j * h:j * h + rows]
                          * _seeded((2, 3, rows, 4), 20 + j)).sum())
        want[name] = ([y[:, :, j * h:j * h + rows] for j in range(M)], dx)
    for name, op, seeds in (
            ("sum", lambda x: x.sum(dim=(2, 3)), (30,)),
            ("mean", lambda x: x.mean(dim=(2, 3)), (40,)),
            ("stats", lambda x: torch.stack([
                x.reshape(2, 3, -1).mean(-1),
                x.reshape(2, 3, -1).var(-1, unbiased=False)]), (50, 60))):
        y, dx = _unsharded(op, lambda y, j, seeds=seeds: sum(
            (y[i] if len(seeds) > 1 else y) * _seeded((2, 3), s + j)
            for i, s in enumerate(seeds)).sum())
        want[name] = ([y] * M, dx)
    for r, a in enumerate(arrays):
        j = r % M
        for name, (ys, dx) in want.items():
            np.testing.assert_allclose(a[f"{name}/y"], ys[j].detach().numpy(),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
            np.testing.assert_allclose(a[f"{name}/dx"],
                                       dx[:, :, j * h:(j + 1) * h].numpy(),
                                       rtol=1e-12, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
def test_spatial_fusion_layer_matches_unsharded(sp_run, heads):
    """The fusion layer on each rank's rows: its rows of the output and of
    the input's gradient, and the parameters' gradients summed over a model
    group, against the whole layer's."""
    arrays = sp_run[1]
    want = unsharded_fusion(heads)
    pre = f"fusion{heads}/"
    for r, a in enumerate(arrays):
        j = r % M
        np.testing.assert_allclose(a[pre + "y"], want["y"][:, :, j:j + 1],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(a[pre + "dx"], want["dx"][:, :, j:j + 1],
                                   rtol=TOL, atol=TOL)
    for name, g in want["d"].items():
        got = sum(arrays[r][pre + "d/" + name] for r in range(M))
        np.testing.assert_allclose(got, g, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.slow
def test_spatial_sharding_matches_unsharded(tmp_path_factory):
    """``tests/test_spatial.py``'s case: ``two_robot_mean`` at 16 x 16,
    encoder 8/16, (2, 1, 4) spatial against one process, 3 steps."""
    job = dict(config="two_robot_mean", steps=3, bench=False,
               data=dict(num_robots=2, scenes_per_batch=4, num_eval_scenes=2),
               model=dict(encoder_channels=[8, 16]),
               parallel=dict(data_axis_size=2, model_axis_size=4,
                             spatial_sharding=True))
    ranks, _, _, _, records, _, jax_first = run_job(job, tmp_path_factory, 8,
                                                    "spatial_mean")
    check_terms(ranks[0]["straight"][0], records[0], ("total", "depth_l1"))
    check_terms(ranks[0]["straight"][0], jax_first, ("total", "depth_l1"))
    np.testing.assert_allclose([x["total"] for x in ranks[0]["straight"]],
                               [x["total"] for x in records],
                               rtol=2e-4, atol=2e-5)
