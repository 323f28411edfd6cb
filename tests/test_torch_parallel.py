"""The port's partitioned fusion over real gloo ranks against the JAX
package's partitioned fusion on 8 virtual CPU devices (``tests/conftest.py``).

Eight processes (``tests/torch_parallel_worker.py``) join one gloo group
through a ``file://`` store, and run every case once, each on its own mesh:
attention, mean and max over a graph axis of 8 and over data x graph 2 x 4,
with the boundary exchange (overlap on and off) and the all_gather one;
the plain ops beside the kernels' plain versions; a radius swarm whose
scenes straddle shards; the JAX high-degree test's graph over 2 x 4 and,
past ELL width 128 (the row-expanded path), over 4 x 2; a dynamic batch with
its per-batch plan; and the global loss terms. Each case's output and
gradients, gathered from the ranks in rank order, must match JAX within
1e-5.

Four more ranks train a small ``swarm_partitioned`` over a 2 x 2 mesh, and
a small ``dynamic_swarm`` (a new plan every batch) over 1 x 4, through
``train.train`` (checkpoints, a resume, ``evaluate`` with the context)
against one process training the same config.

Slow tier (``-m slow``; each spawns its own ranks and trains on both
sides): 8 gloo ranks train a small ``swarm_partitioned`` from the JAX
package's initial weights against JAX's partitioned training on 8 virtual
devices, and the train CLI runs over two processes against one.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as JG
from mrp_gnn_tpu.ops import dispatch as jdispatch
from mrp_gnn_tpu.parallel import partition as JP
from mrp_gnn_tpu.parallel.fused import make_partitioned_edge_fusion
from mrp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mrp_gnn_tpu_torch import losses as TL
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.evaluate import evaluate
from mrp_gnn_tpu_torch.parallel import launch, mesh as TM
from torch_parallel_worker import job_config
from torch_small import small

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
WORLD = 8
TIMEOUT_S = 300
TOL = 1e-5
# graph kind -> (per-replica node count of a static graph, D, dk)
SHAPES = {"fc": (16, 24, 8), "radius": (128, 16, 8), "hideg": (512, 32, 8),
          "dynamic": (128, 12, 8)}


def _case(aggregation, data, graph, exchange="boundary", overlap=True,
          impl="pallas", graph_kind="fc"):
    tag = (f"{aggregation}-{data}x{graph}-{exchange}"
           f"{'' if overlap else '-serial'}-{impl}-{graph_kind}")
    return dict(name=tag, aggregation=aggregation, data=data, graph=graph,
                exchange=exchange, overlap=overlap, impl=impl,
                graph_kind=graph_kind)


CASES = [_case(agg, d, g, ex, ov)
         for agg in ("attention", "mean", "max")
         for d, g in ((1, 8), (2, 4))
         for ex, ov in (("boundary", True), ("boundary", False),
                        ("all_gather", True))]
CASES += [
    _case("attention", 1, 8, impl="xla"),
    _case("attention", 1, 8, graph_kind="radius"),
    _case("mean", 1, 8, graph_kind="radius"),
    _case("attention", 2, 4, graph_kind="hideg"),
    _case("attention", 4, 2, graph_kind="hideg"),
    _case("attention", 2, 4, graph_kind="dynamic"),
    _case("attention", 2, 4, overlap=False, graph_kind="dynamic"),
]


def _inputs(case):
    n_rep, D, dk = SHAPES[case["graph_kind"]]
    V = n_rep if case["graph_kind"] == "dynamic" else n_rep * case["data"]
    rng = np.random.default_rng(len(case["name"]))
    return {f"{case['name']}/{k}": rng.normal(size=(V, w)).astype(np.float32)
            for k, w in (("q", dk), ("k", dk), ("v", D))}


LOSS_V, LOSS_H, LOSS_W, LOSS_K = 16, 6, 5, 4


def _loss_inputs():
    rng = np.random.default_rng(7)
    pred = rng.uniform(0.2, 9.0, size=(LOSS_V, LOSS_H, LOSS_W))
    target = rng.uniform(0.0, 9.0, size=pred.shape)
    target[target < 1.0] = 0.0  # pixels without ground truth
    logits = rng.normal(size=(LOSS_V, LOSS_H, LOSS_W, LOSS_K))
    labels = rng.integers(0, LOSS_K, size=pred.shape)
    node_mask = np.arange(LOSS_V) < LOSS_V - 3
    return {"loss/pred": pred.astype(np.float32),
            "loss/target": target.astype(np.float32),
            "loss/logits": logits.astype(np.float32),
            "loss/labels": labels.astype(np.int32),
            "loss/node_mask": node_mask}


def _tail(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()[-3000:]
    except OSError:
        return "(no log)"


def spawn_ranks(where, world: int = WORLD, timeout_s: float = TIMEOUT_S):
    """Run the worker on ``world`` gloo ranks over ``where``; fails with the
    log of each failing rank, and kills every rank on a timeout."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [os.path.join(where, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world),
                 os.path.join(where, "store"), str(where)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout_s
    try:
        # a failed rank leaves the others waiting on it: stop at the first
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exit {procs[r].returncode}:\n"
                              f"{_tail(logs[r])}" for r in bad)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's output and gradients, gathered from the 8 ranks."""
    where = tmp_path_factory.mktemp("ranks")
    inputs = {}
    for case in CASES:
        inputs.update(_inputs(case))
    inputs.update(_loss_inputs())
    np.savez(where / "inputs.npz", **inputs)
    with open(where / "cases.json", "w") as f:
        json.dump(CASES, f)
    spawn_ranks(str(where))
    parts = [np.load(where / f"rank{r}.npz") for r in range(WORLD)]
    gathered = {k: np.concatenate([p[k] for p in parts])
                for k in parts[0].files if not k.startswith("loss/")}
    gathered.update({k: np.stack([p[k] for p in parts])
                     for k in parts[0].files if k.startswith("loss/")})
    return inputs, gathered


def _jax_graph(kind):
    if kind == "fc":
        return JG.batch_fully_connected(2, 8)
    if kind == "radius":
        return JG.batch_homogeneous(4, 32, JG.radius_edges(32, 4))
    if kind == "hideg":
        return JG.batch_homogeneous(2, 193, JG.fully_connected_edges(193),
                                    max_nodes=512)
    S, N = 4, 32
    rng = np.random.default_rng(0)
    base = np.linspace(0, N - 1, N).astype(np.float64)
    pos = [base + rng.uniform(-1.5, 1.5, N) for _ in range(S)]
    return JG.batch_from_positions(pos, radius=4.0, max_nodes=S * N,
                                   max_edges=S * N * (N - 1),
                                   max_degree=N - 1, backend="numpy")


def _jax_case(case, inputs):
    """(output, {name: gradient}) of JAX's partitioned fusion."""
    data, graph_ax = case["data"], case["graph"]
    mesh = jax_make_mesh(data, graph_ax)
    gb = _jax_graph(case["graph_kind"])
    if case["graph_kind"] == "dynamic":
        full = JG.batch_fully_connected(4 // data, 32,
                                        max_nodes=gb.max_nodes // data)
        cap_plan = JP.partition_graph(full, graph_ax)
        gb = dataclasses.replace(gb, partition_plan=JP.partition_batch(
            gb, data, graph_ax, JP.capacities_of(cap_plan)))
        edge_fn = make_partitioned_edge_fusion(
            mesh, cap_plan, case["exchange"], case["overlap"], dynamic=True)
    else:
        edge_fn = make_partitioned_edge_fusion(
            mesh, JP.partition_graph(gb, graph_ax), case["exchange"],
            case["overlap"])
    ops = jdispatch.get_ops("xla")
    agg = case["aggregation"]
    name = case["name"]
    v = jnp.asarray(inputs[f"{name}/v"])
    if agg == "attention":
        q, k = jnp.asarray(inputs[f"{name}/q"]), jnp.asarray(inputs[f"{name}/k"])

        def loss(q, k, v):
            return jnp.sum(edge_fn(ops, agg, q, k, v, gb) ** 2)

        out = jax.jit(lambda q, k, v: edge_fn(ops, agg, q, k, v, gb))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        return out, dict(zip(("dq", "dk", "dv"), grads))
    out = jax.jit(lambda v: edge_fn(ops, agg, None, None, v, gb))(v)
    dv = jax.jit(jax.grad(lambda v: jnp.sum(
        edge_fn(ops, agg, None, None, v, gb) ** 2)))(v)
    return out, {"dv": dv}


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_partitioned_fusion_matches_jax(ranks, case):
    inputs, got = ranks
    want_out, want_grads = _jax_case(case, inputs)
    name = case["name"]
    np.testing.assert_allclose(got[f"{name}/out"], np.asarray(want_out),
                               rtol=TOL, atol=TOL, err_msg="out")
    for key, want in want_grads.items():
        np.testing.assert_allclose(got[f"{name}/{key}"], np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("depth_loss", sorted(TL.DEPTH_LOSSES))
def test_global_loss_terms_over_ranks(ranks, depth_loss):
    """Each rank's terms from its 2 node rows under the mesh are the whole
    batch's terms, on every rank, and the ranks' gradients of the total
    are the rows of the whole batch's gradient."""
    inputs, got = ranks
    pred = torch.tensor(inputs["loss/pred"], requires_grad=True)
    batch = {"depth": torch.tensor(inputs["loss/target"]),
             "seg": torch.tensor(inputs["loss/labels"])}
    out = {"depth": pred, "seg_logits": torch.tensor(inputs["loss/logits"])}
    loss, terms = TL.total_loss(out, batch,
                                torch.tensor(inputs["loss/node_mask"]),
                                depth_loss=depth_loss)
    loss.backward()
    for key, want in terms.items():
        np.testing.assert_allclose(got[f"loss/{depth_loss}/{key}"],
                                   np.full(WORLD, want.item()), rtol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(
        got[f"loss/{depth_loss}/dpred"].reshape(pred.shape),
        pred.grad.numpy(), rtol=TOL, atol=1e-9)


@pytest.mark.parametrize("depth_loss", sorted(TL.DEPTH_LOSSES))
def test_loss_terms_take_one_all_reduce(monkeypatch, depth_loss):
    """Under a mesh, every term's sums and counts go into one all-reduce
    (berHu's max takes one all-gather more, and its backward one sum); in a
    world of one rank the terms and gradients are those without a mesh,
    bit for bit."""
    calls = []

    def all_reduce(t, *args, **kw):
        calls.append(("all_reduce", t.dtype, t.numel()))

    def all_gather(parts, t, group=None):
        calls.append(("all_gather", t.dtype, t.numel()))
        parts[0].copy_(t)

    monkeypatch.setattr(TM.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(TM.dist, "all_gather", all_gather)
    monkeypatch.setattr(TM.dist, "get_world_size", lambda group=None: 1)
    mesh = TM.Mesh(data=1, graph=1, rank=0, backend="gloo", graph_group=None,
                   graph_ranks=(0,))
    rng = np.random.default_rng(0)
    V, H, W, K = 4, 3, 5, 6
    target = rng.uniform(0.5, 4.0, (V, H, W)).astype(np.float32)
    target[rng.random((V, H, W)) < 0.3] = 0
    pred_np = rng.uniform(0.5, 4.0, (V, H, W)).astype(np.float32)
    logits_np = rng.normal(size=(V, H, W, K)).astype(np.float32)
    batch = {"depth": torch.tensor(target),
             "seg": torch.tensor(rng.integers(0, K, (V, H, W)))}
    node_mask = torch.tensor([True, True, True, False])
    res = []
    for m in (None, mesh):
        pred = torch.tensor(pred_np, requires_grad=True)
        logits = torch.tensor(logits_np, requires_grad=True)
        out = {"depth": pred, "seg_logits": logits}
        loss, terms = TL.total_loss(out, batch, node_mask, 1.0, 0.5,
                                    depth_loss=depth_loss, mesh=m)
        forward = list(calls)
        loss.backward()
        res.append((terms, pred.grad, logits.grad))
    backward = calls[len(forward):]
    sums = ("all_reduce", torch.float64, 4 + (depth_loss == "silog"))
    if depth_loss == "berhu":    # the max, then the sums
        assert forward == [("all_gather", torch.float32, 1), sums]
        assert backward == [("all_reduce", torch.float32, 1)]
    else:
        assert forward == [sums] and backward == []
    (terms, dpred, dlogits), (mterms, mdpred, mdlogits) = res
    for key in terms:
        assert torch.equal(terms[key], mterms[key]), key
    assert torch.equal(dpred, mdpred) and torch.equal(dlogits, mdlogits)


def test_mesh_needs_enough_ranks():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.make_mesh(2, 1)  # no process group: a world of one rank
    with pytest.raises(ValueError, match="needs 4 ranks"):
        TM.make_mesh(1, 2, 2)


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        launch.initialize("localhost:1",
                          num_processes=torch.cuda.device_count() + 1,
                          process_id=0, backend="nccl")
    # the launcher's count of this host's ranks, whatever the coordinator
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        launch.initialize("node0:1", num_processes=64, process_id=0,
                          backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        launch.initialize("localhost:1", 2, 0, backend="mpi")
    launch.initialize(None)  # no coordinator: nothing to do


def test_ranks_on_this_host(monkeypatch):
    """Known from the launcher, or from a loopback coordinator, which only
    this host's ranks can reach; else unknown, so that a multi-host NCCL
    run (e.g. 16 ranks over two hosts of 8 cards) is not refused."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for coordinator in ("localhost:29500", "127.0.0.1:29500",
                        "tcp://localhost:29500", "[::1]:29500"):
        assert launch._ranks_on_this_host(coordinator, 16) == 16
    assert launch._ranks_on_this_host("node0:29500", 16) is None
    assert launch._ranks_on_this_host("file:///tmp/store", 16) is None
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert launch._ranks_on_this_host("node0:29500", 16) == 8


def test_rank_device():
    assert launch.rank_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.rank_device()


# 2 scenes of 16 robots in radius 3 over a 2 x 2 mesh: each replica's scene
# straddles its two graph shards of 8 robots.
TRAIN_JOB = dict(config="swarm_partitioned", steps=4,
                 data=dict(num_robots=16, scenes_per_batch=2, comm_radius=3,
                           num_eval_scenes=4),
                 parallel=dict(data_axis_size=2, graph_axis_size=2))
# 2 scenes of 8 drifting robots over a graph axis of 4: a new radius graph
# and a new partition plan every batch (ParallelContext.attach_plan).
DYNAMIC_JOB = dict(config="dynamic_swarm", steps=4, data=dict(num_eval_scenes=4),
                   parallel=dict(data_axis_size=1, graph_axis_size=4))
TRAIN_RANKS = 4


@pytest.fixture(scope="module", params=[TRAIN_JOB, DYNAMIC_JOB],
                ids=["static-2x2", "dynamic-1x4"])
def trained(request, tmp_path_factory):
    """(each rank's records, digest and eval; one process's records of the
    same config, its mesh shrunk to one rank; the ranks' config)."""
    job = request.param
    where = tmp_path_factory.mktemp("train_ranks")
    with open(where / "train.json", "w") as f:
        json.dump(job, f)
    spawn_ranks(str(where), world=TRAIN_RANKS)
    ranks = []
    for r in range(TRAIN_RANKS):
        with open(where / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    one = tmp_path_factory.mktemp("train_one")
    cfg = job_config(job, str(one), get_config, small)
    _, records = TT.train(cfg, device="cpu")
    single = [r for r in records if "total" in r]
    return ranks, single, cfg, where


def test_train_over_ranks_matches_one_process(trained):
    """The first step's terms within 1e-5 of one process's (later steps may
    drift apart by rounding: Adam magnifies it); every rank logs the same
    records."""
    ranks, single, _, _ = trained
    first = ranks[0]["straight"][0]
    assert first["step"] == 1
    for k in ("total", "depth_l1", "seg_ce", "grad_norm"):
        np.testing.assert_allclose(first[k], single[0][k], rtol=TOL,
                                   err_msg=k)
    assert len(ranks[0]["straight"]) == len(single) == 4
    for r in ranks[1:]:
        assert r["straight"] == ranks[0]["straight"]


def test_ranks_end_with_equal_parameters(trained):
    ranks = trained[0]
    assert len({r["digest"] for r in ranks}) == 1


def test_resume_over_ranks_is_bit_for_bit(trained):
    """A resume from the step-2 checkpoint repeats steps 3-4 exactly."""
    for r in trained[0]:
        assert [x["step"] for x in r["resumed"]] == [3, 4]
        assert r["resumed"] == r["straight"][2:]


def test_partitioned_eval_matches_one_process(trained):
    ranks, _, cfg, where = trained
    model = TT.create_train_state(cfg, "cpu").model
    model.load_state_dict(torch.load(where / "final.pt", weights_only=True))
    want = evaluate(cfg, model)
    for r in ranks:
        got = r["eval"]
        assert got["eval_batches"] == want["eval_batches"]
        for k in ("rmse", "abs_rel", "delta1", "miou"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def _jax_initial_checkpoint(jcfg, tcfg, directory: str) -> None:
    """The JAX package's seeded initial parameters, moved into the port's
    model and saved as the port's step-0 checkpoint in ``directory`` (a run
    with that checkpoint_dir restores them and trains from step 0)."""
    from mrp_gnn_tpu import train as JT
    from mrp_gnn_tpu.data.pipeline import make_dataset as jax_dataset
    from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
    from mrp_gnn_tpu_torch.models.transplant import load_flax_params
    batch = next(iter(jax_dataset(jcfg.data, "train")))
    state, _ = JT.create_train_state(jcfg, jax.random.PRNGKey(jcfg.train.seed),
                                     batch)
    tstate = TT.create_train_state(tcfg, "cpu")
    load_flax_params(tstate.model, jax.tree.map(np.asarray, state.params))
    CheckpointManager(directory).save(0, tstate)


@pytest.mark.slow
def test_partitioned_training_matches_jax(tmp_path):
    """3 steps of a small ``swarm_partitioned`` (2 scenes x 16 robots in
    radius 3 over a graph axis of 8, 4 robots a rank) from the same weights:
    the port over 8 gloo ranks, JAX's partitioned training on 8 virtual
    devices. Held within 1e-5 relative: step 1's terms and grad norm, and
    step 2's loss terms (the first update has lr 0, so step 2 runs the
    initial weights on the second batch). Printed, not held: step 2's grad
    norm and step 3. At these weights the second batch's gradient is
    discontinuous (a ReLU gate flips): the test prints one process's step-2
    grad norm with the images as they are and scaled by 1 + 1e-7, which
    lands on the ranks' value; Adam carries the jump into step 3."""
    from mrp_gnn_tpu import train as JT
    from mrp_gnn_tpu.config import get_config as jax_config
    job = dict(TRAIN_JOB, steps=3,
               parallel=dict(data_axis_size=1, graph_axis_size=8))
    tcfg = job_config(job, str(tmp_path), get_config, small)
    jcfg = small(jax_config("swarm_partitioned"), impl="xla",
                 data=job["data"], log_every=1)
    jcfg = jcfg.replace(parallel=dataclasses.replace(
        jcfg.parallel, data_axis_size=1, graph_axis_size=8))
    for d in ("ck", "init"):
        _jax_initial_checkpoint(jcfg, tcfg, str(tmp_path / d))
    with open(tmp_path / "train.json", "w") as f:
        json.dump(job, f)
    spawn_ranks(str(tmp_path), world=WORLD)
    with open(tmp_path / "rank0.json") as f:
        got = json.load(f)["straight"]
    _, records = JT.train(jcfg, num_steps=3)
    want = [r for r in records if "total" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        print("ranks", g, "jax", {k: w[k] for k in g})
    held = [(0, ("total", "depth_l1", "seg_ce", "grad_norm")),
            (1, ("total", "depth_l1", "seg_ce"))]
    for i, keys in held:
        for k in keys:
            np.testing.assert_allclose(got[i][k], want[i][k], rtol=TOL,
                                       err_msg=f"step {i + 1} {k}")
    print("one process, step 2's grad norm with the images scaled by 1 and "
          "by 1 + 1e-7:", _step2_grad_norms(tcfg, str(tmp_path / "init"),
                                            (1.0, 1.0 + 1e-7)))


def _step2_grad_norms(cfg, init_dir: str, scales) -> list:
    """One process's gradient norm on the second batch from the step-0
    checkpoint in ``init_dir`` (the first update has lr 0, so this is step
    2's), with the images scaled by each of ``scales``."""
    from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
    from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
    state = TT.create_train_state(cfg, "cpu")
    CheckpointManager(init_dir).restore_latest(state)
    it = make_train_iterator(cfg.data)
    next(it)
    images, depth, seg, graph = TT.batch_to_device(next(it), "cpu")
    it.close()
    params = list(state.model.parameters())
    norms = []
    for scale in scales:
        out = state.model(images * scale, graph, ops_impl=cfg.parallel.ops_impl)
        loss, _ = TL.total_loss(out, {"depth": depth, "seg": seg},
                                graph.node_mask, cfg.train.depth_loss_weight,
                                cfg.train.seg_loss_weight)
        grads = torch.autograd.grad(loss, params)
        norms.append(float(torch.sqrt(sum((g ** 2).sum() for g in grads))))
    return norms


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _losses(out: str) -> list:
    return [json.loads(line)["total"] for line in out.splitlines()
            if line.startswith("{") and '"total"' in line]


@pytest.mark.slow
def test_train_cli_over_two_processes():
    """``python -m mrp_gnn_tpu_torch.train`` over two gloo processes
    (--coordinator, --num_processes, --process_id, --dist_backend gloo;
    graph axis 2): rank 0 alone logs the records, which match one process
    running the same command without the flags (its mesh shrunk)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    base = [sys.executable, "-m", "mrp_gnn_tpu_torch.train", "--config",
            "two_robot_mean", "--steps", "3", "--train_scenes", "8",
            "--log_every", "1", "--graph_axis", "2", "--device", "cpu"]
    port = _free_port()
    procs = [subprocess.Popen(
        base + ["--coordinator", f"localhost:{port}", "--num_processes", "2",
                "--process_id", str(r), "--dist_backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert "final loss" in out
    assert len(_losses(outs[0])) == 3 and not _losses(outs[1])
    one = subprocess.run(base, capture_output=True, text=True, env=env,
                         timeout=TIMEOUT_S)
    assert one.returncode == 0, one.stdout[-2000:] + one.stderr[-2000:]
    assert "clamped to 1x1x1" in one.stdout
    np.testing.assert_allclose(_losses(outs[0]), _losses(one.stdout),
                               rtol=TOL)
