"""One rank of the port's partitioned fusion over gloo, for
``tests/test_torch_parallel.py`` (imports torch and the port, never JAX).

    python tests/torch_parallel_worker.py <rank> <world> <store> <dir>

With ``<dir>/train.json`` the rank runs :func:`train_job` and writes
``<dir>/rank<r>.json``; with ``<dir>/model_axis.json``,
:func:`model_axis_job` (for ``tests/test_torch_tp.py`` and
``tests/test_torch_spatial.py``), which writes ``<dir>/rank<r>.json`` and
``<dir>/rank<r>.npz``. Otherwise ``<dir>/cases.json`` lists the cases,
``<dir>/inputs.npz`` holds each case's global q, k and v (``<case>/q``
...). For each case the rank builds the case's mesh and plan, runs the
partitioned fusion on its node rows,
takes the backward of ``sum(out ** 2)`` and writes its rows of the output
and of the gradients to ``<dir>/rank<r>.npz``, with each depth loss's terms
and gradient over the rank's rows of ``loss/*`` under a mesh of the world.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mrp_gnn_tpu_torch import graph as G  # noqa: E402
from mrp_gnn_tpu_torch.ops import dispatch  # noqa: E402
from mrp_gnn_tpu_torch.parallel.fused import (  # noqa: E402
    make_partitioned_edge_fusion)
from mrp_gnn_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mrp_gnn_tpu_torch.parallel.partition import (  # noqa: E402
    capacities_of, partition_batch, partition_graph)


def dyn_positions(S, N, seed):
    """The seeded drifting robot positions of ``tests/test_dynamic.py``."""
    rng = np.random.default_rng(seed)
    base = np.linspace(0, N - 1, N).astype(np.float64)
    return [base + rng.uniform(-1.5, 1.5, N) for _ in range(S)]


def case_graph(kind: str, data: int):
    """(per-replica graph of a static case, or the whole batch's graph of a
    dynamic one) of the port, built as the test builds JAX's."""
    if kind == "fc":
        return G.batch_fully_connected(2, 8)
    if kind == "radius":
        return G.batch_homogeneous(4, 32, G.radius_edges(32, 4))
    if kind == "hideg":
        return G.batch_homogeneous(2, 193, G.fully_connected_edges(193),
                                   max_nodes=512)
    if kind == "dynamic":
        S, N = 4, 32
        return G.batch_from_positions(dyn_positions(S, N, 0), radius=4.0,
                                      max_nodes=S * N,
                                      max_edges=S * N * (N - 1),
                                      max_degree=N - 1, backend="numpy")
    raise ValueError(kind)


def run_case(case: dict, inputs, mesh_rank: int):
    name, data, graph_ax = case["name"], case["data"], case["graph"]
    mesh = make_mesh(data, graph_ax)
    gb = case_graph(case["graph_kind"], data)
    if case["graph_kind"] == "dynamic":
        v_rep = gb.max_nodes // data
        full = G.batch_fully_connected(4 // data, 32, max_nodes=v_rep)
        cap_plan = partition_graph(full, graph_ax)
        plan = partition_batch(gb, data, graph_ax, capacities_of(cap_plan))
        import dataclasses
        gb = dataclasses.replace(gb, partition_plan=plan)
        edge_fn = make_partitioned_edge_fusion(
            mesh, cap_plan, case["exchange"], case["overlap"], dynamic=True)
    else:
        plan = partition_graph(gb, graph_ax)
        edge_fn = make_partitioned_edge_fusion(mesh, plan, case["exchange"],
                                               case["overlap"])
    ops = dispatch.get_ops(case["impl"])
    n = inputs[f"{name}/v"].shape[0] // mesh.size
    rows = slice(mesh_rank * n, (mesh_rank + 1) * n)
    v = torch.tensor(inputs[f"{name}/v"][rows], requires_grad=True)
    if case["aggregation"] == "attention":
        q = torch.tensor(inputs[f"{name}/q"][rows], requires_grad=True)
        k = torch.tensor(inputs[f"{name}/k"][rows], requires_grad=True)
        leaves = {"q": q, "k": k, "v": v}
    else:
        q = k = None
        leaves = {"v": v}
    out = edge_fn(ops, case["aggregation"], q, k, v, gb)
    (out ** 2).sum().backward()
    res = {f"{name}/out": out.detach().numpy()}
    for key, t in leaves.items():
        res[f"{name}/d{key}"] = t.grad.numpy()
    return res


def run_losses(inputs, rank: int, world: int) -> dict:
    """Each depth loss's terms and the total's gradient of this rank's node
    rows of the loss inputs, under a mesh of the whole world."""
    from mrp_gnn_tpu_torch import losses as TL
    mesh = make_mesh(world, 1)
    n = inputs["loss/pred"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    res = {}
    for depth_loss in sorted(TL.DEPTH_LOSSES):
        pred = torch.tensor(inputs["loss/pred"][rows], requires_grad=True)
        out = {"depth": pred,
               "seg_logits": torch.tensor(inputs["loss/logits"][rows])}
        batch = {"depth": torch.tensor(inputs["loss/target"][rows]),
                 "seg": torch.tensor(inputs["loss/labels"][rows])}
        loss, terms = TL.total_loss(
            out, batch, torch.tensor(inputs["loss/node_mask"][rows]),
            depth_loss=depth_loss, mesh=mesh)
        loss.backward()
        for key, t in terms.items():
            res[f"loss/{depth_loss}/{key}"] = t.detach().numpy()
        res[f"loss/{depth_loss}/dpred"] = pred.grad.numpy()
    return res


def param_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(model.state_dict().items()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_job(where: str, rank: int) -> dict:
    """``train.train`` of ``<dir>/train.json``'s config on this rank: a
    straight run (checkpoints every 2 steps), a resume from its step-2
    checkpoint in a directory of its own, and ``evaluate`` of the straight
    run's model under the mesh. Rank 0 saves the final parameters."""
    import shutil
    from torch_small import small
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.evaluate import evaluate
    with open(os.path.join(where, "train.json")) as f:
        job = json.load(f)
    cfg = job_config(job, where, get_config, small)
    strip = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")

    def terms(records):
        return [{k: v for k, v in r.items() if k not in strip}
                for r in records if "total" in r]

    state, records = TT.train(cfg, device="cpu")
    out = {"straight": terms(records), "digest": param_digest(state.model)}
    if rank == 0:
        torch.save(state.model.state_dict(), os.path.join(where, "final.pt"))
        os.makedirs(os.path.join(where, "resume"))
        shutil.copy(os.path.join(where, "ck", "ckpt_2.pt"),
                    os.path.join(where, "resume"))
    dist.barrier()
    import dataclasses
    resumed = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(where, "resume")))
    _, records = TT.train(resumed, device="cpu")
    out["resumed"] = terms(records)
    out["eval"] = evaluate(cfg, state.model,
                           pctx=TT.make_parallel(cfg, "cpu"))
    return out


def job_config(job: dict, where: str, get_config, small):
    """The train job's config: ``small`` of the preset with the job's data,
    model and parallel overrides, checkpoints under ``<where>/ck``."""
    import dataclasses
    cfg = small(get_config(job["config"]), impl=job.get("impl", "pallas"),
                data=tuples(job.get("data")), log_every=1,
                checkpoint_every=2, checkpoint_dir=os.path.join(where, "ck"))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **tuples(job.get("model"))),
        train=dataclasses.replace(cfg.train, steps=job["steps"]),
        parallel=dataclasses.replace(cfg.parallel, **job["parallel"]))


def tuples(kw: dict | None) -> dict:
    """Config overrides read from JSON, lists back to tuples."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in (kw or {}).items()}


def first_batch(cfg, pctx=None):
    """The train stream's first batch as (images, depth, seg, graph): this
    rank's (``pctx``), or the whole batch."""
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.data.pipeline import make_train_iterator
    d = cfg.data
    it = make_train_iterator(d, node_range=pctx.local_node_range(
        d.max_nodes or d.scenes_per_batch * d.num_robots) if pctx else None)
    batch = next(it)
    it.close()
    if pctx is not None:
        return pctx.shard_batch(batch)
    return TT.batch_to_device(batch, "cpu")


def first_updates(cfg, state, batch, pctx=None) -> dict:
    """Two updates of ``state`` on ``batch``, the first at lr 0 (the warmup
    schedule's start), the second above it: the first step's loss terms
    ("terms"), its gradients ("grad/<name>") and the parameters after the
    second update ("step2/<name>"), as numpy; this rank's shards under
    tensor parallelism."""
    from mrp_gnn_tpu_torch import train as TT
    assert TT.warmup_cosine_lr(cfg, state.optimizer.count) == 0
    assert TT.warmup_cosine_lr(cfg, state.optimizer.count + 1) > 0
    grad_fn = TT.make_grad_fn(cfg, state.model, pctx)
    names = [n for n, _ in state.model.named_parameters()]
    params = list(state.model.parameters())
    mesh = pctx.mesh if pctx is not None else None
    out = {}
    for _ in range(2):
        grads, terms = grad_fn(*batch)
        if not out:
            out["terms"] = {k: float(v) for k, v in terms.items()}
            out.update({f"grad/{n}": g.numpy() for n, g in zip(names, grads)})
        state.optimizer.step(grads, TT.global_norm(grads, params, mesh))
    out.update({f"step2/{n}": p.detach().numpy().copy()
                for n, p in zip(names, params)})
    return out


def _seeded(shape, seed):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape))


def tp_collectives(pctx) -> dict:
    """float64 checks of the tensor-parallel collectives on this rank: the
    channel gather followed by a replicated loss (its backward: this rank's
    slice) and ``enter`` followed by a loss split over the model group (its
    backward: the sum of the ranks' gradients); and a GroupNorm whose
    groups straddle the shards (float32) on this rank's channels."""
    from mrp_gnn_tpu_torch.parallel import tp
    from mrp_gnn_tpu_torch.train import AdamW, TrainState
    mesh, j = pctx.mesh, pctx.mesh.model_index
    x = _seeded((3, 8, 2, 2), 1)
    r = _seeded((3, 8, 2, 2), 2)
    n = 8 // mesh.model
    xj = x[:, j * n:(j + 1) * n].clone().requires_grad_()
    y = tp.gather(xj, mesh)
    (y * r).sum().backward()
    xe = x.clone().requires_grad_()
    (tp.enter(xe, mesh) * _seeded((3, 8, 2, 2), 10 + j)).sum().backward()
    res = {"gather/y": y.detach().numpy(), "gather/dx": xj.grad.numpy(),
           "enter/dx": xe.grad.numpy()}
    # GroupNorm whose groups straddle the shards (3 groups of 6 channels)
    gn, x, r = straddling_group_norm()
    pctx.shard_state(TrainState(gn, AdamW(gn.parameters(), lambda c: 0.0,
                                          1.0, 0.0)))
    n = 6 // mesh.model
    xj = x[:, j * n:(j + 1) * n].clone().requires_grad_()
    y = gn(xj, pctx.shard)
    (y * r).sum().backward()
    res.update({"gn/y": y.detach().numpy(), "gn/dx": xj.grad.numpy(),
                "gn/dw": gn.weight.grad.numpy(),
                "gn/db": gn.bias.grad.numpy()})
    return res


def straddling_group_norm() -> tuple:
    """A GroupNorm of 3 groups over 6 channels with seeded scale and bias,
    and a seeded input and loss weights [2, 6, 3, 3]."""
    from mrp_gnn_tpu_torch.models.encoder import GroupNorm
    gn = GroupNorm(3, 6)
    with torch.no_grad():
        gn.weight.copy_(1 + 0.1 * _seeded((6,), 70))
        gn.bias.copy_(_seeded((6,), 71))
    return (gn, _seeded((2, 6, 3, 3), 72).float(),
            _seeded((2, 6, 3, 3), 73).float())


def spatial_collectives(pctx) -> dict:
    """float64 checks of the spatial collectives on this rank's rows: the
    halo rows of a stride-1 and a stride-2 3x3 convolution, the group sum,
    GroupNorm's statistics (mean and variance of 3 groups) and the pooled
    mean, each followed by a loss of this rank's own, with the gradient of
    its rows."""
    from mrp_gnn_tpu_torch.parallel import spatial
    mesh, sh = pctx.mesh, pctx.shard
    x = _seeded((2, 3, 8, 4), 1)
    lo, hi = sh.rows(8)
    j = mesh.model_index
    res = {}
    for name, top, bottom in (("halo1", 1, 1), ("halo2", 0, 1)):
        xj = x[:, :, lo:hi].clone().requires_grad_()
        y = spatial.halo_rows(xj, mesh, top, bottom)
        (y * _seeded(y.shape, 20 + j)).sum().backward()
        res[f"{name}/y"] = y.detach().numpy()
        res[f"{name}/dx"] = xj.grad.numpy()
    xj = x[:, :, lo:hi].clone().requires_grad_()
    s = spatial.model_sum(xj.sum(dim=(2, 3)), mesh)
    (s * _seeded(s.shape, 30 + j)).sum().backward()
    res["sum/y"], res["sum/dx"] = s.detach().numpy(), xj.grad.numpy()
    xj = x[:, :, lo:hi].clone().requires_grad_()
    mean, var = spatial.group_stats(xj.reshape(2, 3, -1), mesh)
    ((mean * _seeded(mean.shape, 50 + j)).sum()
     + (var * _seeded(var.shape, 60 + j)).sum()).backward()
    res["stats/y"] = torch.stack([mean, var]).detach().numpy()
    res["stats/dx"] = xj.grad.numpy()
    xj = x[:, :, lo:hi].clone().requires_grad_()
    p = sh.mean_hw(xj)
    (p * _seeded(p.shape, 40 + j)).sum().backward()
    res["mean/y"], res["mean/dx"] = p.detach().numpy(), xj.grad.numpy()
    return res


def fusion_setup(heads: int) -> tuple:
    """A fusion layer (C 16, attention, ``heads`` heads, dk 4, 4 groups) with
    seeded weights, a graph of 2 x 3 fully connected views, and the seeded
    input and loss weights [6, 16, 4, 4]."""
    from mrp_gnn_tpu_torch.graph import batch_fully_connected
    from mrp_gnn_tpu_torch.models.fusion import GraphFusionLayer
    layer = GraphFusionLayer(16, "attention", attention_dim=4,
                             attention_heads=heads, norm_groups=4)
    gen = torch.Generator().manual_seed(5)
    for mod in layer.modules():
        if mod is not layer and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return (layer, batch_fully_connected(2, 3),
            _seeded((6, 16, 4, 4), 50).float(),
            _seeded((6, 16, 4, 4), 51).float())


def unsharded_fusion(heads: int) -> dict:
    """:func:`fusion_setup`'s layer on one process: its output, the input's
    gradient and the parameters' for the seeded loss."""
    layer, g, x, r = fusion_setup(heads)
    x = x.clone().requires_grad_()
    y = layer(x, g, ops_impl="xla")
    (y * r).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "d": {n: p.grad.numpy() for n, p in layer.named_parameters()}}


def fusion_layer_case(pctx, heads: int) -> dict:
    """:func:`fusion_setup`'s layer (plain ops) with the shard context: its
    output, and the gradients of this rank's input and parameters for the
    seeded loss (this rank's rows under spatial sharding)."""
    from mrp_gnn_tpu_torch.train import AdamW, TrainState
    layer, g, x, r = fusion_setup(heads)
    pctx.shard_state(TrainState(layer, AdamW(layer.parameters(),
                                             lambda c: 0.0, 1.0, 0.0)))
    if pctx.spatial:
        lo, hi = pctx.shard.rows(4)
        x, r = x[:, :, lo:hi], r[:, :, lo:hi]
    x = x.clone().requires_grad_()
    y = layer(x, g, ops_impl="xla", shard=pctx.shard)
    (y * r).sum().backward()
    out = {f"fusion{heads}/y": y.detach().numpy(),
           f"fusion{heads}/dx": x.grad.numpy()}
    for n, p in layer.named_parameters():
        out[f"fusion{heads}/d/{n}"] = p.grad.numpy()
    return out


def model_axis_job(where: str, rank: int) -> tuple:
    """``<dir>/model_axis.json``'s run on this rank, its mesh with a model
    axis: the collective checks, the fusion layer with one and two heads,
    the first step's terms and gradients from the step-0 checkpoint in
    ``<dir>/ck`` (local shards), the straight ``train.train`` (checkpoints
    every 2 steps), a resume from its step-2 checkpoint, ``evaluate`` of the
    straight run's model, the local shapes of the parameters, a digest of
    the replicated ones, and with "bench" the scaling and overlap records.
    Rank 0 also saves the final parameters whole."""
    import shutil
    from torch_small import small
    from mrp_gnn_tpu_torch import train as TT
    from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
    from mrp_gnn_tpu_torch.config import get_config
    from mrp_gnn_tpu_torch.evaluate import evaluate
    from mrp_gnn_tpu_torch.parallel.tp import is_sharded
    with open(os.path.join(where, "model_axis.json")) as f:
        job = json.load(f)
    cfg = job_config(job, where, get_config, small)
    ck = cfg.train.checkpoint_dir
    pctx = TT.make_parallel(cfg, "cpu")
    arrays = (spatial_collectives(pctx) if pctx.spatial
              else tp_collectives(pctx))
    for heads in (1, 2):
        arrays.update(fusion_layer_case(pctx, heads))
    strip = ("wall_s", "step_time_s", "views_per_s", "edges_per_s")

    def terms(records):
        return [{k: v for k, v in r.items() if k not in strip}
                for r in records if "total" in r]

    state = TT.create_train_state(cfg, "cpu", pctx.edge_fusion_fn)
    CheckpointManager(ck).restore_latest(state)
    pctx.shard_state(state)
    batch = first_batch(cfg, pctx)
    arrays.update(first_updates(cfg, state, batch, pctx))
    first = arrays.pop("terms")
    out = {"first": first,
           "batch_shapes": [list(t.shape) for t in batch[:3]],
           "shapes": {n: list(p.shape) for n, p in
                      state.model.named_parameters()},
           "sharded": [n for n, p in state.model.named_parameters()
                       if is_sharded(p)]}
    state, records = TT.train(cfg, device="cpu")
    out["straight"] = terms(records)
    whole = pctx.full_tensors(state)
    out["replicated_digest"] = param_digest_of(
        {n: p for n, p in state.model.named_parameters()
         if not is_sharded(p)})
    if rank == 0:
        torch.save(whole[0] if whole else state.model.state_dict(),
                   os.path.join(where, "final.pt"))
        os.makedirs(os.path.join(where, "resume"))
        shutil.copy(os.path.join(ck, "ckpt_2.pt"),
                    os.path.join(where, "resume"))
    dist.barrier()
    import dataclasses
    resumed = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(where, "resume")))
    _, records = TT.train(resumed, device="cpu")
    out["resumed"] = terms(records)
    out["eval"] = evaluate(cfg, state.model, pctx=pctx)
    if job.get("bench"):
        from mrp_gnn_tpu_torch import benchmark as TB
        out["scaling"] = TB.bench_scaling(robots=4, scenes_per_shard=2,
                                          feature_dim=16, inner=2,
                                          device="cpu")
        out["overlap"] = TB.bench_overlap(feature_dim=16, inner=2,
                                          device="cpu")
    return out, arrays


def param_digest_of(params: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(params.items()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main():
    rank, world, store, where = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    if os.path.exists(os.path.join(where, "train.json")):
        res = train_job(where, rank)
        with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    elif os.path.exists(os.path.join(where, "model_axis.json")):
        res, arrays = model_axis_job(where, rank)
        with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        np.savez(os.path.join(where, f"rank{rank}.npz"), **arrays)
    else:
        with open(os.path.join(where, "cases.json")) as f:
            cases = json.load(f)
        inputs = np.load(os.path.join(where, "inputs.npz"))
        res = {}
        for case in cases:
            res.update(run_case(case, inputs, rank))
        res.update(run_losses(inputs, rank, world))
        np.savez(os.path.join(where, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
