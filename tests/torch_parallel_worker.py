"""One rank of the port's partitioned fusion over gloo, for
``tests/test_torch_parallel.py`` (imports torch and the port, never JAX).

    python tests/torch_parallel_worker.py <rank> <world> <store> <dir>

With ``<dir>/train.json`` the rank runs :func:`train_job` and writes
``<dir>/rank<r>.json``. Otherwise ``<dir>/cases.json`` lists the cases, ``<dir>/inputs.npz`` holds each
case's global q, k and v (``<case>/q`` ...). For each case the rank builds
the case's mesh and plan, runs the partitioned fusion on its node rows,
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
    """The train job's config: ``small`` of the preset with the job's data
    and parallel overrides, checkpoints under ``<where>/ck``."""
    import dataclasses
    cfg = small(get_config(job["config"]), impl=job.get("impl", "pallas"),
                data=job.get("data"), log_every=1, checkpoint_every=2,
                checkpoint_dir=os.path.join(where, "ck"))
    return cfg.replace(
        train=dataclasses.replace(cfg.train, steps=job["steps"]),
        parallel=dataclasses.replace(cfg.parallel, **job["parallel"]))


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
