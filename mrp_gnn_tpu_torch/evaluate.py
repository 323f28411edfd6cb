"""Evaluation: checkpoint load -> forward -> depth / seg metrics (port of
``mrp_gnn_tpu/evaluate.py``).

Depth RMSE / AbsRel / delta accuracies and seg mIoU over the eval split,
the JAX package's output keys. The model runs in eval mode under
``torch.inference_mode()`` on its own device with the config's
``ops_impl``, so on the CUDA card the fusion layer runs the kernels. The
metric sums stay on the device and are read back once, at the end.

With a ``ParallelContext`` (``pctx``; every rank calls ``evaluate``) each
rank renders and evaluates its own node rows through the partitioned
fusion, with the model axis's shard context (the model holds this rank's
shards under tensor parallelism; under spatial sharding each rank of a
node block keeps its image rows), the metric sums are summed over the
batch group in one all-reduce, and every rank returns the same metrics.

CLI: python -m mrp_gnn_tpu_torch.evaluate --config dynamic_swarm \\
        --checkpoint_dir /tmp/ckpt [--device cpu]
     (the train CLI's --coordinator / --num_processes / --process_id /
     --dist_backend run it over a mesh, one process per rank; rank 0
     prints)
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from mrp_gnn_tpu_torch import metrics as M
from mrp_gnn_tpu_torch.config import ExperimentConfig, get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.models.fusion import GraphFusionLayer
from mrp_gnn_tpu_torch.train import (add_multihost_args, batch_to_device,
                                     create_train_state, init_multihost,
                                     make_parallel)
from mrp_gnn_tpu_torch.utils.platform import resolve_device


def evaluate(cfg: ExperimentConfig, model: torch.nn.Module, pctx=None,
             dump_dir: str | None = None) -> dict:
    """Run the eval split (in order; the final partial batch padded and
    masked); returns a flat dict of float metrics.

    pctx: a ``parallel.context.ParallelContext``: the model's fusion layers
    run its partitioned fusion for the call, on this rank's node rows, the
    model runs with ``pctx.shard`` (``model`` holds this rank's shards under
    tensor parallelism: ``pctx.shard_state``), and the sums are global.
    dump_dir: write qualitative prediction panels (utils/viz.py) for the
    first eval batch (not under a pctx: no rank holds a whole batch).
    """
    device = next(model.parameters()).device
    ops_impl = cfg.parallel.ops_impl
    num_classes = cfg.model.num_seg_classes
    was_training = model.training
    model.eval()
    acc = None
    n_batches = 0
    node_range, swapped, shard = None, [], None
    if pctx is not None:
        shard = pctx.shard
        d = cfg.data
        node_range = pctx.local_node_range(
            d.max_nodes or d.scenes_per_batch * d.num_robots)
        swapped = [(m, m.edge_fusion_fn) for m in model.modules()
                   if isinstance(m, GraphFusionLayer)]
        for m, _ in swapped:
            m.edge_fusion_fn = pctx.edge_fusion_fn
    try:
        with torch.inference_mode():
            for batch in make_dataset(cfg.data, "eval", shuffle=False,
                                      node_range=node_range):
                images, depth, seg, graph = (
                    pctx.shard_batch(batch) if pctx is not None
                    else batch_to_device(batch, device))
                out = model(images, graph, ops_impl=ops_impl, shard=shard)
                res = {}
                if "depth" in out:
                    res["depth"] = M.depth_metrics_accumulate(
                        out["depth"], depth, graph.node_mask)
                if "seg_logits" in out:
                    res["conf"] = M.seg_confusion_accumulate(
                        out["seg_logits"], seg, graph.node_mask, num_classes)
                acc = res if acc is None else M.tree_add(acc, res)
                if dump_dir and n_batches == 0 and pctx is None:
                    from mrp_gnn_tpu_torch.utils.viz import save_panels
                    save_panels(dump_dir, batch["images"],
                                {k: out[k].cpu().numpy() for k in
                                 ("depth", "seg_logits") if k in out},
                                {"depth": batch["depth"], "seg": batch["seg"]},
                                batch["graph"].node_mask.numpy(),
                                cfg.model.min_depth, cfg.model.max_depth)
                n_batches += 1
    finally:
        model.train(was_training)
        for m, fn in swapped:
            m.edge_fusion_fn = fn
    if acc is None:
        raise ValueError("eval split produced no batches")
    if pctx is not None:
        leaves = []
        M.tree_map(leaves.append, acc)
        summed = iter(pctx.mesh.sum_all(leaves))
        acc = M.tree_map(lambda _: next(summed), acc)

    metrics = {}
    if "depth" in acc:
        metrics.update(M.depth_metrics_finalize(acc["depth"]))
    if "conf" in acc:
        metrics["miou"] = M.seg_miou(acc["conf"])
        metrics["iou_per_class"] = M.seg_per_class_iou(acc["conf"])
    # the one read-back: every metric in one float32 tensor
    host = torch.cat([v.to(torch.float32).reshape(-1)
                      for v in metrics.values()]).tolist()
    out = {"eval_batches": n_batches}
    for k, v in metrics.items():
        n = v.numel()
        out[k] = ([round(x, 5) for x in host[:n]] if k == "iou_per_class"
                  else host[0])
        host = host[n:]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--dataset_root", default=None,
                   help="evaluate on on-disk scene folders (data/disk.py)")
    p.add_argument("--dump_dir", default=None,
                   help="write qualitative prediction panels (PNG) here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; under a mesh "
                        "the card of the rank's local rank)")
    add_multihost_args(p)
    args = p.parse_args(argv)
    init_multihost(args)

    cfg = get_config(args.config)
    if args.dataset_root is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, dataset_root=args.dataset_root))
    pctx = make_parallel(cfg, args.device)
    device = pctx.device if pctx is not None else resolve_device(args.device)
    lead = pctx is None or pctx.mesh.rank == 0
    state = create_train_state(cfg, device)
    if args.checkpoint_dir:
        from mrp_gnn_tpu_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir)
        if mgr.restore_latest(state) is None:
            raise FileNotFoundError(f"no checkpoint in {args.checkpoint_dir}")
        if lead:
            print(f"[eval] restored step {mgr.latest_step}")
    if pctx is not None:
        pctx.shard_state(state)
    results = evaluate(cfg, state.model, pctx=pctx, dump_dir=args.dump_dir)
    if lead:
        if args.dump_dir and pctx is None:
            print(f"[eval] qualitative panels -> {args.dump_dir}")
        print(json.dumps(results))
    if args.coordinator is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
