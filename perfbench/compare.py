"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first three steps against the reference's, from
the same weights on the same batches):

- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap``: the first step's gradient, as the optimizer got it (the
  program's first moment after one step over 1 - b1), by the worst leaf:
  the gap between the program's norm of the leaf and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
- ``update_gap``: the parameters' change over the three steps, by the
  worst leaf as above, over the leaves that the reference's first
  gradient moves: a leaf whose reference gradient norm is under a
  thousandth of the median leaf's (the key's bias, under the softmax) is
  moved by round-off alone and is left out.

Serving (a sample of the window's requests against the reference's
forward on the same images and positions, real robots only):

- ``depth_err_m``: the largest absolute depth error, in metres;
- ``seg_gap``: the widest gap by which the reference's logit of a served
  label lies below the reference's best logit at that pixel (0 where the
  labels agree; a near-tie that rounding flips reads its small gap);
- ``missing``: sampled requests that never returned an answer.
"""

from __future__ import annotations

import math
import statistics

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# is moved by round-off alone
STILL_LEAF_SHARE = 1e-3


def _worst_leaf(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    pn = {k: float(torch.linalg.vector_norm(prog[k].detach().float()))
          for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keys}
    med = statistics.median(rn.values())
    return _worst(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def _worst(values) -> float:
    """The largest value; infinite when any is NaN (Python's max would
    skip one past the first)."""
    out = 0.0
    for v in values:
        if math.isnan(v):
            return math.inf
        out = max(out, v)
    return out


def moved_leaves(ref_grads: dict) -> list:
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= STILL_LEAF_SHARE * med]


def train_readings(prog: dict, ref: dict, params0: dict) -> dict:
    """``prog``/``ref``: {"losses": [terms per step], "grads": {leaf:
    first clipped gradient}, "params": {leaf: after the steps}}."""
    loss = _worst(abs(p["total"] - r["total"]) / max(abs(r["total"]), 1e-30)
                  for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(p["total"]) for p in prog["losses"]):
        loss = math.inf
    grad = _worst_leaf(prog["grads"], ref["grads"], ref["grads"])
    dp = {k: prog["params"][k] - params0[k] for k in params0}
    dr = {k: ref["params"][k] - params0[k] for k in params0}
    update = _worst_leaf(dp, dr, moved_leaves(ref["grads"]))
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def serve_readings(pairs, expected: int) -> dict:
    """``pairs``: (served {"depth", "seg"}, reference {"depth",
    "seg_logits"}, node_mask) of each sampled request that answered."""
    depth, gap = 0.0, 0.0
    for served, ref, mask in pairs:
        d = torch.as_tensor(served["depth"]).to(ref["depth"].device)[mask]
        depth = _worst([depth, float((d - ref["depth"][mask]).abs().max())])
        logits = ref["seg_logits"][mask]
        labels = torch.as_tensor(served["seg"]).to(logits.device)[mask].long()
        best = logits.max(dim=-1).values
        got = torch.gather(logits, -1, labels.clamp(0, logits.shape[-1] - 1)
                           [..., None])[..., 0]
        g = best - got
        g[(labels < 0) | (labels >= logits.shape[-1])] = math.inf
        gap = _worst([gap, float(g.max())])
    return {"depth_err_m": depth, "seg_gap": gap,
            "missing": float(expected - len(pairs))}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every reading finite and at
    or under its limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks
