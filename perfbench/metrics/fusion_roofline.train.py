"""The fusion layer's least time, forward and backward (the
``fusion_work`` of the configuration's reference, at
``work.least_seconds``), over its device time (CUDA events at
``GraphFusionLayer``'s forward and backward boundaries), summed over the
window's steps. Layer: fusion + kernels. Moves ``train_views_per_s``."""

from perfbench import cells, work

UNIT = "%"


def read(rec: dict):
    if rec["mode"] != "train":
        return None
    fwd = rec["device_ms"].get("fusion", [])
    bwd = rec["device_ms"].get("fusion_backward", [])
    if not fwd or len(fwd) != len(bwd) or len(fwd) != len(rec["edges"]):
        return None
    ref = cells.reference(rec)
    least = sum(work.least_seconds(*ref.fusion_work(
        rec["model"], rec["num_nodes"], e, backward=True))
        for e in rec["edges"])
    return work.share_pct(least, (sum(fwd) + sum(bwd)) / 1e3)
